"""VGG16 features and the perceptual loss (reference: the fork's
training.py:94-134 ``VGGPerceptualLoss`` over torchvision's vgg16
``features`` slices [:4], [4:9], [9:16], [16:23]), NCHW.

A copy of ``s2v_torch/models/vgg.py`` at commit 666f1ea (the parent of the
change that added it), frozen for the ``enet_finetune`` configuration:
``VGG16Features``, ``vgg16_features`` and ``vgg_perceptual_loss``, with
``s2v_torch`` imports made ``portbench.reference`` ones. Left out: LPIPS
(``lpips_distance``, ``lpips_lin``, ``LPIPS_ENDS``), which no cell runs.

``features`` keeps torchvision's layer indices, so a torchvision
``vgg16-397923af.pth`` loads through ``vgg16_features``: layers 0-22 (the
convs 0-21 and the ReLU after conv 21), loaded strictly, the deeper convs
and the classifier ignored. As in training.py, the loss resizes its inputs
to 224^2 bilinearly and does not normalise them. Departures from
training.py: none in the mathematics; its ``VGGPerceptualLoss`` also
registers ImageNet mean and std buffers that its ``forward`` never applies,
and they are not kept.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from portbench.reference.ops.image import resize_bilinear

# torchvision vgg16 features: conv widths and "M" max pools, in order
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# training.py's block boundaries (layer indices in ``features``)
BLOCK_ENDS = (4, 9, 16, 23)


class VGG16Features(nn.Module):
    """Returns the activations at ``block_ends`` (after the ReLU before each
    of the first four max pools). The module holds the layers up to the last
    of them."""

    def __init__(self, block_ends: Sequence[int] = BLOCK_ENDS):
        super().__init__()
        self.block_ends = tuple(block_ends)
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers[:self.block_ends[-1]])

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i + 1 in self.block_ends:
                outs.append(x)
        return outs


def vgg16_features(state_dict: Dict[str, torch.Tensor],
                   block_ends: Sequence[int] = BLOCK_ENDS) -> VGG16Features:
    """A ``VGG16Features(block_ends)`` loaded from a torchvision vgg16
    state_dict (``features.N.weight/bias``): every key the module has must
    be there with its shape, or this raises; ``classifier.*`` and the deeper
    convs are not used."""
    model = VGG16Features(block_ends)
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict]
    if missing:
        raise KeyError(f"the VGG16 state_dict lacks {missing}")
    model.load_state_dict({k: state_dict[k] for k in own})
    return model


def vgg_perceptual_loss(model: VGG16Features, pred: torch.Tensor, target: torch.Tensor,
                        feature_layers: Sequence[int] = (0, 1, 2, 3),
                        style_layers: Sequence[int] = (), resize: bool = True) -> torch.Tensor:
    """training.py:111-134. pred, target [B, 3, H, W] in [0, 1]: L1 between
    the blocks' activations, plus L1 between their Gram matrices for
    ``style_layers``."""
    if resize:
        pred = resize_bilinear(pred, (224, 224))
        target = resize_bilinear(target, (224, 224))
    loss = 0.0
    for i, (x, y) in enumerate(zip(model(pred), model(target))):
        if i in feature_layers:
            loss = loss + (x - y).abs().mean()
        if i in style_layers:
            ax, ay = x.flatten(2), y.flatten(2)  # [B, C, HW]
            loss = loss + (ax @ ax.transpose(1, 2) - ay @ ay.transpose(1, 2)).abs().mean()
    return loss
