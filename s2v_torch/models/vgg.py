"""VGG16 features and the perceptual loss (reference: training.py:94-134
VGGPerceptualLoss over torchvision's vgg16 ``features`` slices [:4],
[4:9], [9:16], [16:23]; s2v_tpu/models/vgg.py), NCHW.

``features`` keeps torchvision's layer indices, so a torchvision
``vgg16-397923af.pth`` loads through ``vgg16_features``: layers 0-22
(conv4_3 and its ReLU), the convs at 0-21 loaded strictly, the deeper convs
and the classifier ignored. As in the reference, inputs are resized to 224
bilinearly and not normalised. LPIPS is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from s2v_torch.ops.image import resize_bilinear

# torchvision vgg16 features: conv widths and "M" max pools, in order
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# the reference's block boundaries (layer indices in ``features``)
BLOCK_ENDS = (4, 9, 16, 23)


class VGG16Features(nn.Module):
    """Returns the activations at ``BLOCK_ENDS`` (after the ReLU before each
    of the first four max pools)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers[:BLOCK_ENDS[-1]])

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i + 1 in BLOCK_ENDS:
                outs.append(x)
        return outs


def vgg16_features(state_dict: Dict[str, torch.Tensor]) -> VGG16Features:
    """A ``VGG16Features`` loaded from a torchvision vgg16 state_dict
    (``features.N.weight/bias``): every key the module has must be there
    with its shape, or this raises; ``classifier.*`` and the convs past
    layer 21 are not used. (s2v_tpu's ``convert_vgg16_features`` stops
    quietly at the first missing conv, so a truncated file gives it fewer
    blocks.)"""
    model = VGG16Features()
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
