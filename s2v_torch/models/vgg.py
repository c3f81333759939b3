"""VGG16 features, the perceptual loss and LPIPS (reference:
training.py:94-134 VGGPerceptualLoss over torchvision's vgg16 ``features``
slices [:4], [4:9], [9:16], [16:23]; GPEN's training/lpips, the validation
metric of its trainer; s2v_tpu/models/vgg.py), NCHW.

``features`` keeps torchvision's layer indices, so a torchvision
``vgg16-397923af.pth`` loads through ``vgg16_features``: up to the last
requested block (layers 0-22 for the perceptual loss, 0-29 for LPIPS), the
convs the module holds loaded strictly, the deeper convs and the classifier
ignored. As in the reference, the perceptual loss resizes its inputs to 224
bilinearly and does not normalise them; LPIPS shifts and scales them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.ops.image import resize_bilinear

# torchvision vgg16 features: conv widths and "M" max pools, in order
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# the reference's block boundaries (layer indices in ``features``)
BLOCK_ENDS = (4, 9, 16, 23)
# LPIPS taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
LPIPS_ENDS = (4, 9, 16, 23, 30)


class VGG16Features(nn.Module):
    """Returns the activations at ``block_ends`` (by default after the ReLU
    before each of the first four max pools; LPIPS takes a fifth, after
    conv5_3's ReLU). The module holds the layers up to the last of them."""

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
    be there with its shape, or this raises (the convs up to layer 21 for
    the perceptual loss, up to 28 for ``LPIPS_ENDS``); ``classifier.*`` and
    the deeper convs are not used. (s2v_tpu's ``convert_vgg16_features``
    stops quietly at the first missing conv, so a truncated file gives it
    fewer blocks.)"""
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


# LPIPS input scaling (lpips networks: shift/scale in [-1, 1] space)
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def lpips_distance(model: VGG16Features, lin: Sequence[torch.Tensor], a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """LPIPS-VGG distance [B] (s2v_tpu's ``lpips_distance``). ``model`` a
    ``VGG16Features(LPIPS_ENDS)``, ``lin`` the five non-negative [C_i]
    per-channel weights (``lpips_lin``), a, b [B, 3, H, W] in [-1, 1]: each
    tap's features unit-normalised over channels, their squared difference
    weighted per channel, summed over channels and averaged over space."""
    shift = torch.from_numpy(_LPIPS_SHIFT).to(a.device)[None, :, None, None]
    scale = torch.from_numpy(_LPIPS_SCALE).to(a.device)[None, :, None, None]
    total = 0.0
    for w, xa, xb in zip(lin, model((a - shift) / scale), model((b - shift) / scale)):
        na = xa * torch.rsqrt(xa.square().sum(1, keepdim=True) + 1e-10)
        nb = xb * torch.rsqrt(xb.square().sum(1, keepdim=True) + 1e-10)
        d2 = (na - nb).square() * w.to(xa)[None, :, None, None]
        total = total + d2.sum(1).mean((1, 2))
    return total


def lpips_lin(state_dict: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """An lpips checkpoint's five ``lin{i}.model.1.weight`` [1, C, 1, 1]
    heads as [C] vectors (the layout ``convert_lpips_lin`` reads)."""
    return [torch.as_tensor(state_dict[f"lin{i}.model.1.weight"]).float().reshape(-1)
            for i in range(5)]
