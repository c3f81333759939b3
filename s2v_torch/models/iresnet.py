"""IResNet and MobileFaceNet, the arcface face-recognition backbones
(reference: third_part/face3d/models/arcface_torch/backbones/iresnet.py and
mobilefacenet.py; s2v_tpu/models/iresnet.py), NCHW, with arcface_torch's
state_dict key names.

IResNet: pre-activation basic blocks with PReLU; a 112x112 face -> BN ->
flatten -> fc -> the feature BatchNorm1d -> a ``num_features`` embedding.
As the JAX package trains it, the feature BN's weight is a trainable
parameter (arcface_torch freezes it at 1.0).

Batch statistics: in training mode every BatchNorm normalises with the
statistics of the batch it is given. ``forward(x, group=...)`` makes them
the statistics of the whole batch split over a process group's ranks, as
the JAX program's global view computes them: the sums are all-reduced with
autograd (``torch.distributed.nn.functional.all_reduce``, a mean pass then
a centred pass), and the running variance takes the ``n / (n - 1)``
correction with the global ``n``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, group=None,
               train=None) -> torch.Tensor:
    """``bn`` on ``x`` [N, C, ...] (``train`` defaults to ``bn.training``).
    In training with a ``group``, the mean and the biased variance are
    those of the batch over every rank of the group, and the running
    statistics move with them."""
    train = bn.training if train is None else train
    if not train or group is None:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            train, bn.momentum, bn.eps)
    from torch.distributed.nn.functional import all_reduce

    dims = [0] + list(range(2, x.dim()))
    n = x.numel() // x.shape[1] * dist.get_world_size(group)
    mean = all_reduce(x.sum(dims), group=group) / n
    shape = [1, -1] + [1] * (x.dim() - 2)
    xc = x - mean.view(shape)
    var = all_reduce(xc.square().sum(dims), group=group) / n
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var * n / max(n - 1, 1))
    return xc * torch.rsqrt(var + bn.eps).view(shape) * bn.weight.view(shape) \
        + bn.bias.view(shape)


class IBasicBlock(nn.Module):
    """iresnet.py IBasicBlock: BN -> conv3x3 -> BN -> PReLU -> conv3x3
    (stride) -> BN, plus the identity or a 1x1 conv + BN downsample."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes, eps=1e-5)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.prelu = nn.PReLU(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                         nn.BatchNorm2d(planes, eps=1e-5))
                           if downsample else None)

    def forward(self, x, group=None):
        out = self.conv1(batch_norm(self.bn1, x, group))
        out = self.prelu(batch_norm(self.bn2, out, group))
        out = batch_norm(self.bn3, self.conv2(out), group)
        if self.downsample is not None:
            x = batch_norm(self.downsample[1], self.downsample[0](x), group)
        return out + x


class IResNet(nn.Module):
    """layers (3, 4, 14, 3) is iresnet50, (2, 2, 2, 2) iresnet18.
    [B, 3, 112, 112] -> [B, num_features]."""

    fc_scale = 7 * 7

    def __init__(self, layers: Sequence[int] = (3, 4, 14, 3), num_features: int = 512):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.prelu = nn.PReLU(64)
        inplanes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = [IBasicBlock(inplanes, planes, 2, downsample=True)]
            blocks += [IBasicBlock(planes, planes) for _ in range(n - 1)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            inplanes = planes
        self.bn2 = nn.BatchNorm2d(512, eps=1e-5)
        self.fc = nn.Linear(512 * self.fc_scale, num_features)
        self.features = nn.BatchNorm1d(num_features, eps=1e-5)
        nn.init.constant_(self.features.weight, 1.0)

    def forward(self, x, group=None):
        if x.shape[1:] != (3, 112, 112):
            raise ValueError(f"IResNet expects [B, 3, 112, 112], got {tuple(x.shape)}")
        x = self.prelu(batch_norm(self.bn1, self.conv1(x), group))
        for stage in range(1, 5):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, group)
        x = batch_norm(self.bn2, x, group)
        return batch_norm(self.features, self.fc(x.flatten(1)), group)


# ---------------------------------------------------------------------------
# MobileFaceNet (arcface_torch/backbones/mobilefacenet.py:16-120, scale 2)
# ---------------------------------------------------------------------------


class _Layers(nn.Module):
    """A module whose ``layers`` Sequential holds its parts (the reference's
    ConvBlock, LinearBlock, DepthWise and Residual all do)."""

    def forward(self, x, group=None):
        for layer in self.layers:
            x = (batch_norm(layer, x, group) if isinstance(layer, nn.BatchNorm2d)
                 else layer(x, group) if isinstance(layer, _Layers) else layer(x))
        return x


class ConvBlock(_Layers):
    """conv (no bias) + BN + PReLU."""

    def __init__(self, cin, cout, kernel=1, stride=1, padding=0, groups=1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=False),
            nn.BatchNorm2d(cout), nn.PReLU(cout))


class LinearBlock(_Layers):
    """conv (no bias) + BN."""

    def __init__(self, cin, cout, kernel=1, stride=1, padding=0, groups=1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(cin, cout, kernel, stride, padding, groups=groups, bias=False),
            nn.BatchNorm2d(cout))


class DepthWise(_Layers):
    """1x1 expand to ``groups`` -> depthwise 3x3 (stride) -> 1x1 project,
    with the input added when ``residual``."""

    def __init__(self, cin, cout, residual=False, stride=2, groups=1):
        super().__init__()
        self.residual = residual
        self.layers = nn.Sequential(ConvBlock(cin, groups),
                                    ConvBlock(groups, groups, 3, stride, 1, groups=groups),
                                    LinearBlock(groups, cout))

    def forward(self, x, group=None):
        out = super().forward(x, group)
        return x + out if self.residual else out


class Residual(_Layers):
    def __init__(self, c, num_block, groups):
        super().__init__()
        self.layers = nn.Sequential(*[DepthWise(c, c, True, 1, groups)
                                      for _ in range(num_block)])


class MobileFaceNet(nn.Module):
    """mobilefacenet.py:90-120 (blocks (1, 4, 6, 2), scale 2): a 112x112 face
    -> ``num_features``. The GDC head's BatchNorm1d uses its running
    statistics in training too, as the JAX package's head does."""

    def __init__(self, num_features: int = 512):
        super().__init__()
        self.layers = nn.ModuleList([
            ConvBlock(3, 128, 3, 2, 1), ConvBlock(128, 128, 3, 1, 1, groups=64),
            DepthWise(128, 128, groups=128), Residual(128, 4, 128),
            DepthWise(128, 256, groups=256), Residual(256, 6, 256),
            DepthWise(256, 256, groups=512), Residual(256, 2, 256)])
        self.conv_sep = ConvBlock(256, 512)
        self.features = nn.Module()
        self.features.layers = nn.Sequential(LinearBlock(512, 512, 7, 1, 0, groups=512),
                                             nn.Flatten(), nn.Linear(512, num_features,
                                                                     bias=False),
                                             nn.BatchNorm1d(num_features))

    def forward(self, x, group=None):
        for layer in self.layers:
            x = layer(x, group)
        x = self.conv_sep(x, group)
        gdc, _, linear, bn = self.features.layers
        x = linear(gdc(x, group).flatten(1))
        return batch_norm(bn, x, train=False)


# arcface backbones/__init__.py get_model (iresnet.py:164-186 layer
# configurations, iresnet2060.py:175, mobilefacenet get_mbf)
IRESNET_LAYERS = {
    "r18": (2, 2, 2, 2),
    "r34": (3, 4, 6, 3),
    "r50": (3, 4, 14, 3),
    "r100": (3, 13, 30, 3),
    "r200": (6, 26, 60, 6),
    "r2060": (3, 128, 1024 - 128, 3),
}


def get_model(name: str, num_features: int = 512) -> nn.Module:
    """backbones/__init__.py:5-25: the backbone of a config name."""
    if name in IRESNET_LAYERS:
        return IResNet(IRESNET_LAYERS[name], num_features)
    if name == "mbf":
        return MobileFaceNet(num_features)
    raise ValueError(f"unknown backbone {name!r}; options: {sorted(IRESNET_LAYERS) + ['mbf']}")
