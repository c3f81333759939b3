"""torchvision-convention ResNet with Bottleneck blocks and the
Deep3DFaceRecon coefficient regressor and FAN's depth regressor on it
(reference: third_part/face3d/models/networks.py:69-104, 160-440;
third_part/face_detection/models.py:204-262), NCHW.

Module names follow torchvision (``layer{n}.{b}``, ``downsample.0/1``) and
networks.py (``backbone``, ``final_layers``), so the ``net_recon`` entry of
``face3d_pretrain_epoch_20.pth`` loads as it is, and so does the ``body.*``
part of ``RetinaFace-R50.pth`` (``return_stages``) and FAN's ``depth.pth``
(``ResNetDepth``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# ReconNet's heads: id | exp | tex | angle | gamma | tx, ty | tz
RECON_DIMS = (80, 64, 80, 3, 27, 2, 1)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False),
                                         nn.BatchNorm2d(out)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet (V1.5: the stride on the 3x3 conv) without its fc;
    ``layers=(3, 4, 6, 3)`` is ResNet50. Returns the average-pooled features
    [B, 32 * base_planes, 1, 1] or, with ``return_stages``, the list of every
    stage's output (layer1..layer4: the maps RetinaFace's FPN taps)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), base_planes: int = 64,
                 return_stages: bool = False, in_channels: int = 3):
        super().__init__()
        self.return_stages = return_stages
        self.conv1 = nn.Conv2d(in_channels, base_planes, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(base_planes)
        self.maxpool = nn.MaxPool2d(3, 2, 1)  # pads with -inf
        inplanes, planes = base_planes, base_planes
        self.n_stages = len(layers)
        for stage, n_blocks in enumerate(layers):
            blocks = []
            for b in range(n_blocks):
                s = (1 if stage == 0 else 2) if b == 0 else 1
                blocks.append(Bottleneck(inplanes, planes, s, downsample=b == 0 and (
                    s != 1 or inplanes != planes * Bottleneck.expansion)))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.out_channels = inplanes

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        stages = []
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            stages.append(x)
        if self.return_stages:
            return stages
        return x.mean(dim=(2, 3), keepdim=True)  # AdaptiveAvgPool2d(1)


class ReconNet(nn.Module):
    """Deep3DFaceRecon regressor: ResNet -> seven 1x1 heads -> [B, 257]
    coefficients in the order of ``RECON_DIMS``. Input [B, 3, 224, 224] RGB
    in [0, 1]. ``layers`` / ``base_planes`` size the backbone (production:
    ResNet50)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), base_planes: int = 64):
        super().__init__()
        self.backbone = ResNet(layers, base_planes)
        self.final_layers = nn.ModuleList(
            [nn.Conv2d(self.backbone.out_channels, d, 1) for d in RECON_DIMS])

    def forward(self, x):
        feat = self.backbone(x)
        return torch.cat([head(feat) for head in self.final_layers], 1).flatten(1)


class ResNetDepth(ResNet):
    """FAN's 3D-landmark depth regressor (face_detection/models.py:204-262):
    a bottleneck ResNet-152 ([3, 8, 36, 3]) over a 71-channel input (RGB and
    the 68 landmark heatmaps), a fixed ``AvgPool2d(7)`` (not adaptive: on a
    256^2 input the last 8^2 map is pooled over its top-left 7x7 window)
    and a 68-wide ``fc``. Keys as the reference's (``conv1``, ``layer*``,
    ``fc``)."""

    def __init__(self, num_classes: int = 68):
        super().__init__((3, 8, 36, 3), return_stages=True, in_channels=3 + 68)
        self.fc = nn.Linear(self.out_channels, num_classes)

    def forward(self, x):
        feat = F.avg_pool2d(super().forward(x)[-1], 7)
        return self.fc(feat.flatten(1))


def recon_arch(state_dict) -> ReconNet:
    """The ReconNet geometry of a checkpoint's state_dict (s2v_tpu's
    ``LipSyncPipeline._recon_arch``): blocks per stage and the stem width.
    Reference checkpoints are ResNet50 (networks.py:69-104). Without the
    backbone's keys, ResNet50, whose strict load then names them."""
    try:
        base = int(state_dict["backbone.conv1.weight"].shape[0])
    except KeyError:
        return ReconNet()
    counts = tuple(len({k.split(".")[2] for k in state_dict
                        if k.startswith(f"backbone.layer{i}.")}) for i in range(1, 5))
    return ReconNet(layers=counts, base_planes=base) if all(counts) else ReconNet()
