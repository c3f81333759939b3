"""IR-SE ArcFace backbone, GPEN's identity-loss network (reference:
third_part/GPEN/training/loss/model_irse.py:10-49 + helpers.py:56-120,
loaded from model_ir_se50.pth by id_loss.py:6-16; s2v_tpu/models/irse.py),
NCHW.

Bottleneck IR(-SE) units over a 112x112 face, a BatchNorm stem and head,
an L2-normalised 512-d embedding. Used frozen, in eval mode (running
statistics, dropout off), as the reference uses it. Key names are
model_ir_se50.pth's (``input_layer.N``, ``body.N.res_layer.N``,
``body.N.shortcut_layer.N``, ``output_layer.N``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _blocks(num_layers: int):
    """helpers.py get_blocks: (in, depth, stride) of every unit."""
    units = {50: (3, 4, 14, 3), 100: (3, 13, 30, 3), 152: (3, 8, 36, 3)}
    if num_layers not in units:
        raise ValueError(f"num_layers must be 50/100/152, got {num_layers}")
    specs, cin = [], 64
    for depth, n in zip((64, 128, 256, 512), units[num_layers]):
        specs.append((cin, depth, 2))
        specs.extend((depth, depth, 1) for _ in range(n - 1))
        cin = depth
    return specs


class SEModule(nn.Module):
    """helpers.py:56-73: squeeze-excite, reduction 16, bias-free 1x1 convs."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class BottleneckIR(nn.Module):
    """helpers.py bottleneck_IR / bottleneck_IR_SE (:76-120)."""

    def __init__(self, cin: int, depth: int, stride: int, se: bool = True):
        super().__init__()
        if cin == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(nn.Conv2d(cin, depth, 1, stride, bias=False),
                                                nn.BatchNorm2d(depth))
        layers = [nn.BatchNorm2d(cin), nn.Conv2d(cin, depth, 3, 1, 1, bias=False),
                  nn.PReLU(depth), nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
                  nn.BatchNorm2d(depth)]
        if se:
            layers.append(SEModule(depth))
        self.res_layer = nn.Sequential(*layers)

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


class BackboneIRSE(nn.Module):
    """model_irse.py Backbone (input_size 112): ``mode="ir_se"`` is
    model_ir_se50.pth's configuration, ``"ir"`` drops the SE branches.
    [B, 3, 112, 112] -> [B, 512], unit norm."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se"):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"mode must be 'ir' or 'ir_se', got {mode!r}")
        self.input_layer = nn.Sequential(nn.Conv2d(3, 64, 3, 1, 1, bias=False),
                                         nn.BatchNorm2d(64), nn.PReLU(64))
        self.body = nn.Sequential(*[BottleneckIR(cin, depth, stride, se=mode == "ir_se")
                                    for cin, depth, stride in _blocks(num_layers)])
        self.output_layer = nn.Sequential(nn.BatchNorm2d(512), nn.Dropout(), nn.Flatten(),
                                          nn.Linear(512 * 7 * 7, 512), nn.BatchNorm1d(512))

    def forward(self, x):
        if x.shape[1:] != (3, 112, 112):
            raise ValueError(f"BackboneIRSE expects [B, 3, 112, 112], got {tuple(x.shape)}")
        h = self.output_layer(self.body(self.input_layer(x)))
        return h / h.norm(dim=1, keepdim=True)


def id_loss_feats(model: BackboneIRSE, images: torch.Tensor) -> torch.Tensor:
    """IDLoss.extract_feats (id_loss.py:18-25): crop the face region of a
    square image whose side is a multiple of 256, average-pool it to 112^2
    adaptively, embed."""
    h, w = images.shape[-2:]
    s = h // 256
    x = images[:, :, 35 * s:h - 33 * s, 32 * s:w - 36 * s]
    return model(F.adaptive_avg_pool2d(x, 112))


def id_loss(model: BackboneIRSE, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """id_loss.py:27-49: mean(1 - <emb(y_hat), emb(y)>), y without gradient."""
    with torch.no_grad():
        f = id_loss_feats(model, y)
    return (1.0 - (id_loss_feats(model, y_hat) * f).sum(1)).mean()
