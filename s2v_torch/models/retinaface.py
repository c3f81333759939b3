"""RetinaFace, GPEN's face detector (reference:
third_part/GPEN/face_detect/facemodels/retinaface.py + net.py, the cfg_re50
and cfg_mnet configurations; the detection wrapper
retinaface_detection.py:19-120), NCHW.

ResNet50 layer2/3/4 (or MobileNetV1 x0.25's three stages) -> FPN -> SSH ->
per-level class/bbox/landmark heads with 2 anchors per position. Module
names are the reference's (``body``, ``fpn.output1.0``, ``ssh1.conv7x7_3``,
``ClassHead.0.conv1x1``, ...), so ``RetinaFace-R50.pth`` loads as it is.
The anchor decode runs over every anchor at once; the pipeline keeps the
best face per frame (``detect_faces``), so no NMS is needed.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from s2v_torch.models.resnet import ResNet
from s2v_torch.ops.image import resize_nearest

# cfg_re50 (face_detect/data/config.py:23-40); cfg_mnet shares them
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)
# BGR means subtracted before detection (retinaface_detection.py)
RETINA_MEAN = (104.0, 117.0, 123.0)


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1, leaky: float = 0.0,
            relu: bool = True) -> nn.Sequential:
    """net.py's conv_bn / conv_bn1X1 / conv_bn_no_relu: a bias-free conv,
    BN and LeakyReLU(``leaky``) (a plain ReLU at 0; none with ``relu=False``)."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False),
              nn.BatchNorm2d(cout)]
    if relu:
        layers.append(nn.LeakyReLU(leaky) if leaky else nn.ReLU())
    return nn.Sequential(*layers)


def conv_dw(cin: int, cout: int, stride: int) -> nn.Sequential:
    """net.py:29-38: depthwise 3x3 + BN + LeakyReLU(0.1), then pointwise
    1x1 + BN + LeakyReLU(0.1)."""
    return nn.Sequential(nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
                         nn.BatchNorm2d(cin), nn.LeakyReLU(0.1),
                         nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout),
                         nn.LeakyReLU(0.1))


class SSH(nn.Module):
    """net.py:40-66: 3x3, 5x5 and 7x7 receptive fields as chained 3x3s; the
    last conv of each branch has no activation, the concat is ReLU'd."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.conv3X3 = conv_bn(cin, cout // 2, relu=False)
        self.conv5X5_1 = conv_bn(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn(cout // 4, cout // 4, relu=False)
        self.conv7X7_2 = conv_bn(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn(cout // 4, cout // 4, relu=False)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return torch.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7], 1))


class FPN(nn.Module):
    """net.py:68-98: 1x1 lateral convs, nearest upsampling, 3x3 merges."""

    def __init__(self, in_channels: Sequence[int], cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.output1 = conv_bn(in_channels[0], cout, 1, leaky=leaky)
        self.output2 = conv_bn(in_channels[1], cout, 1, leaky=leaky)
        self.output3 = conv_bn(in_channels[2], cout, 1, leaky=leaky)
        self.merge1 = conv_bn(cout, cout, leaky=leaky)
        self.merge2 = conv_bn(cout, cout, leaky=leaky)

    def forward(self, feats):
        o1, o2, o3 = self.output1(feats[0]), self.output2(feats[1]), self.output3(feats[2])
        o2 = self.merge2(o2 + resize_nearest(o3, o2.shape[2:]))
        o1 = self.merge1(o1 + resize_nearest(o2, o1.shape[2:]))
        return [o1, o2, o3]


class MobileNetV1(nn.Module):
    """net.py:102-137, MobileNetV1 x0.25 (the cfg_mnet body) without its
    classifier: the three stage outputs, strides 8/16/32, 64/128/256
    channels."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(conv_bn(3, 8, 3, 2, leaky=0.1), conv_dw(8, 16, 1),
                                    conv_dw(16, 32, 2), conv_dw(32, 32, 1),
                                    conv_dw(32, 64, 2), conv_dw(64, 64, 1))
        self.stage2 = nn.Sequential(conv_dw(64, 128, 2),
                                    *[conv_dw(128, 128, 1) for _ in range(5)])
        self.stage3 = nn.Sequential(conv_dw(128, 256, 2), conv_dw(256, 256, 1))

    def forward(self, x):
        s1 = self.stage1(x)
        s2 = self.stage2(s1)
        return [s1, s2, self.stage3(s2)]


class _Head(nn.Module):
    """retinaface.py's ClassHead / BboxHead / LandmarkHead: a 1x1 conv with
    ``k`` outputs per anchor, read as [B, h * w * anchors, k] in the order
    row, column, anchor (the map permuted to NHWC before the reshape)."""

    def __init__(self, cin: int, k: int, anchors: int = 2):
        super().__init__()
        self.k = k
        self.conv1x1 = nn.Conv2d(cin, anchors * k, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1, self.k)


class RetinaFace(nn.Module):
    """retinaface.py:48-140. Default cfg_re50 (ResNet50 body, out_channel
    256); ``backbone="mobilenet0.25"`` with out_channel 64 is cfg_mnet
    (``retinaface_mnet``). Input [B, 3, H, W] BGR, mean-subtracted
    (``RETINA_MEAN``). Returns (loc [B, N, 4], conf [B, N, 2] softmaxed,
    landms [B, N, 10]) over the N anchors of ``prior_box((H, W))``."""

    def __init__(self, out_channel: int = 256, backbone: str = "resnet50"):
        super().__init__()
        if backbone == "mobilenet0.25":
            self.body, in_channels = MobileNetV1(), (64, 128, 256)
        else:
            self.body, in_channels = ResNet(return_stages=True), (512, 1024, 2048)
        self.backbone = backbone
        self.fpn = FPN(in_channels, out_channel)
        self.ssh1 = SSH(out_channel, out_channel)
        self.ssh2 = SSH(out_channel, out_channel)
        self.ssh3 = SSH(out_channel, out_channel)
        self.BboxHead = nn.ModuleList([_Head(out_channel, 4) for _ in range(3)])
        self.ClassHead = nn.ModuleList([_Head(out_channel, 2) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([_Head(out_channel, 10) for _ in range(3)])

    def forward(self, x):
        feats = self.body(x)
        if self.backbone != "mobilenet0.25":
            feats = feats[1:4]  # layer2..layer4
        fpn = self.fpn(feats)
        feats = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], 1)
        conf = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], 1)
        landms = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)], 1)
        return loc, torch.softmax(conf, dim=-1), landms


@functools.lru_cache(maxsize=None)
def prior_box(image_hw: Tuple[int, int]) -> torch.Tensor:
    """prior_box.py:7-34: [N, 4] anchors (cx, cy, w, h), normalised to the
    image, in the heads' order (level, row, column, min size). Cached per
    size; callers copy it to their device and do not write to it."""
    h, w = image_hw
    anchors = []
    for step, sizes in zip(STEPS, MIN_SIZES):
        fh, fw = -(-h // step), -(-w // step)
        cy, cx, s = np.meshgrid((np.arange(fh) + 0.5) * step / h,
                                (np.arange(fw) + 0.5) * step / w, sizes, indexing="ij")
        anchors.append(np.stack([cx, cy, s / w, s / h], -1).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(anchors).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _priors_on(image_hw: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """``prior_box`` on ``device``, copied there once: a copy of the
    anchors (688 KB at 1024^2) from pageable memory at every call would make
    the host wait for the card's queue."""
    return prior_box(image_hw).to(device)


@functools.lru_cache(maxsize=None)
def _scale_on(values: Tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A decode's pixel scale on ``device``, copied there once (a copy from
    the host at every call would make the host wait for the card's queue)."""
    return torch.tensor(values, dtype=dtype, device=device)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor, image_hw) -> torch.Tensor:
    """box_utils.py:209-235 decode, scaled to pixels: loc [B, N, 4] ->
    [B, N, 4] x1y1x2y2."""
    h, w = image_hw
    pri = priors[None]
    cxcy = pri[..., :2] + loc[..., :2] * VARIANCES[0] * pri[..., 2:]
    wh = pri[..., 2:] * torch.exp(loc[..., 2:] * VARIANCES[1])
    x1y1 = cxcy - wh / 2
    boxes = torch.cat([x1y1, x1y1 + wh], dim=-1)
    return boxes * _scale_on((w, h, w, h), boxes.dtype, boxes.device)


def decode_landms(ldm: torch.Tensor, priors: torch.Tensor, image_hw) -> torch.Tensor:
    """box_utils.py decode_landm, scaled to pixels: ldm [B, N, 10] ->
    [B, N, 10] (x, y) of the 5 points."""
    h, w = image_hw
    pri = priors[None, :, None]
    pts = pri[..., :2] + ldm.unflatten(-1, (5, 2)) * VARIANCES[0] * pri[..., 2:]
    return (pts * _scale_on((w, h), pts.dtype, pts.device)).flatten(-2)


def detect_faces(outputs, image_hw, confidence_threshold: float = 0.9):
    """The best face per image with its 5 landmarks, as FaceEnhancement
    consumes them (retinaface_detection.py + face_enhancement.py:91-120):
    the argmax of the face score over every anchor. Returns (boxes [B, 4]
    px, landms [B, 5, 2] px, valid [B]: score > threshold)."""
    loc, conf, ldm = outputs
    priors = _priors_on(tuple(image_hw), loc.device)
    scores = conf[..., 1]
    idx = torch.argmax(scores, dim=1)
    rows = torch.arange(len(idx), device=idx.device)
    boxes = decode_boxes(loc, priors, image_hw)[rows, idx]
    landms = decode_landms(ldm, priors, image_hw)[rows, idx]
    return boxes, landms.reshape(-1, 5, 2), scores[rows, idx] > confidence_threshold


def retinaface_mnet() -> RetinaFace:
    """cfg_mnet (config.py:3-21): MobileNetV1 x0.25 body, out_channel 64."""
    return RetinaFace(out_channel=64, backbone="mobilenet0.25")


def retinaface_arch(state_dict) -> RetinaFace:
    """The RetinaFace geometry of a checkpoint's state_dict: cfg_mnet when
    the body is MobileNetV1's, else cfg_re50, with out_channel read from
    the FPN, as the reference picks the cfg per checkpoint file
    (retinaface_detection.py:19-40). Falls back to cfg_re50."""
    try:
        backbone = ("mobilenet0.25" if "body.stage1.0.0.weight" in state_dict
                    else "resnet50")
        return RetinaFace(int(state_dict["fpn.output1.0.weight"].shape[0]), backbone)
    except (KeyError, TypeError, AttributeError):
        return RetinaFace()
