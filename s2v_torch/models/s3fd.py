"""S3FD single-shot face detector and its box post-processing (reference:
third_part/face_detection/detection/sfd/net_s3fd.py + detect.py + bbox.py).

- ``S3FD``: the VGG16 backbone and six detection heads, NCHW, with the
  reference's layer names (``s3fd.pth`` loads as it is); cls maps are
  softmaxed, the stride-4 one after its background max-out.
- ``decode_all``: every anchor of every scale decoded at once (bbox.py
  semantics) instead of the reference's host loop over score hits.
- ``best_boxes``: the pipeline keeps the highest-scoring face per frame
  (api.py:64-77 takes ``d[0]`` after score-ordered NMS: the global argmax),
  so it needs no NMS; ``nms_fixed`` is the fixed-size NMS of the multi-face
  API.
- ``pad_and_smooth_boxes``: face_detect's pads, clip and 5-frame smoothing.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# BGR means subtracted by the reference before detection (detect.py:59)
BGR_MEAN = (104.0, 117.0, 123.0)

# (name, cin, cout, kernel, stride, padding) of the backbone's convs, in
# order, each followed by a ReLU; "pool" is a 2x2 max-pool
_BACKBONE = [
    ("conv1_1", 3, 64, 3, 1, 1), ("conv1_2", 64, 64, 3, 1, 1), "pool",
    ("conv2_1", 64, 128, 3, 1, 1), ("conv2_2", 128, 128, 3, 1, 1), "pool",
    ("conv3_1", 128, 256, 3, 1, 1), ("conv3_2", 256, 256, 3, 1, 1),
    ("conv3_3", 256, 256, 3, 1, 1), "pool",
    ("conv4_1", 256, 512, 3, 1, 1), ("conv4_2", 512, 512, 3, 1, 1),
    ("conv4_3", 512, 512, 3, 1, 1), "pool",
    ("conv5_1", 512, 512, 3, 1, 1), ("conv5_2", 512, 512, 3, 1, 1),
    ("conv5_3", 512, 512, 3, 1, 1), "pool",
    ("fc6", 512, 1024, 3, 1, 3), ("fc7", 1024, 1024, 1, 1, 0),
    ("conv6_1", 1024, 256, 1, 1, 0), ("conv6_2", 256, 512, 3, 2, 1),
    ("conv7_1", 512, 128, 1, 1, 0), ("conv7_2", 128, 256, 3, 2, 1),
]

# (feature, L2Norm scale or None, its channels, cls channels) per head
_HEADS = [("conv3_3", 10.0, 256, 4), ("conv4_3", 8.0, 512, 2), ("conv5_3", 5.0, 512, 2),
          ("fc7", None, 1024, 2), ("conv6_2", None, 512, 2), ("conv7_2", None, 256, 2)]


class L2Norm(nn.Module):
    """net_s3fd.py:6-20: x / (||x||_C + eps) * weight, eps added after the
    square root."""

    def __init__(self, channels: int, scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))
        self.eps = 1e-10

    def forward(self, x):
        norm = x.pow(2).sum(dim=1, keepdim=True).sqrt() + self.eps
        return x / norm * self.weight.view(1, -1, 1, 1)


class S3FD(nn.Module):
    """net_s3fd.py:22-140. Input [B, 3, H, W] BGR, mean-subtracted.

    Returns 6 (cls [B, 2, fh, fw], reg [B, 4, fh, fw]) pairs, strides 4 to
    128; cls are probabilities (the reference softmaxes in detect.py:72-74),
    the stride-4 map after its background max-out (net_s3fd.py:124-127).
    """

    def __init__(self):
        super().__init__()
        for layer in _BACKBONE:
            if layer != "pool":
                name, cin, cout, k, s, p = layer
                setattr(self, name, nn.Conv2d(cin, cout, k, s, p))
        for feat, scale, ch, n_cls in _HEADS:
            head = f"{feat}_norm" if scale is not None else feat
            if scale is not None:
                setattr(self, head, L2Norm(ch, scale))
            setattr(self, f"{head}_mbox_conf", nn.Conv2d(ch, n_cls, 3, 1, 1))
            setattr(self, f"{head}_mbox_loc", nn.Conv2d(ch, 4, 3, 1, 1))

    def forward(self, x) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        taps = {feat for feat, _, _, _ in _HEADS}
        feats = {}
        h = x
        for layer in _BACKBONE:
            if layer == "pool":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(getattr(self, layer[0])(h))
            if layer[0] in taps:
                feats[layer[0]] = h
        outs = []
        for feat, scale, _, _ in _HEADS:
            f = feats[feat]
            head = feat
            if scale is not None:
                head = f"{feat}_norm"
                f = getattr(self, head)(f)
            cls = getattr(self, f"{head}_mbox_conf")(f)
            if cls.shape[1] == 4:  # max-out background label on the stride-4 map
                cls = torch.cat([cls[:, :3].amax(dim=1, keepdim=True), cls[:, 3:]], 1)
            outs.append((F.softmax(cls, dim=1), getattr(self, f"{head}_mbox_loc")(f)))
        return outs


@functools.lru_cache(maxsize=None)
def _priors(fh: int, fw: int, stride: int) -> np.ndarray:
    """[fh*fw, 4] (cx, cy, s, s) anchors (detect.py:82-86)."""
    ys, xs = np.mgrid[0:fh, 0:fw].astype(np.float32)
    cx = stride / 2.0 + xs * stride
    cy = stride / 2.0 + ys * stride
    size = np.full_like(cx, stride * 4.0)
    return np.stack([cx, cy, size, size], axis=-1).reshape(-1, 4)


def decode_all(outs) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-scale anchor decode (bbox.py:91-108). outs: the 6 (cls, reg)
    pairs of ``S3FD``. Returns (boxes [B, N, 4] x1y1x2y2, scores [B, N]),
    anchors in row-major order per scale."""
    v0, v1 = 0.1, 0.2
    boxes_all, scores_all = [], []
    for i, (cls, reg) in enumerate(outs):
        b, _, fh, fw = cls.shape
        pri = torch.from_numpy(_priors(fh, fw, 2 ** (i + 2))).to(reg.device)[None]
        loc = reg.float().permute(0, 2, 3, 1).reshape(b, fh * fw, 4)
        cxcy = pri[..., :2] + loc[..., :2] * v0 * pri[..., 2:]
        wh = pri[..., 2:] * torch.exp(loc[..., 2:] * v1)
        x1y1 = cxcy - wh / 2.0
        boxes_all.append(torch.cat([x1y1, x1y1 + wh], dim=-1))
        scores_all.append(cls[:, 1].float().reshape(b, fh * fw))
    return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)


def best_boxes(outs, score_thresh: float = 0.5):
    """Highest-scoring face per image. Returns (boxes [B, 4] x1y1x2y2
    clipped at 0, valid [B] bool: score above ``score_thresh``)."""
    boxes, scores = decode_all(outs)
    idx = torch.argmax(scores, dim=1)
    rows = torch.arange(len(idx), device=idx.device)
    return torch.clamp(boxes[rows, idx], min=0.0), scores[rows, idx] > score_thresh


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, top_k: int = 32,
              iou_thresh: float = 0.3, score_thresh: float = 0.5):
    """NMS over the ``top_k`` best candidates (bbox.py:44-66, the +1 in the
    areas included). boxes [N, 4], scores [N]. Returns (boxes [k, 4],
    scores [k], keep [k] bool), ordered by score."""
    k = min(top_k, scores.shape[0])
    top_scores, order = torch.topk(scores, k)
    cand = boxes[order]
    x1, y1, x2, y2 = cand.unbind(dim=1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    w = torch.clamp(torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])
                    + 1, min=0.0)
    h = torch.clamp(torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])
                    + 1, min=0.0)
    iou = w * h / (areas[:, None] + areas[None] - w * h)
    keep = torch.ones(k, dtype=torch.bool, device=boxes.device)
    for i in range(1, k):  # suppress i if a kept, higher-scoring j overlaps it
        keep[i] = ~(keep[:i] & (iou[i, :i] > iou_thresh)).any()
    return cand, top_scores, keep & (top_scores > score_thresh)


def pad_and_smooth_boxes(boxes: np.ndarray, image_hw: Tuple[int, int],
                         pads: Tuple[int, int, int, int] = (0, 20, 0, 0),
                         smooth: bool = True) -> np.ndarray:
    """face_detect post-processing (inference_utils.py:130-144): floor the
    boxes (x1, y1, x2, y2), apply pads (top, bottom, left, right), clip to
    the frame, then the reference's 5-frame smoothing. Returns [N, 4] int."""
    h, w = image_hw
    pady1, pady2, padx1, padx2 = pads
    b = np.floor(np.asarray(boxes, np.float32)).astype(np.int64)
    out = np.stack([np.maximum(b[:, 0] - padx1, 0), np.maximum(b[:, 1] - pady1, 0),
                    np.minimum(b[:, 2] + padx2, w), np.minimum(b[:, 3] + pady2, h)],
                   axis=1)
    if smooth:
        out = smooth_boxes(out, 5)
    return out


def smooth_boxes(boxes: np.ndarray, window: int = 5) -> np.ndarray:
    """inference_utils.py:101-108: forward-looking ``window``-frame mean,
    recentred on the last frames near the tail, assigned in place into an
    int array (later windows read smoothed rows; values truncate)."""
    cur = np.array(boxes, np.int64)
    n = len(cur)
    for i in range(n):
        win = cur[n - window:] if i + window > n else cur[i:i + window]
        cur[i] = np.trunc(win.mean(axis=0))
    return cur
