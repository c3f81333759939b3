"""GPEN face enhancement, final-stage configuration (reference:
third_part/GPEN/face_enhancement.py:48-193 + align_faces.py).

The port covers the configuration Step 6 hands its frames to: RealESRNet
(RRDBNet at its ``scale``) super-resolves the full frame; the face is located by
5-point landmarks supplied by the caller (config ``model.reuse_detections``:
the pipeline's own 68-point sweeps, mapped by ``lm68_to_lm5``); a umeyama
similarity warps the bilinear-upscaled frame to the ``in_size`` crop;
GPEN enhances it; ParseNet's face mask, border-zeroed and double-blurred,
pastes the enhanced face back over the SR frame through the inverse warp.
RetinaFace detection and the non-SR composites (default and Laplacian
blend) are not ported yet.

Public layout as s2v_tpu: NHWC uint8 frames, [N, 5, 2] landmarks in pre-SR
pixel coordinates, x1y1x2y2 boxes. Inside, NCHW float tensors on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from s2v_torch.device import resolve_device
from s2v_torch.models.parsenet import parse_mask
from s2v_torch.ops.image import frames_to_nchw, resize_bilinear
from s2v_torch.ops.warp import affine_warp
from s2v_torch.pipeline.utils import mask_postprocess

# align_faces.py:14-22
REFERENCE_FACIAL_POINTS = np.array(
    [[30.29459953, 51.69630051], [65.53179932, 51.50139999],
     [48.02519989, 71.73660278], [33.54930115, 92.3655014],
     [62.72990036, 92.20410156]], np.float32)
DEFAULT_CROP_SIZE = (96, 112)

# the small-face smoothing kernel (face_enhancement.py:72-75)
SMALL_FACE_KERNEL = np.array([[0.0625, 0.125, 0.0625],
                              [0.125, 0.25, 0.125],
                              [0.0625, 0.125, 0.0625]], np.float32)

# face-region colormap of the blending mask (face_enhancement.py:141)
FACE_MASK_COLORMAP = [0, 255, 255, 255, 255, 255, 255, 255, 0, 0, 255, 255,
                      255, 0, 0, 0, 0, 0, 0]


def get_reference_facial_points(output_size: Tuple[int, int],
                                inner_padding_factor: float = 0.25,
                                outer_padding: Tuple[int, int] = (0, 0),
                                default_square: bool = True) -> np.ndarray:
    """align_faces.py:101-207 (the FaceEnhancement configuration)."""
    pts = REFERENCE_FACIAL_POINTS.astype(np.float64)
    crop = np.array(DEFAULT_CROP_SIZE, np.float64)
    if default_square:
        diff = max(crop) - crop
        pts = pts + diff / 2
        crop = crop + diff
    if output_size and output_size[0] == crop[0] and output_size[1] == crop[1]:
        return pts.astype(np.float32)
    if inner_padding_factor == 0 and outer_padding == (0, 0):
        return pts.astype(np.float32)
    if inner_padding_factor > 0:
        diff = crop * inner_padding_factor * 2
        pts = pts + diff / 2
        crop = crop + np.round(diff)
    size_bf_outer_pad = np.array(output_size) - np.array(outer_padding) * 2
    pts = pts * (size_bf_outer_pad[0] / crop[0]) + np.array(outer_padding)
    return pts.astype(np.float32)


def umeyama_similarity_batched(src: torch.Tensor, dst: torch.Tensor):
    """Closed-form 2-D umeyama similarity, src [B, P, 2] -> dst [P, 2] or
    [B, P, 2]. Returns (tfm [B, 2, 3], scale [B]).

    For the 2-D similarity the SVD collapses: the rotation is the special
    orthogonal polar factor of A = dst_d^T src_d / P, theta = atan2(A10 - A01,
    A00 + A11), and S.d is the hypot of the same two terms. Matches
    align_faces.py's _umeyama for every non-degenerate input.
    """
    if dst.dim() == 2:
        dst = dst[None].expand_as(src)
    p = src.shape[1]
    sm, dm = src.mean(dim=1), dst.mean(dim=1)
    sd, dd = src - sm[:, None], dst - dm[:, None]
    a = torch.einsum("bpi,bpj->bij", dd, sd) / p
    num = a[:, 1, 0] - a[:, 0, 1]
    den = a[:, 0, 0] + a[:, 1, 1]
    theta = torch.atan2(num, den)
    cs, sn = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([cs, -sn], -1), torch.stack([sn, cs], -1)], dim=1)
    src_var = (sd * sd).sum(dim=-1).mean(dim=1)
    sc = torch.hypot(den, num) / torch.clamp(src_var, min=1e-12)
    rs = rot * sc[:, None, None]
    t = dm - torch.einsum("bij,bj->bi", rs, sm)
    return torch.cat([rs, t[:, :, None]], dim=-1), sc


def small_face_filter(x: torch.Tensor) -> torch.Tensor:
    """cv2.filter2D with the 3x3 smoothing kernel, REFLECT_101 border
    (face_enhancement.py:153-154, for faces under 100 px)."""
    c = x.shape[1]
    w = torch.from_numpy(SMALL_FACE_KERNEL).to(x)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(F.pad(x, [1, 1, 1, 1], mode="reflect"), w, groups=c)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 255] and truncate to uint8 (numpy's astype)."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


class FaceEnhancer:
    """GPEN FaceEnhancement with RealESRNet SR and supplied landmarks.

    models: dict of loaded modules — 'facegan' (FullGenerator), 'parsenet'
    (ParseNet), 'srmodel' (RRDBNet, whose ``scale`` sets the output size).
    ``dtype`` is the generators' compute dtype on the card (autocast);
    warps, masks and composites stay f32.
    """

    def __init__(self, models: dict, in_size: int = 512, dtype: str = "bfloat16",
                 parse_size: int = 512, device=None):
        self.device = resolve_device(device)
        self.models = {k: m.to(self.device).eval() for k, m in models.items()}
        for name in ("facegan", "parsenet", "srmodel"):
            if name not in self.models:
                raise ValueError(f"FaceEnhancer needs a '{name}' model")
        self.in_size = in_size
        self.sr_scale = self.models["srmodel"].scale
        self.parse_size = int(parse_size)
        # 2048^2 crops are ~50 MB each in f32: small batches at that size
        self.chunk = 1 if in_size >= 1024 else 16
        self.reference_5pts = torch.from_numpy(
            get_reference_facial_points((in_size, in_size), 0.25, (0, 0), True)
        ).to(self.device)
        self.amp = dtype == "bfloat16" and self.device.type == "cuda"

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.amp)

    @torch.no_grad()
    def _enhance_chunk(self, up: torch.Tensor, img_sr: torch.Tensor,
                       lms5: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
        """up: bilinear-upscaled frames, img_sr: SR frames, both [k, 3, H, W]
        float 0..255; lms5 [k, 5, 2] in up's coordinates. Returns uint8
        [k, 3, H, W]."""
        s, ps = self.in_size, self.parse_size
        tfms, _ = umeyama_similarity_batched(lms5, self.reference_5pts)
        of = affine_warp(up, tfms, (s, s))
        with self._autocast():
            ef = self.models["facegan"](of / 255.0 * 2.0 - 1.0)
        ef = torch.clamp((ef.float() + 1.0) / 2.0, 0.0, 1.0) * 255.0
        # the mask is parsed from the unfiltered face (face_enhancement.py:145)
        efp = resize_bilinear(ef, (ps, ps))
        with self._autocast():
            logits, _ = self.models["parsenet"](efp / 255.0 * 2.0 - 1.0)
        mask_sharp = parse_mask(logits.float(), FACE_MASK_COLORMAP)[:, None] / 255.0
        mask_sharp = resize_bilinear(mask_sharp, (512, 512))
        tmp_mask = resize_bilinear(mask_postprocess(mask_sharp, thres=26), (s, s))
        ef = torch.where(small[:, None, None, None], small_face_filter(ef), ef)
        packed = affine_warp(
            torch.cat([ef, tmp_mask, resize_bilinear(mask_sharp, (s, s))], dim=1),
            tfms, up.shape[2:], inverse=True)
        tmp_img, full_mask = packed[:, :3], packed[:, 3:4]
        return _to_u8(img_sr * (1.0 - full_mask) + tmp_img * full_mask)

    @torch.no_grad()
    def _super_resolve(self, x: torch.Tensor) -> torch.Tensor:
        with self._autocast():
            out = self.models["srmodel"](x / 255.0)
        return (torch.clamp(out.float(), 0.0, 1.0) * 255.0).to(torch.uint8).float()

    @torch.no_grad()
    def process_batch(self, frames, landmarks5, det_boxes=None) -> torch.Tensor:
        """frames [N, H, W, 3] uint8 (numpy or tensor); landmarks5 [N, 5, 2]
        in frame pixels; det_boxes [N, 4] x1y1x2y2 feed the small-face flag
        (all faces large when absent). Returns [N, sH, sW, 3] uint8 on the
        device."""
        x = frames_to_nchw(frames, self.device)
        n, _, h, w = x.shape
        scale = float(self.sr_scale)
        lms = torch.as_tensor(np.asarray(landmarks5, np.float32) * scale,
                              device=self.device)
        if det_boxes is not None:
            bb = np.asarray(det_boxes, np.float32) * scale
            small = np.minimum(bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1]) < 100
        else:
            small = np.zeros((n,), bool)
        small = torch.as_tensor(small, device=self.device)
        out = []
        for i in range(0, n, self.chunk):
            c = x[i:i + self.chunk]
            up = _to_u8(resize_bilinear(c, (h * self.sr_scale, w * self.sr_scale)))
            out.append(self._enhance_chunk(up.float(), self._super_resolve(c),
                                           lms[i:i + self.chunk],
                                           small[i:i + self.chunk]))
        return torch.cat(out).permute(0, 2, 3, 1)


def final_enhancer_hook(enhancer: FaceEnhancer):
    """The pipeline's ``final_enhancer`` hook: GPEN + RealESRNet x2 over a
    batch of composited frames (cli.py's final_hook). The face box only
    matters to the non-SR Laplacian composite, which this configuration
    does not use."""

    def hook(frames, boxes_xyxy, landmarks5=None, det_boxes=None):
        if landmarks5 is None:
            raise ValueError("the port's final enhancer needs landmarks5 "
                             "(config model.reuse_detections): RetinaFace is "
                             "not ported yet")
        return enhancer.process_batch(frames, landmarks5, det_boxes=det_boxes)

    return hook
