"""GPEN face enhancement (reference: third_part/GPEN/face_enhancement.py:
48-193 + align_faces.py), in the two configurations the pipeline runs:

- Step 5, the reference enhancer (``in_size`` 512, ``face_enhance=False``):
  GPEN is not run; the warped crop itself is parsed and pasted back with the
  default double-alpha composite over the original frame.
- The final stage (GPEN-BFR-2048 with RealESRNet x2): RRDBNet super-resolves
  the full frame, the face is located on the bilinear-2x frame, GPEN
  enhances the crop and the face is composited over the SR frame.

Per frame: RetinaFace finds the best face and its 5 landmarks (or the
caller supplies them: config ``model.reuse_detections``, the pipeline's
68-point sweeps mapped by ``lm68_to_lm5``); a closed-form umeyama
similarity warps the frame to the ``in_size`` crop; ParseNet's face mask,
border-zeroed and double-blurred, pastes the face back through the inverse
warp. A frame whose best face scores under ``threshold`` keeps its
original (or SR) pixels. Without SR, ``possion_blending`` composites with a
6-level Laplacian blend at 512^2 instead of the double alpha: over the face
mask restricted to the boxes, or over the full mask when no boxes are given.

Public layout as s2v_tpu: NHWC uint8 frames, [N, 5, 2] landmarks in pre-SR
pixel coordinates, x1y1x2y2 boxes. Inside, NCHW float tensors on the device.

Each network is called through its ``s2v_torch.pipeline.nets.Net``
(stage ``enhancer``), which sets its precision and, for the final stage's
one-frame calls on a card, replays it from a CUDA graph.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from s2v_torch.device import constant_on, resolve_device
from s2v_torch.models.parsenet import parse_mask
from s2v_torch.ops.image import frames_to_nchw, resize_bilinear
from s2v_torch.ops.warp import affine_warp, affine_warp_shear
from s2v_torch.parallel.mesh import map_frames, per_device_chunk
from s2v_torch.pipeline.nets import retinaface_detect, stage_nets
from s2v_torch.pipeline.utils import gaussian_blur, laplacian_pyramid_blend, mask_postprocess

# align_faces.py:14-22
REFERENCE_FACIAL_POINTS = np.array(
    [[30.29459953, 51.69630051], [65.53179932, 51.50139999],
     [48.02519989, 71.73660278], [33.54930115, 92.3655014],
     [62.72990036, 92.20410156]], np.float32)
DEFAULT_CROP_SIZE = (96, 112)

# the small-face smoothing kernel (face_enhancement.py:72-75)
SMALL_FACE_KERNEL = ((0.0625, 0.125, 0.0625),
                     (0.125, 0.25, 0.125),
                     (0.0625, 0.125, 0.0625))

# face-region colormap of the blending mask (face_enhancement.py:141)
FACE_MASK_COLORMAP = (0, 255, 255, 255, 255, 255, 255, 255, 0, 0, 255, 255,
                      255, 0, 0, 0, 0, 0, 0)


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
    w = constant_on(SMALL_FACE_KERNEL, x.device, x.dtype)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(F.pad(x, [1, 1, 1, 1], mode="reflect"), w, groups=c)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 255] and truncate to uint8 (numpy's astype)."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def _box_mask(bboxes, hw, device) -> torch.Tensor:
    """[k, 1, H, W] ones over rows y1 to max(y2 - 5, y1) and columns x1 to
    x2 of each (y1, y2, x1, x2) box, zeros elsewhere: the blending mask's
    box restriction (face_enhancement.py:181-184), with numpy's slice
    semantics for the truncated bounds (as s2v_tpu builds it)."""
    h, w = hw
    bounds = []
    for y1, y2, x1, x2 in (tuple(int(t) for t in b) for b in np.asarray(bboxes)):
        ys, ye, _ = slice(y1, max(y2 - 5, y1)).indices(h)
        xs, xe, _ = slice(x1, x2).indices(w)
        bounds.append((ys, ye, xs, xe))
    b = torch.tensor(bounds, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    m = ((ys >= b[:, 0, None, None]) & (ys < b[:, 1, None, None])
         & (xs >= b[:, 2, None, None]) & (xs < b[:, 3, None, None]))
    return m[:, None].float()


class FaceEnhancer:
    """GPEN FaceEnhancement, with the surface of s2v_tpu's (``models``,
    ``in_size``, ``threshold``, ``process_batch``).

    models: dict of loaded modules: 'retinaface' (RetinaFace; may be left out
    when every call supplies ``landmarks5``), 'parsenet' (ParseNet),
    'facegan' (FullGenerator at ``in_size``; may be left out when every call
    has ``face_enhance=False``, as Step 5's does: s2v_tpu builds it there
    and never runs it) and 'srmodel' (RRDBNet, optional: when present, frames
    are super-resolved by its ``scale`` and composited over the SR frame).
    ``dtype`` and ``det_dtype`` are ``model.dtype`` and
    ``model.detector_dtype`` (``nets``); warps, masks and composites run in
    f32. ``approx_warp`` (config ``model.approx_warp``) takes
    ``affine_warp_shear`` for the crop and paste warps. ``mesh`` (a
    ``FrameMesh``) splits each chunk's frames over its data axis, each
    slice on the modules' replica on its device; a chunk then holds
    ``chunk`` frames per data device, so the 2048^2 stage's one frame a
    device runs on every device too.
    """

    def __init__(self, models: dict, in_size: int = 512, threshold: float = 0.9,
                 dtype: str = "bfloat16", parse_size: int = 512, approx_warp: bool = False,
                 det_dtype: str = "float32", device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh.first if mesh is not None else resolve_device(device)
        self.models = {k: m.to(self.device).eval() for k, m in models.items()
                       if m is not None}
        if "parsenet" not in self.models:
            raise ValueError("FaceEnhancer needs a 'parsenet' model")
        self.in_size = in_size
        self.threshold = threshold
        self.use_sr = "srmodel" in self.models
        self.sr_scale = self.models["srmodel"].scale if self.use_sr else 1
        self.parse_size = int(parse_size)
        # 2048^2 crops are ~50 MB each in f32: small batches at that size
        self.chunk = per_device_chunk(1 if in_size >= 1024 else 16, mesh)
        self.reference_5pts = torch.from_numpy(
            get_reference_facial_points((in_size, in_size), 0.25, (0, 0), True)
        ).to(self.device)
        self.warp = affine_warp_shear if approx_warp else affine_warp
        self.nets = stage_nets("enhancer", self.models.get, dtype=dtype, det_dtype=det_dtype,
                               mesh=mesh, owner="FaceEnhancer")

    def _detect(self, x: torch.Tensor):
        """RetinaFace on frames [k, 3, H, W] RGB 0..255 (enhance.py
        detect_tfms): (landmarks [k, 5, 2], small [k], valid [k]); ``small``
        when the box's shorter side is under 100 px."""
        boxes, landms, valid = retinaface_detect(self.nets["retinaface"], x, self.threshold)
        small = torch.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]) < 100
        return landms, small, valid

    @torch.no_grad()
    def _faces_and_masks(self, x: torch.Tensor, tfms: torch.Tensor, small: torch.Tensor,
                         face_enhance: bool):
        """Warp to the ``in_size`` crop, enhance it with GPEN when
        ``face_enhance`` (else the crop is the face), parse the face mask.
        Returns (face, tmp_mask, mask_sharp) [k, 3|1|1, s, s], f32."""
        s, ps = self.in_size, self.parse_size
        ef = self.warp(x, tfms, (s, s))
        if face_enhance:
            ef = self.nets["facegan"](ef / 255.0 * 2.0 - 1.0)
            ef = torch.clamp((ef.float() + 1.0) / 2.0, 0.0, 1.0) * 255.0
        # the mask is parsed from the unfiltered face (face_enhancement.py:145)
        efp = resize_bilinear(ef, (ps, ps))
        logits, _ = self.nets["parsenet"](efp / 255.0 * 2.0 - 1.0)
        mask_sharp = parse_mask(logits.float(), constant_on(FACE_MASK_COLORMAP, efp.device))
        mask_sharp = mask_sharp[:, None] / 255.0
        mask_sharp = resize_bilinear(mask_sharp, (512, 512))
        tmp_mask = resize_bilinear(mask_postprocess(mask_sharp, thres=26), (s, s))
        ef = torch.where(small[:, None, None, None], small_face_filter(ef), ef)
        return ef, tmp_mask, resize_bilinear(mask_sharp, (s, s))

    @torch.no_grad()
    def _paste_composite(self, ef, tmp_mask, mask_sharp, tfms, base, valid, mode: str,
                         box_mask=None):
        """Inverse-warp the face and its masks to the frame (one 5-channel
        warp) and composite over ``base`` [k, 3, H, W] (the SR frame in
        ``mode`` 'sr', else the original), the sharp mask blurred by
        GaussianBlur(9, 1.0) (face_enhancement.py:162). 'default': the double
        alpha (face_enhancement.py:191-193); 'possion': the 6-level Laplacian
        blend at 512^2 over the sharp mask times ``box_mask`` [k, 1, H, W];
        'possion_nobbox': over the full mask (face_enhancement.py:179-189).
        Frames not ``valid`` keep ``base``. Returns uint8 [k, 3, H, W]."""
        packed = self.warp(torch.cat([ef, tmp_mask, mask_sharp], dim=1), tfms,
                           base.shape[2:], inverse=True)
        tmp_img, full_mask = packed[:, :3], packed[:, 3:4]
        if mode.startswith("possion"):
            blend_mask = (gaussian_blur(packed[:, 4:5], 9, 1.0) * box_mask
                          if mode == "possion" else full_mask)
            blended = laplacian_pyramid_blend(resize_bilinear(tmp_img, (512, 512)),
                                              resize_bilinear(base, (512, 512)),
                                              resize_bilinear(blend_mask, (512, 512)),
                                              num_levels=6)
            out = resize_bilinear(torch.clamp(blended, 0.0, 255.0), base.shape[2:])
        else:
            out = base * (1.0 - full_mask) + tmp_img * full_mask
            if mode == "default":
                mask_sharp_w = gaussian_blur(packed[:, 4:5], 9, 1.0)
                out = base * (1.0 - mask_sharp_w) + out * mask_sharp_w
        return _to_u8(torch.where(valid[:, None, None, None], out, base))

    @torch.no_grad()
    def process_batch(self, frames, ori_frames=None, face_enhance: bool = True,
                      possion_blending: bool = False, bboxes=None, landmarks5=None,
                      det_boxes=None) -> torch.Tensor:
        """s2v_tpu's FaceEnhancer.process_batch: frames [N, H, W, 3] uint8
        (numpy or tensor). ``ori_frames`` is the paste base of the non-SR
        composites (the frames when None). ``landmarks5`` [N, 5, 2] in frame
        pixels replace the RetinaFace pass (all frames then valid);
        ``det_boxes`` [N, 4] x1y1x2y2 feed their small-face flag (all faces
        large when absent). Under SR the composite is over the SR frame
        whatever ``possion_blending`` says; without SR, ``possion_blending``
        takes the Laplacian blend, its mask restricted to ``bboxes`` [N, 4]
        (y1, y2, x1, x2; rows y1 to y2 - 5) when given. Returns [N, sH, sW,
        3] uint8 on the device (s = the SR scale, or 1)."""
        mode = ("sr" if self.use_sr else
                ("possion" if bboxes is not None else "possion_nobbox") if possion_blending
                else "default")
        x = _to_u8(frames_to_nchw(frames, self.device)).float()
        n, _, h, w = x.shape
        ori = x if ori_frames is None else _to_u8(frames_to_nchw(ori_frames, self.device)).float()
        scale = float(self.sr_scale)
        if landmarks5 is not None:
            lms = torch.as_tensor(np.asarray(landmarks5, np.float32) * scale,
                                  device=self.device)
            if det_boxes is not None:
                bb = np.asarray(det_boxes, np.float32) * scale
                small = np.minimum(bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1]) < 100
            else:
                small = np.zeros((n,), bool)
            small = torch.as_tensor(small, device=self.device)
            valid = torch.ones((n,), dtype=torch.bool, device=self.device)
        out = []
        for i in range(0, n, self.chunk):
            sl = slice(i, i + self.chunk)
            mb = (_box_mask(np.asarray(bboxes)[sl], (h, w), self.device)
                  if mode == "possion" else None)
            chunk = (x[sl], None if self.use_sr else ori[sl], mb) + (
                (None, None, None) if landmarks5 is None else (lms[sl], small[sl], valid[sl]))
            out.append(map_frames(
                lambda *a: self._process_chunk(*a, mode=mode, face_enhance=face_enhance),
                *chunk, mesh=self.mesh))
        return torch.cat(out).permute(0, 2, 3, 1)

    def _process_chunk(self, c, ori, mb, lms, small, valid, mode: str, face_enhance: bool):
        """One chunk's (or mesh slice's) frames [k, 3, H, W] on one device:
        SR, detection unless ``lms`` are given, warp, GPEN, parse, paste."""
        if self.use_sr:
            # SR the frame; locate and warp the face on the bilinear-2x
            # frame (face_enhancement.py:103-106)
            sr = self.nets["srmodel"](c / 255.0)
            base = (torch.clamp(sr.float(), 0.0, 1.0) * 255.0).to(torch.uint8).float()
            c = _to_u8(resize_bilinear(c, base.shape[2:])).float()
        else:
            base = ori
        if lms is None:
            lms, small, valid = self._detect(c)
        tfms, _ = umeyama_similarity_batched(lms, self.reference_5pts.to(c.device))
        faces = self._faces_and_masks(c, tfms, small, face_enhance)
        return self._paste_composite(*faces, tfms, base, valid, mode, mb)


def reference_enhancer_hook(enhancer: FaceEnhancer):
    """The pipeline's ``ref_enhancer`` hook, Step 5 (cli.py:124-126): the
    GPEN-BFR-512 enhancer with ``face_enhance=False`` over the stabilised
    frames; ``landmarks5`` / ``det_boxes`` pass through
    (``model.reuse_detections``)."""

    def hook(frames, **kw):
        return enhancer.process_batch(frames, face_enhance=False, **kw)

    hook.enhancer = enhancer
    return hook


def final_enhancer_hook(enhancer: FaceEnhancer):
    """The pipeline's ``final_enhancer`` hook (cli.py:156-162): GPEN-BFR-2048
    (+ RealESRNet x2 when the enhancer has it) over a batch of composited
    frames, with ``possion_blending`` and the face boxes as (y1, y2, x1, x2)
    (they matter only to the non-SR Laplacian blend). Without landmarks the
    enhancer locates the face with RetinaFace."""

    def hook(frames, boxes_xyxy, **kw):
        bb = np.asarray(boxes_xyxy)[:, [1, 3, 0, 2]]
        return enhancer.process_batch(frames, face_enhance=True, possion_blending=True,
                                      bboxes=bb, **kw)

    hook.enhancer = enhancer
    return hook
