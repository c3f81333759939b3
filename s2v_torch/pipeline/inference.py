"""The lip-sync pipeline on the card, from a clip's frames to the enhanced
output (reference: inference.py main() + preprocessing/facing.py;
s2v_tpu/pipeline/inference.py ``LipSyncPipeline``):

- Step 1: ``extract_landmarks`` (S3FD box -> FAN 68 landmarks, one sweep
  per frame chunk; ``return_boxes`` keeps the boxes for Step 6) and
  ``ffhq_crop`` (the first frame's FFHQ quad, 256^2 crops).
- Step 2: ``extract_coeffs``: ``align_img`` on the host (Pillow's resample
  rebuilt in numpy) and ReconNet's 257 3DMM coefficients, batched.
- Step 3: ``stabilize``: the 26-frame coefficient windows with the
  expression overwritten, then DNet.
- Step 4 is ``s2v_torch.audio.melspectrogram``.
- Step 5: ``enhance_reference``: the ``ref_enhancer`` hook (GPEN-BFR-512's
  enhancer with ``face_enhance=False``: RetinaFace, the warped crop parsed by
  ParseNet and composited back) over the stabilised frames; under config
  ``model.reuse_detections`` one landmark sweep of those frames replaces
  its RetinaFace pass and serves Step 6's reference faces too.
- Step 6: ``synthesize``: reference faces, ENet synthesis and paste-back
  (under ``infer.without_rl1`` the prediction is composited with the
  original faces first, edited by the ``up_face_editor`` hook, GANimation,
  when ``--up_face`` asks for it; ``infer.box`` fixes the face box);
  the ``mouth_restorer`` hook (GFPGANv1Clean, ParseNet's mouth mask and the
  10-level Laplacian blend, ``s2v_torch.pipeline.restoration``); then the
  ``final_enhancer`` hook (GPEN-BFR-2048 + RealESRNet x2,
  ``s2v_torch.pipeline.enhance``). Both hooks locate the face with
  RetinaFace (the final one on the bilinear-2x frame), or take the Step-1
  landmarks under ``model.reuse_detections``. ``infer.cropped_image``
  brings the final stage's output back to 1x and keeps only its face box
  over the original frame.

``run(face_path, audio_path, outfile)`` chains them as s2v_tpu's ``run``
does: the clip file (``s2v_torch.io.video_io``), the ``--crop`` window,
Steps 1-3 and 5 through the per-video artifact cache
(``s2v_torch.utils.cache``; Steps 3 and 5 written after Step 6), the wav
and its mel, Step 6, the frames written and muxed with the audio.

Spans (``s2v_torch.utils.trace``): ``infer.run`` around ``run``, inside it
``io.read_clip``, the cache's ``cache.hit`` / ``cache.miss`` per stage,
``audio.mel``, ``cache.flush``, ``io.write`` and ``io.mux``; one per stage
method (``step1.landmarks``, ``step1.ffhq_crop``, ``step2.coeffs``,
``step3.stabilize``, ``step5.enhance_reference``, ``step6.synthesize``);
inside ``synthesize`` ``step6.reference_faces``, and per batch
``step6.lipsync``, ``step6.mouth_tail``, ``step6.final_stage`` and
``step6.to_host``.

Each network is called through its ``s2v_torch.pipeline.nets.Net``
(stage ``pipeline``), which sets its precision; S3FD's and FAN's decodes
run in f32. ``model.approx_warp`` takes ``affine_warp_shear`` for the
reference faces' warps. Public layout as s2v_tpu: NHWC uint8 frames,
x1y1x2y2 boxes, [N, 68, 2] landmarks. Frames cross to the device once;
intermediates stay there as NCHW float tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from s2v_torch.audio.melspec import mel_chunks_for_frames, melspectrogram, num_mel_chunks
from s2v_torch.device import constant_on, full_f32, resolve_device
from s2v_torch.io.audio_io import load_wav
from s2v_torch.io.video_io import VideoReader, VideoWriter, mux_audio
from s2v_torch.models.fan import (box_to_center_scale, crop_faces_batched,
                                  heatmaps_to_landmarks, lm68_to_lm5)
from s2v_torch.models.s3fd import BGR_MEAN, best_boxes, pad_and_smooth_boxes
from s2v_torch.ops.image import frames_to_nchw, resize_bilinear
from s2v_torch.ops.warp import (affine_warp, affine_warp_shear, crop_resize_boxes,
                                paste_resize_boxes)
from s2v_torch.parallel.mesh import map_frames
from s2v_torch.pipeline.align import (compute_transform, crop_quad_params, ffhq_crop_box,
                                      quad_from_cxy)
from s2v_torch.pipeline.face3d_prep import align_img
from s2v_torch.pipeline.nets import stage_nets
from s2v_torch.pipeline.utils import find_crop_norm_ratio, transform_semantic
from s2v_torch.utils.cache import ArtifactCache
from s2v_torch.utils import trace
from s2v_torch.utils.config import PipelineConfig

# Version of the Steps 1-5 artifact chain, s2v_tpu's: shared by every
# stage's cache key, so a bump invalidates the whole chain and the two
# packages name the same artifacts alike.
_CACHE_VERSION = 3


@dataclass
class PipelineModels:
    """Loaded modules per stage; None disables the stage.

    lm3d: [5, 3] standard 3D landmarks (``face3d_prep.load_lm3d``);
    expression: [64] template expression coefficients; ganimation: the
    SplitGenerator of ``--up_face`` (loaded whenever its file is present).
    ref_enhancer(frames [N, 256, 256, 3] uint8, landmarks5=None,
    det_boxes=None) -> [N, 256, 256, 3] uint8 (Step 5).
    mouth_restorer(frames [B, H, W, 3] uint8, boxes [B, 4] x1y1x2y2,
    landmarks5=None) -> [B, H, W, 3] uint8 (the Step-6 mouth tail).
    final_enhancer(frames [B, H, W, 3] uint8, boxes [B, 4] x1y1x2y2,
    landmarks5=None, det_boxes=None) -> [B, 2H, 2W, 3] uint8.
    up_face_editor(faces [B, 3, S, S] float 0..1 on the device) -> the same
    (GANimation; it takes effect under ``infer.without_rl1``).
    """

    s3fd: Optional[torch.nn.Module] = None
    fan: Optional[torch.nn.Module] = None
    recon: Optional[torch.nn.Module] = None
    dnet: Optional[torch.nn.Module] = None
    enet: Optional[torch.nn.Module] = None
    lm3d: Optional[np.ndarray] = None
    expression: Optional[np.ndarray] = None
    ganimation: Optional[torch.nn.Module] = None
    ref_enhancer: Optional[Callable] = None
    mouth_restorer: Optional[Callable] = None
    final_enhancer: Optional[Callable] = None
    up_face_editor: Optional[Callable] = None


def reference_face_transforms(lms: np.ndarray, image_size: int = 256):
    """Per-frame affine maps of the reference-face construction (host,
    float64): the QUAD re-align ``crops <- stabilized`` and its inverse paste
    ``region256 <- crops``, both [N, 2, 3] destination -> source. The
    quad_from_cxy quads are parallelograms, so both warps are exactly
    affine."""
    n = len(lms)
    s = float(image_size)
    quad_mats = np.zeros((n, 2, 3), np.float32)
    paste_mats = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        c, x, y = compute_transform(lms[i].astype(np.float64), scale=1.0)
        crop_box, quad_adj = crop_quad_params(quad_from_cxy(c, x, y),
                                              (image_size, image_size), image_size)
        nw, sw, _, ne = quad_adj + np.asarray(crop_box[:2], np.float64)
        ex, ey = (ne - nw) / s, (sw - nw) / s  # source steps per output px
        quad_mats[i, 0] = [ex[0], ey[0], nw[0] + 0.5 * (ex[0] + ey[0]) - 0.5]
        quad_mats[i, 1] = [ex[1], ey[1], nw[1] + 0.5 * (ex[1] + ey[1]) - 0.5]
        mi = np.linalg.inv(np.array([[ex[0], ey[0]], [ex[1], ey[1]]], np.float64))
        t = mi @ (np.array([0.5, 0.5]) - nw) - 0.5
        paste_mats[i] = [[mi[0, 0], mi[0, 1], t[0]], [mi[1, 0], mi[1, 1], t[1]]]
    return quad_mats, paste_mats


def _frame_index(i: int, n_frames: int, static: bool) -> int:
    """Frame for mel chunk i: ping-pong past the end of the clip."""
    if static or n_frames == 1:
        return 0
    period = 2 * n_frames - 2
    j = i % period
    return j if j < n_frames else period - j


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class LipSyncPipeline:
    """``mesh`` (a ``s2v_torch.parallel.mesh.FrameMesh``, config
    ``parallel.infer_mesh``) splits the frame axis of every model stage's
    chunk over its data axis: each slice runs on a replica of the module on
    its device and the results are gathered on the first device, which is
    the pipeline's ``device``. Frames are independent through every model,
    so the output is the single-device run's. The two temporal stencils (the
    5-frame box smoothing, the coefficient windows) run over the whole clip
    on the first device before a stage splits its frames."""

    def __init__(self, cfg: PipelineConfig, models: PipelineModels, device=None, mesh=None):
        self.cfg = cfg
        self.models = models
        self.mesh = mesh
        self.device = mesh.first if mesh is not None else resolve_device(device)
        # ``models``, not ``self``: a cycle would keep dropped modules (``Net``)
        self.nets = stage_nets("pipeline", lambda name: getattr(models, name), mesh=mesh,
                               dtype=cfg.model.dtype, det_dtype=cfg.model.detector_dtype)
        for name in self.nets:
            if getattr(models, name) is not None:
                getattr(models, name).to(self.device).eval()

    def _map(self, fn, *xs):
        """``fn`` over the mesh's data axis (``map_frames``), or once."""
        return map_frames(fn, *xs, mesh=self.mesh)

    def _require(self, *names: str) -> None:
        missing = [n for n in names if getattr(self.models, n) is None]
        if missing:
            raise RuntimeError(f"the pipeline needs the models: {', '.join(missing)}")

    # ------------------------------------------------------------------
    # Step 1: detection + landmarks
    # ------------------------------------------------------------------

    def _detect(self, x: torch.Tensor):
        """x [B, 3, H, W] RGB 0..255 -> (boxes [B, 4], valid [B])."""
        outs = self.nets["s3fd"](x.flip(1) - constant_on(BGR_MEAN, x.device).view(1, 3, 1, 1))
        return best_boxes([(c.float(), r.float()) for c, r in outs])

    def _landmarks(self, x: torch.Tensor):
        """x [B, 3, H, W] RGB 0..255 -> (boxes, valid, landmarks [B, 68, 2])."""
        boxes, valid = self._detect(x)
        centers, scales = box_to_center_scale(boxes)
        hm = self.nets["fan"](crop_faces_batched(x, centers, scales))
        return boxes, valid, heatmaps_to_landmarks(hm.float(), centers, scales)

    @torch.no_grad()
    def _sweep(self, fn, frames, batch: int):
        """``fn`` over the frames [N, H, W, 3] uint8 in chunks of ``batch``,
        each chunk crossing to the device as it is needed; results joined on
        the host. On device OOM the batch is halved and the sweep restarts
        (the reference's face_detect back-off, inference_utils.py:110-128)."""
        n = len(frames)
        while True:
            try:
                with full_f32():
                    res = [self._map(fn, frames_to_nchw(frames[i:i + batch], self.device))
                           for i in range(0, n, batch)]
                break
            except torch.cuda.OutOfMemoryError:
                if batch == 1:
                    raise
                batch //= 2
                print(f"Recovering from OOM error; New batch size: {batch}")
        return [np.concatenate([_host(r[k]) for r in res]) for k in range(len(res[0]))]

    @staticmethod
    def _check_found(valid: np.ndarray) -> None:
        if not valid.all():
            # the reference raises on undetected faces (inference_utils.py:132-134)
            raise ValueError(f"Face not detected in frame {int(np.argmin(valid))}! Ensure "
                             "the video contains a face in all the frames.")

    def detect_boxes(self, frames_rgb, batch: int = 32) -> np.ndarray:
        """[N, H, W, 3] uint8 RGB (numpy or tensor) -> [N, 4] best face
        boxes (float, clipped at 0)."""
        self._require("s3fd")
        boxes, valid = self._sweep(self._detect, frames_rgb, batch)
        self._check_found(valid)
        return boxes

    @trace.span("step1.landmarks")
    def extract_landmarks(self, frames_rgb, batch: int = 32, return_boxes: bool = False):
        """[N, H, W, 3] uint8 RGB -> [N, 68, 2] landmarks (KeypointExtractor:
        S3FD box -> FAN heatmaps -> coordinates, one sweep). With
        ``return_boxes`` also the S3FD boxes, so Step 6 needs no second
        detection sweep."""
        self._require("s3fd", "fan")
        boxes, valid, lms = self._sweep(self._landmarks, frames_rgb, batch)
        self._check_found(valid)
        return (lms, boxes) if return_boxes else lms

    @trace.span("step1.ffhq_crop")
    @torch.no_grad()
    def ffhq_crop(self, frames_rgb, first_lm: np.ndarray, frames_dev=None,
                  device_out: bool = False):
        """Step-1 crop (facing.py:74-86): the first frame's FFHQ quad on
        every frame, resized to 256^2. ``frames_dev`` is the clip already
        on the device (else ``frames_rgb`` crosses); ``device_out`` keeps the
        crops there. Returns (frames_256 [N, 256, 256, 3] uint8,
        (oy1, oy2, ox1, ox2))."""
        h, w = frames_rgb.shape[1:3]
        crop, quad = ffhq_crop_box(np.asarray(first_lm, np.float64), (w, h), 512)
        clx, cly, crx, cry = crop
        lx, ly, rx, ry = [int(v) for v in quad]
        src = frames_rgb if frames_dev is None else frames_dev
        # the reference's double slice [cly:cry][ly:ry] in absolute bounds
        region = frames_to_nchw(src[:, cly + ly:min(cly + ry, cry), clx + lx:min(clx + rx, crx)],
                                self.device)
        out = torch.clamp(resize_bilinear(region, (256, 256)), 0, 255).to(torch.uint8)
        out = out.permute(0, 2, 3, 1)
        coords = (cly + ly, min(cly + ry, h), clx + lx, min(clx + rx, w))
        return (out if device_out else out.cpu().numpy()), coords

    # ------------------------------------------------------------------
    # Step 2: 3DMM coefficients
    # ------------------------------------------------------------------

    @trace.span("step2.coeffs")
    @torch.no_grad()
    def extract_coeffs(self, frames_256, lm: np.ndarray, batch: int = 32) -> np.ndarray:
        """facing.py:99-134: align each frame to 224^2 on the host, then
        ReconNet -> [N, 262]: 257 coefficients + 5 alignment parameters."""
        self._require("recon", "lm3d")
        lm3d = self.models.lm3d
        frames = _host(frames_256)
        n, h = len(frames), frames.shape[1]
        aligned = np.zeros((n, 224, 224, 3), np.uint8)
        trans_params = np.zeros((n, 5), np.float32)
        for i in range(n):
            lm_i = np.array(lm[i], copy=True)
            if np.mean(lm_i) == -1:  # no-face sentinel (facing.py:112-114)
                lm_i = (lm3d[:, :2] + 1) / 2.0
                lm_i = np.concatenate([lm_i[:, :1] * frames.shape[2], lm_i[:, 1:2] * h], 1)
            else:
                lm_i[:, -1] = h - 1 - lm_i[:, -1]
            trans_params[i], aligned[i], _ = align_img(frames[i], lm_i, lm3d)
        coeffs = []
        with full_f32():
            for i in range(0, n, batch):
                x = frames_to_nchw(aligned[i:i + batch], self.device) / 255.0
                coeffs.append(self._map(lambda c: self.nets["recon"](c).float(), x).cpu().numpy())
        return np.concatenate([np.concatenate(coeffs), trans_params], axis=1)

    # ------------------------------------------------------------------
    # Step 3: DNet stabilisation
    # ------------------------------------------------------------------

    def _stab_coeffs(self, semantic: torch.Tensor, one_shot: bool) -> torch.Tensor:
        """DNet's driving windows [N, 73, 26] (facing.py:135-198): the
        per-frame crop-norm ratio (the reference recomputes
        find_crop_norm_ratio with each frame as source: one [N, N] argmin
        here), or the first frame's with ``one_shot``; the expression rows
        overwritten with the template."""
        if one_shot:
            ratio = find_crop_norm_ratio(semantic[0:1], semantic)
        else:
            alpha = 0.3
            exp, ang = semantic[:, 80:144], semantic[:, 224:227]
            ed = (exp[None] - exp[:, None]).abs().mean(-1)
            ad = (ang[None] - ang[:, None]).abs().mean(-1)
            index = torch.argmin(alpha * ed + (1 - alpha) * ad, dim=1)
            ratio = semantic[:, -3] / semantic[index, -3]
        coeff = transform_semantic(semantic, ratio)
        expr = torch.as_tensor(np.asarray(self.models.expression), dtype=torch.float32,
                               device=semantic.device)
        coeff[:, :64, :] = expr[None, :, None]
        return coeff

    @trace.span("step3.stabilize")
    @torch.no_grad()
    def stabilize(self, frames_256, semantic: np.ndarray, batch: int = 16,
                  one_shot: bool = False, device_out: bool = False):
        """facing.py:135-198: per-frame coefficient windows, the expression
        overwrite, DNet -> stabilised 256^2 frames (uint8 RGB, numpy, or a
        device tensor with ``device_out``). ``frames_256`` may be on the
        device."""
        self._require("dnet", "expression")
        n = len(frames_256)
        sem = torch.as_tensor(np.asarray(semantic), dtype=torch.float32, device=self.device)
        coeff = self._stab_coeffs(sem, bool(one_shot))
        src = frames_256
        if one_shot:
            src = (np.repeat(src[:1], n, 0) if isinstance(src, np.ndarray)
                   else src[:1].expand(n, *src.shape[1:]))

        def run(img, co):
            fake = self.nets["dnet"](img, co)["fake_image"]
            return torch.clamp((fake.float() + 1.0) / 2.0 * 255.0, 0, 255).to(torch.uint8)

        out = []
        for i in range(0, n, batch):
            img = frames_to_nchw(src[i:i + batch], self.device) / 255.0 * 2.0 - 1.0
            out.append(self._map(run, img, coeff[i:i + batch]).permute(0, 2, 3, 1))
        out = torch.cat(out)
        return out if device_out else out.cpu().numpy()

    # ------------------------------------------------------------------
    # Step 5: reference enhancement
    # ------------------------------------------------------------------

    @trace.span("step5.enhance_reference")
    def enhance_reference(self, stabilized):
        """Step 5 (inference.py:234-238; the body of s2v_tpu's ``run``
        compute_enh): the ``ref_enhancer`` hook over the stabilised frames
        [N, 256, 256, 3] uint8 (numpy or a device tensor). Under config
        ``model.reuse_detections`` one S3FD + FAN sweep of those frames
        supplies the hook's 5-point landmarks and boxes, and its landmarks
        are returned for ``synthesize``'s ``lms_stab``. Returns (enhanced
        frames [N, 256, 256, 3] uint8 on the device, landmarks or None)."""
        self._require("ref_enhancer")
        if not self.cfg.model.reuse_detections:
            return self.models.ref_enhancer(stabilized), None
        lms, boxes = self.extract_landmarks(stabilized, return_boxes=True)
        enhanced = self.models.ref_enhancer(
            stabilized, landmarks5=lm68_to_lm5(lms).astype(np.float32), det_boxes=boxes)
        return enhanced, lms

    # ------------------------------------------------------------------
    # Step 6: synthesis
    # ------------------------------------------------------------------

    @torch.no_grad()
    def build_reference_faces(self, stabilized, full_frames, coordinates,
                              boxes: np.ndarray, lms: Optional[np.ndarray] = None
                              ) -> torch.Tensor:
        """datagen's reference construction (inference.py:341-367): re-align
        each stabilised face, paste it into the full frame through the
        inverse transform, cut the detector box. stabilized [N, 256, 256, 3]
        and full_frames [N, H, W, 3] uint8 (numpy or tensor); boxes [N, 4]
        x1y1x2y2; lms [N, 68, 2] of the stabilised frames, swept here when
        None. Returns [N, 3, img, img] float32 (0..255) on the device."""
        if lms is None:
            lms = self.extract_landmarks(stabilized)
        stab = frames_to_nchw(stabilized, self.device)
        full = frames_to_nchw(full_frames, self.device)
        oy1, oy2, ox1, ox2 = [int(v) for v in coordinates]
        img = self.cfg.model.img_size
        quad_mats, paste_mats = reference_face_transforms(np.asarray(lms))
        qm = torch.as_tensor(quad_mats, device=self.device)
        pm = torch.as_tensor(paste_mats, device=self.device)
        warp = affine_warp_shear if self.cfg.model.approx_warp else affine_warp
        crops = warp(stab, qm, (256, 256), inverse=True)
        region = full[:, :, oy1:oy2, ox1:ox2]
        region_256 = resize_bilinear(region, (256, 256))
        # RGB + coverage mask share one 4-channel paste warp
        packed = warp(torch.cat([crops, torch.ones_like(crops[:, :1])], 1),
                      pm, (256, 256), inverse=True)
        projected, mask = packed[:, :3], packed[:, 3:4]
        pasted = projected * mask + region_256 * (1 - mask)
        ff = full.clone()
        ff[:, :, oy1:oy2, ox1:ox2] = torch.clamp(
            resize_bilinear(pasted, region.shape[2:]), 0, 255)
        bx = torch.as_tensor(np.asarray(boxes, np.float32), device=self.device)
        return torch.clamp(crop_resize_boxes(ff, bx, (img, img)), 0, 255)

    @torch.no_grad()
    def _step6(self, frames: torch.Tensor, boxes: torch.Tensor,
               refs: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        """crop + lower-half mask + ENet + paste for one batch. frames
        [B, 3, H, W] and refs [B, 3, img, img] float 0..255; mel
        [B, 1, 80, 16]; split over the mesh's data axis when there is one.
        Under ``infer.without_rl1`` the prediction is kept
        only where the masked input is zero (the masked-out lower half, and
        any exact-0 subpixel of the upper half) and the original face, edited
        by the ``up_face_editor`` hook when there is one, is taken elsewhere
        (inference.py:269-286), before the paste. Returns [B, 3, H, W]
        uint8."""
        return self._map(self._step6_slice, frames, boxes, refs, mel)

    def _step6_slice(self, frames, boxes, refs, mel) -> torch.Tensor:
        img = self.cfg.model.img_size
        ofaces = crop_resize_boxes(frames, boxes, (img, img)) / 255.0
        masked = ofaces.clone()
        masked[:, :, img // 2:] = 0.0
        ref = refs / 255.0
        pred, _ = self.nets["enet"](mel, torch.cat([masked, ref], 1), ref)
        pred = torch.clamp(pred.float(), 0.0, 1.0)
        if self.cfg.infer.without_rl1:
            editor = self.models.up_face_editor
            cur = ofaces if editor is None else editor(ofaces)
            mask = (masked == 0).float()
            pred = pred * mask + cur * (1.0 - mask)
        return torch.clamp(paste_resize_boxes(frames, pred * 255.0, boxes),
                           0, 255).to(torch.uint8)

    @trace.span("step6.synthesize")
    @torch.no_grad()
    def synthesize(self, stabilized, mel: torch.Tensor, full_frames, coordinates,
                   fps: float, boxes_full: Optional[np.ndarray] = None,
                   lms_full: Optional[np.ndarray] = None,
                   lms_stab: Optional[np.ndarray] = None) -> np.ndarray:
        """Step 6 (inference.py:259-330). stabilized [N, 256, 256, 3] uint8;
        mel [80, T]; full_frames [N, H, W, 3] uint8; coordinates (oy1, oy2,
        ox1, ox2) of the FFHQ crop. boxes_full [N, 4] x1y1x2y2 are the Step-1
        boxes (detected here when None); lms_full the Step-1 landmarks, which
        the mouth tail and the final enhancer take under
        ``model.reuse_detections`` (else each runs its own RetinaFace pass);
        lms_stab the landmarks of
        ``stabilized`` (swept here when None). ``infer.box`` (top, bottom,
        left, right), clamped to the frame, replaces the boxes, their pads
        and smoothing. Returns [n_chunks, H', W', 3] uint8 with H' = 2H when
        the final enhancer runs, unless ``infer.cropped_image`` brings its
        output back to 1x and pastes only each frame's box into the
        original frame (inference.py:316-325)."""
        self._require("enet")
        cfg = self.cfg
        reuse = cfg.model.reuse_detections and lms_full is not None
        n_chunks = num_mel_chunks(mel.shape[1], fps)
        n_frames = min(len(stabilized), n_chunks)
        frames_t = full_frames[:n_frames]
        if not torch.is_tensor(frames_t):
            frames_t = np.ascontiguousarray(frames_t)
        chunks = mel_chunks_for_frames(mel.to(self.device).float(), n_chunks, fps)
        fh, fw = frames_t.shape[1:3]
        if cfg.infer.box[0] != -1:
            # a fixed box (--box, wav2lip's top bottom left right) bypasses
            # detection, the pads and the smoothing (s2v_tpu's clamp)
            by1, by2, bx1, bx2 = cfg.infer.box
            boxes = np.tile(np.asarray([max(bx1, 0), max(by1, 0), min(bx2, fw), min(by2, fh)],
                                       np.int64), (n_frames, 1))
        else:
            if boxes_full is None:
                # no Step-1 boxes supplied: the reference re-detects here
                # (inference.py:379 datagen)
                boxes_full = self.detect_boxes(frames_t)
            boxes = pad_and_smooth_boxes(np.asarray(boxes_full)[:n_frames], (fh, fw),
                                         pads=cfg.infer.pads, smooth=not cfg.infer.nosmooth)
        frames_dev = torch.as_tensor(frames_t, device=self.device)  # crosses once
        full = frames_to_nchw(frames_dev, self.device)
        with trace.span("step6.reference_faces"):
            refs = self.build_reference_faces(
                stabilized[:n_frames], frames_dev, coordinates, boxes,
                None if lms_stab is None else np.asarray(lms_stab)[:n_frames])
        lm5 = (lm68_to_lm5(np.asarray(lms_full)[:n_frames]).astype(np.float32)
               if reuse else None)
        boxes_dev = torch.as_tensor(boxes.astype(np.float32), device=self.device)
        lm5_dev = None if lm5 is None else torch.as_tensor(lm5, device=self.device)

        batch = cfg.infer.lnet_batch_size
        out = []
        for start in range(0, n_chunks, batch):
            # output i takes frame _frame_index(i) and, as the JAX package
            # does (s2v_tpu/pipeline/inference.py:779-782), the mel chunk at
            # that same index: past the clip's end the audio walks back with
            # the frames (a reference quirk the port keeps)
            idxs = [_frame_index(i, n_frames, cfg.infer.static)
                    for i in range(start, min(start + batch, n_chunks))]
            with trace.span("step6.lipsync"):
                ix = torch.as_tensor(idxs, device=self.device)
                pasted = self._step6(full[ix], boxes_dev[ix], refs[ix], chunks[ix][:, None])
                pasted = pasted.permute(0, 2, 3, 1)  # NHWC uint8
            if self.models.mouth_restorer is not None:
                # the boxes and landmarks already on the device: a host copy
                # here would wait for the card's queue
                kw = dict(landmarks5=lm5_dev[ix]) if reuse else {}
                with trace.span("step6.mouth_tail"):
                    pasted = self.models.mouth_restorer(pasted, boxes_dev[ix], **kw)
            if self.models.final_enhancer is not None:
                kw = dict(landmarks5=lm5[idxs], det_boxes=boxes[idxs]) if reuse else {}
                with trace.span("step6.final_stage"):
                    pasted = self.models.final_enhancer(pasted, boxes[idxs], **kw)
                    if cfg.infer.cropped_image:
                        pasted = self._box_over_original(pasted, full[ix], boxes[idxs])
            with trace.span("step6.to_host"):
                out.append(torch.as_tensor(pasted).cpu().numpy())
        return np.concatenate(out)

    @staticmethod
    def _box_over_original(final, frames: torch.Tensor, boxes: np.ndarray) -> torch.Tensor:
        """``--cropped_image``: the final stage's frames [B, sH, sW, 3] uint8
        resized bilinearly to the originals' size, and only each box (x1,
        y1, x2, y2, numpy's slices) pasted into the original frames [B, 3,
        H, W] (0..255). Returns [B, H, W, 3] uint8."""
        down = resize_bilinear(torch.as_tensor(final).permute(0, 3, 1, 2).float(),
                               frames.shape[2:])
        out = frames.clone()
        for k, (x1, y1, x2, y2) in enumerate(boxes.tolist()):
            out[k, :, y1:y2, x1:x2] = down[k, :, y1:y2, x1:x2]
        return torch.clamp(out, 0, 255).to(torch.uint8).permute(0, 2, 3, 1)

    # ------------------------------------------------------------------
    # Full run
    # ------------------------------------------------------------------

    @trace.span("infer.run")
    def run(self, face_path: str, audio_path: str, outfile: str) -> str:
        """The ``infer`` command (s2v_tpu's ``LipSyncPipeline.run``,
        reference inference.py main()): the clip file -> Steps 1-6 -> the
        output file muxed with the audio. Returns the output's path (an
        ``.npz`` beside ``outfile`` when there is no ffmpeg)."""
        cfg = self.cfg
        with trace.span("io.read_clip"):
            reader = VideoReader(face_path)
            frames = reader.read_all()
        fps = reader.fps or cfg.infer.fps
        cy1, cy2, cx1, cx2 = cfg.infer.crop  # --crop: top bottom left right
        if (cy1, cy2, cx1, cx2) != (0, -1, 0, -1):
            cy2 = frames.shape[1] if cy2 == -1 else cy2
            cx2 = frames.shape[2] if cx2 == -1 else cx2
            frames = frames[:, cy1:cy2, cx1:cx2]
        frames = np.ascontiguousarray(frames)

        # the per-video artifact cache for Steps 1-3 and 5 (the reference's
        # temp/<base>_{landmarks.txt,coeffs.npy,stablized.npy,enhanced5.npy},
        # facing.py:89-198): a second run of the clip goes straight to Step
        # 6; --re_preprocess recomputes. One version in every stage's key,
        # so fresh Step-1 outputs never meet stale downstream artifacts.
        base = os.path.splitext(os.path.basename(face_path))[0]
        cache = ArtifactCache(cfg.infer.tmp_dir)
        refresh = cfg.infer.re_preprocess
        crop_p = {"crop": cfg.infer.crop, "v": _CACHE_VERSION}

        # the clip crosses to the card once; the steps chain on tensors
        # there, and the host sees the cache's artifacts, the alignment's
        # inputs and the output frames
        frames_dev = torch.as_tensor(frames, device=self.device)
        dev: Dict[str, torch.Tensor] = {}

        step_lm = cache.get_or_compute(
            base, "landmarks",
            lambda: dict(zip(("lm", "boxes"),
                             self.extract_landmarks(frames_dev, return_boxes=True))),
            params=crop_p, refresh=refresh)
        lm, boxes_full = step_lm["lm"], step_lm["boxes"]

        def compute_ffhq():
            f256, coords = self.ffhq_crop(frames, lm[0], frames_dev=frames_dev,
                                          device_out=True)
            dev["f256"] = f256
            return {"frames": f256.cpu().numpy(), "coords": np.asarray(coords)}

        step1 = cache.get_or_compute(base, "ffhq", compute_ffhq, params=crop_p,
                                     refresh=refresh)
        frames_256 = step1["frames"]
        f256_dev = dev.get("f256")
        if f256_dev is None:  # a cache hit crosses once
            f256_dev = torch.as_tensor(frames_256, device=self.device)
        coordinates = tuple(int(v) for v in np.asarray(step1["coords"]))
        semantic = cache.get_or_compute(
            base, "coeffs",
            lambda: self.extract_coeffs(frames_256, self.extract_landmarks(f256_dev)),
            params=crop_p, refresh=refresh)

        def compute_stab():
            # a deferred write: the host copy starts now and the file is
            # written after Step 6, so the chain does not wait for it here
            dev["stab"] = self.stabilize(f256_dev, semantic, one_shot=cfg.infer.one_shot,
                                         device_out=True)
            return dev["stab"]

        stabilized = cache.get_or_compute(
            base, "stabilized", compute_stab,
            params={**crop_p, "one_shot": cfg.infer.one_shot, "exp_img": cfg.infer.exp_img},
            refresh=refresh, defer=True)
        stab_dev = dev.get("stab")
        if stab_dev is None:
            stab_dev = torch.as_tensor(stabilized, device=self.device)
        reuse = cfg.model.reuse_detections
        lm_stab = {}
        if self.models.ref_enhancer is not None:
            def compute_enh():
                enhanced, lm_stab["lm"] = self.enhance_reference(stab_dev)
                if torch.is_tensor(enhanced):
                    dev["enh"] = enhanced
                    return enhanced  # a deferred write, as compute_stab's
                return np.asarray(enhanced)

            stabilized = cache.get_or_compute(
                base, "enhanced5", compute_enh, params={**crop_p, "reuse_det": reuse},
                refresh=refresh, defer=True)
            stab_dev = dev.get("enh")
            if stab_dev is None:
                stab_dev = torch.as_tensor(stabilized, device=self.device)

        with trace.span("audio.mel"):
            wav = load_wav(audio_path, cfg.audio.sample_rate)
            mel = melspectrogram(torch.from_numpy(wav).to(self.device), cfg.audio)
            finite = bool(torch.isfinite(mel).all())
        if not finite:
            raise ValueError("Mel contains nan! Using a TTS voice? Add a small epsilon "
                             "noise to the wav file and try again")

        try:
            out = self.synthesize(stab_dev, mel, frames_dev, coordinates, fps,
                                  boxes_full=boxes_full, lms_full=lm if reuse else None,
                                  lms_stab=lm_stab.get("lm"))
        finally:
            # the deferred Step-3/5 writes: their copies overlapped Step 6,
            # and a failure in Step 6 keeps the finished artifacts too
            cache.flush()

        tmp_video = os.path.join(cfg.infer.tmp_dir, "result.npz")
        os.makedirs(cfg.infer.tmp_dir, exist_ok=True)
        with trace.span("io.write"):
            writer = VideoWriter(tmp_video, fps, out.shape[1:3])
            for f in out:
                writer.write(f)
            writer.close()
        with trace.span("io.mux"):
            return mux_audio(writer.path, audio_path, outfile)
