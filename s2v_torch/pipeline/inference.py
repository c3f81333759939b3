"""Step 6 of the lip-sync pipeline on the card: ENet synthesis, paste-back
and the final full-frame enhancement (reference: inference.py:259-330;
s2v_tpu/pipeline/inference.py ``LipSyncPipeline.synthesize``).

The port's slice of ``synthesize`` runs with detections reused
(config ``model.reuse_detections``): the caller supplies what Steps 1-3
produce — the stabilised 256^2 frames, the FFHQ crop ``coordinates``, the
Step-1 boxes and 68-point landmarks of the full and the stabilised frames —
and optional hooks: ``final_enhancer`` (GPEN-BFR-2048 + RealESRNet x2,
``s2v_torch.pipeline.enhance``). The detectors, DNet, Step 5, the mouth
restorer and the I/O around them are not ported yet.

Public layout as s2v_tpu: NHWC uint8 frames, x1y1x2y2 boxes, [N, 68, 2]
landmarks. Frames cross to the device once; intermediates stay there as
NCHW float tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from s2v_torch.audio.melspec import mel_chunks_for_frames, num_mel_chunks
from s2v_torch.device import resolve_device
from s2v_torch.models.fan import lm68_to_lm5
from s2v_torch.models.s3fd import pad_and_smooth_boxes
from s2v_torch.ops.image import frames_to_nchw, resize_bilinear
from s2v_torch.ops.warp import affine_warp, crop_resize_boxes, paste_resize_boxes
from s2v_torch.pipeline.align import compute_transform, crop_quad_params, quad_from_cxy
from s2v_torch.utils.config import PipelineConfig


@dataclass
class PipelineModels:
    """Loaded modules per stage; None disables the stage.

    final_enhancer(frames [B, H, W, 3] uint8, boxes [B, 4] x1y1x2y2,
    landmarks5=[B, 5, 2], det_boxes=[B, 4]) -> [B, 2H, 2W, 3] uint8.
    """

    enet: Optional[torch.nn.Module] = None
    final_enhancer: Optional[Callable] = None


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


class LipSyncPipeline:
    def __init__(self, cfg: PipelineConfig, models: PipelineModels, device=None):
        self.cfg = cfg
        self.models = models
        self.device = resolve_device(device)
        if models.enet is not None:
            models.enet.to(self.device).eval()
        self.amp = cfg.model.dtype == "bfloat16" and self.device.type == "cuda"

    @torch.no_grad()
    def build_reference_faces(self, stabilized, full_frames, coordinates,
                              boxes: np.ndarray, lms: np.ndarray) -> torch.Tensor:
        """datagen's reference construction (inference.py:341-367): re-align
        each stabilised face, paste it into the full frame through the
        inverse transform, cut the detector box. stabilized [N, 256, 256, 3]
        and full_frames [N, H, W, 3] uint8 (numpy or tensor); boxes [N, 4]
        x1y1x2y2; lms [N, 68, 2] of the stabilised frames. Returns
        [N, 3, img, img] float32 (0..255) on the device."""
        stab = frames_to_nchw(stabilized, self.device)
        full = frames_to_nchw(full_frames, self.device)
        oy1, oy2, ox1, ox2 = [int(v) for v in coordinates]
        img = self.cfg.model.img_size
        quad_mats, paste_mats = reference_face_transforms(np.asarray(lms))
        qm = torch.as_tensor(quad_mats, device=self.device)
        pm = torch.as_tensor(paste_mats, device=self.device)
        crops = affine_warp(stab, qm, (256, 256), inverse=True)
        region = full[:, :, oy1:oy2, ox1:ox2]
        region_256 = resize_bilinear(region, (256, 256))
        # RGB + coverage mask share one 4-channel paste warp
        packed = affine_warp(torch.cat([crops, torch.ones_like(crops[:, :1])], 1),
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
        [B, 1, 80, 16]. Returns [B, 3, H, W] uint8."""
        img = self.cfg.model.img_size
        ofaces = crop_resize_boxes(frames, boxes, (img, img)) / 255.0
        masked = ofaces.clone()
        masked[:, :, img // 2:] = 0.0
        ref = refs / 255.0
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.amp):
            pred, _ = self.models.enet(mel, torch.cat([masked, ref], 1), ref)
        pred = torch.clamp(pred.float(), 0.0, 1.0)
        return torch.clamp(paste_resize_boxes(frames, pred * 255.0, boxes),
                           0, 255).to(torch.uint8)

    @torch.no_grad()
    def synthesize(self, stabilized, mel: torch.Tensor, full_frames, coordinates,
                   fps: float, boxes_full: np.ndarray, lms_full: np.ndarray,
                   lms_stab: np.ndarray) -> np.ndarray:
        """Step 6 with detections reused. stabilized [N, 256, 256, 3] uint8;
        mel [80, T]; full_frames [N, H, W, 3] uint8; coordinates (oy1, oy2,
        ox1, ox2) of the FFHQ crop; boxes_full [N, 4] x1y1x2y2; lms_full and
        lms_stab [N, 68, 2]. Returns [n_chunks, H', W', 3] uint8 with H' = 2H
        when the final enhancer runs."""
        if self.models.enet is None:
            raise RuntimeError("synthesize needs the ENet model")
        if not self.cfg.model.reuse_detections:
            raise NotImplementedError(
                "the port runs Step 6 with model.reuse_detections: the "
                "detectors are not ported yet")
        cfg = self.cfg
        n_chunks = num_mel_chunks(mel.shape[1], fps)
        n_frames = min(len(stabilized), n_chunks)
        frames_t = np.ascontiguousarray(np.asarray(full_frames)[:n_frames])
        chunks = mel_chunks_for_frames(mel.to(self.device).float(), n_chunks, fps)
        boxes = pad_and_smooth_boxes(np.asarray(boxes_full)[:n_frames],
                                     frames_t.shape[1:3], pads=cfg.infer.pads,
                                     smooth=not cfg.infer.nosmooth)
        frames_dev = torch.as_tensor(frames_t, device=self.device)  # crosses once
        full = frames_to_nchw(frames_dev, self.device)
        refs = self.build_reference_faces(np.asarray(stabilized)[:n_frames], frames_dev,
                                          coordinates, boxes,
                                          np.asarray(lms_stab)[:n_frames])
        lm5 = lm68_to_lm5(np.asarray(lms_full)[:n_frames]).astype(np.float32)
        boxes_dev = torch.as_tensor(boxes.astype(np.float32), device=self.device)

        batch = cfg.infer.lnet_batch_size
        out = []
        for start in range(0, n_chunks, batch):
            # output i takes frame _frame_index(i) and, as the JAX package
            # does (s2v_tpu/pipeline/inference.py:779-782), the mel chunk at
            # that same index: past the clip's end the audio walks back with
            # the frames (a reference quirk the port keeps)
            idxs = [_frame_index(i, n_frames, cfg.infer.static)
                    for i in range(start, min(start + batch, n_chunks))]
            ix = torch.as_tensor(idxs, device=self.device)
            pasted = self._step6(full[ix], boxes_dev[ix], refs[ix], chunks[ix][:, None])
            pasted = pasted.permute(0, 2, 3, 1)  # NHWC uint8
            if self.models.final_enhancer is not None:
                pasted = self.models.final_enhancer(
                    pasted, boxes[idxs], landmarks5=lm5[idxs], det_boxes=boxes[idxs])
            out.append(torch.as_tensor(pasted).cpu().numpy())
        return np.concatenate(out)
