"""The Step-6 restoration hooks (reference: inference.py:250-312; s2v_tpu/
pipeline/restoration.py): the mouth tail, in which GFPGAN restores the face,
ParseNet finds the mouth on the face box and a 10-level Laplacian blend at
512^2 puts the restored mouth over the frame; and the GANimation upper-face
editor of ``--up_face``.

``GFPGANRestorer`` is GFPGANer.enhance(has_aligned=False,
only_center_face=True, paste_back=True) (GFPGAN/gfpgan/utils.py:97-143),
batched: RetinaFace finds the best face, a closed-form umeyama similarity
maps its 5 landmarks to the facexlib 512^2 template, the frame is warped to
the template crop, GFPGAN restores it (bf16 autocast on the card) and one
4-channel inverse warp pastes it back with its coverage. A frame whose face
scores under ``threshold`` keeps its pixels. Supplied landmarks (config
``model.reuse_detections``) replace the detector, and every frame is then
valid. GFPGAN is either arch: GFPGANv1Clean (GFPGANv1.3/1.4) or the
original GFPGANv1 (GFPGANv1.pth, on the K1/K3 kernels), whose tuple output
gives its image first.

s2v_tpu's options: ``det_dtype`` (config ``model.detector_dtype``) runs
the convs of RetinaFace and of the tail's ParseNet in bf16 (the decodes stay
f32); ``approx_warp`` takes ``affine_warp_shear`` for both warps.

``make_mouth_restorer`` adds the mouth blend and returns the pipeline's
``mouth_restorer`` hook (the port's ``make_up_face_editor``, GANimation's
``up_face_editor`` hook, is not copied: no cell runs it). Public layout as s2v_tpu: NHWC uint8 frames, x1y1x2y2 boxes, [N, 5, 2]
landmarks in frame pixels; inside, NCHW float tensors on the device, where
the valid flags stay (nothing synchronises).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from portbench.reference.device import bf16_autocast, full_f32, resolve_device
from portbench.reference.models.parsenet import MOUTH_COLORMAP, parse_mask
from portbench.reference.models.retinaface import RETINA_MEAN, detect_faces
from portbench.reference.ops.image import frames_to_nchw, resize_bilinear
from portbench.reference.ops.warp import (affine_warp, affine_warp_shear, crop_resize_boxes,
                                paste_resize_boxes)
from portbench.reference.pipeline.enhance import _to_u8, umeyama_similarity_batched
from portbench.reference.pipeline.utils import laplacian_pyramid_blend

# facexlib FaceRestoreHelper's 512^2 face template
FACEXLIB_TEMPLATE_512 = np.array(
    [[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
     [201.26117, 371.41043], [313.08905, 371.15118]], np.float32)


@functools.lru_cache(maxsize=None)
def _retina_mean_on(device: torch.device) -> torch.Tensor:
    """RetinaFace's BGR means on ``device``, copied there once (a copy from
    the host at every call synchronises with the card's queue)."""
    return torch.tensor(RETINA_MEAN, device=device).view(1, 3, 1, 1)


def _f32_on(x, device: torch.device) -> torch.Tensor:
    """Boxes or landmarks (numpy, or a tensor already on ``device``, which is
    not copied) as an f32 tensor on ``device``."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x, np.float32),
                           dtype=torch.float32, device=device)


class GFPGANRestorer:
    """GFPGANer, with the surface of s2v_tpu's (``models``, ``chunk``,
    ``enhance_batch``, ``enhance``).

    models: 'gfpgan' (GFPGANv1Clean or GFPGANv1; the template crop is its
    ``out_size``, 512 in the reference, gfpgan/utils.py:76-82) and
    'retinaface' (may be left out when every call supplies ``landmarks5``).
    ``dtype`` is GFPGAN's compute dtype on the card (autocast);
    ``det_dtype`` RetinaFace's (bfloat16: autocast on any device, as
    s2v_tpu casts its input); ``approx_warp`` takes the sheared warps."""

    threshold = 0.9  # GFPGANer's face score threshold

    def __init__(self, models: dict, chunk: int = 16, dtype: str = "bfloat16",
                 approx_warp: bool = False, det_dtype: str = "float32", device=None):
        self.device = resolve_device(device)
        self.models = {k: m.to(self.device).eval() for k, m in models.items() if m is not None}
        if "gfpgan" not in self.models:
            raise ValueError("GFPGANRestorer needs a 'gfpgan' model")
        self.chunk = chunk
        self.size = 2 ** self.models["gfpgan"].log_size
        self.template = torch.from_numpy(FACEXLIB_TEMPLATE_512 * (self.size / 512.0)).to(
            self.device)
        self.amp = dtype == "bfloat16" and self.device.type == "cuda"
        self.det_dtype = det_dtype
        self.warp = affine_warp_shear if approx_warp else affine_warp

    def _model(self, name: str, x: torch.Tensor) -> torch.nn.Module:
        """The model ``name``."""
        return self.models[name]

    @torch.no_grad()
    def _detect(self, x: torch.Tensor):
        """RetinaFace on frames [k, 3, H, W] RGB 0..255, full f32 or bf16
        convs (``det_dtype``), the decode in f32: (boxes [k, 4], landmarks
        [k, 5, 2], valid [k])."""
        if "retinaface" not in self.models:
            raise ValueError("GFPGANRestorer needs a 'retinaface' model unless landmarks5 "
                             "are supplied")
        with full_f32(), bf16_autocast(x.device, self.det_dtype):
            outs = self._model("retinaface", x)(x.flip(1) - _retina_mean_on(x.device))
        return detect_faces(tuple(o.float() for o in outs), x.shape[2:], self.threshold)

    @torch.no_grad()
    def _restore_paste(self, x: torch.Tensor, landms: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Align frames [k, 3, H, W] (0..255) by their 5 landmarks to the
        template crop, restore it with GFPGAN and paste it back; frames not
        ``valid`` keep their pixels. Returns [k, 3, H, W] uint8."""
        s = self.size
        tfms, _ = umeyama_similarity_batched(landms, self.template.to(x.device))  # frame -> crop
        face = self.warp(x, tfms, (s, s))
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.amp):
            out = self._model("gfpgan", face)((face / 255.0 - 0.5) / 0.5)
        if isinstance(out, tuple):  # GFPGANv1: (image, the U-Net's RGB heads)
            out = out[0]
        restored = torch.clamp((out.float() + 1.0) / 2.0, 0.0, 1.0) * 255.0
        # the frame -> crop map with inverse=True is the paste warp; RGB and
        # the coverage mask share one 4-channel warp
        packed = self.warp(torch.cat([restored, torch.ones_like(restored[:, :1])], 1), tfms,
                           x.shape[2:], inverse=True)
        pasted, mask = packed[:, :3], packed[:, 3:4]
        out = pasted * mask + x * (1.0 - mask)
        if valid is not None:
            out = torch.where(valid[:, None, None, None], out, x)
        return _to_u8(out)

    def restore(self, x: torch.Tensor, landmarks5=None) -> torch.Tensor:
        """One chunk, frames [k, 3, H, W] float (uint8 values) on the device:
        detect unless ``landmarks5`` are given, then restore and paste."""
        if landmarks5 is None:
            _, landms, valid = self._detect(x)
            return self._restore_paste(x, landms, valid)
        return self._restore_paste(x, _f32_on(landmarks5, x.device))

    def enhance_batch(self, frames, landmarks5=None) -> torch.Tensor:
        """[N, H, W, 3] frames (numpy or tensor, 0..255) -> restored [N, H, W,
        3] uint8 on the device, in chunks of ``chunk``."""
        x = _to_u8(frames_to_nchw(frames, self.device)).float()
        lms = None if landmarks5 is None else _f32_on(landmarks5, self.device)
        out = [self.restore(x[i:i + self.chunk], None if lms is None else lms[i:i + self.chunk])
               for i in range(0, len(x), self.chunk)]
        return torch.cat(out).permute(0, 2, 3, 1)

    def enhance(self, frame) -> torch.Tensor:
        """One [H, W, 3] frame (gfpgan/utils.py:97-143 with paste_back)."""
        return self.enhance_batch(frame[None])[0]


class MouthRestorer:
    """The pipeline's ``mouth_restorer`` hook (inference.py:299-312), batched:
    GFPGAN restore, ParseNet's mouth mask on the face box (f32, at
    ``parse_size``; bf16 convs when the restorer's ``det_dtype`` is
    bfloat16, as s2v_tpu's cli sets both from ``model.detector_dtype``), the
    10-level Laplacian blend at 512^2 of the restored frame over the
    input."""

    def __init__(self, restorer: GFPGANRestorer, parsenet: torch.nn.Module,
                 parse_size: int = 512):
        self.restorer = restorer
        self.device = restorer.device
        self.parsenet = parsenet.to(self.device).eval()
        self.parse_size = int(parse_size)

    @torch.no_grad()
    def _blend(self, restored: torch.Tensor, frames: torch.Tensor,
               boxes: torch.Tensor) -> torch.Tensor:
        """restored and frames [k, 3, H, W] 0..255, boxes [k, 4] x1y1x2y2:
        ParseNet's mouth mask of the restored face box (inference.py:304-308)
        pasted into a zero canvas, then the blend of the restored frame over
        the input (inference.py:310-312). Returns [k, 3, H, W] uint8."""
        ps = self.parse_size
        k, _, h, w = frames.shape
        crop = crop_resize_boxes(restored, boxes, (ps, ps))
        with full_f32(), bf16_autocast(crop.device, self.restorer.det_dtype):
            logits, _ = self.parsenet(crop / 255.0 * 2.0 - 1.0)
        mm = parse_mask(logits.float(), MOUTH_COLORMAP)[:, None] / 255.0
        mouth = paste_resize_boxes(frames.new_zeros(k, 1, h, w), mm, boxes)
        blended = laplacian_pyramid_blend(resize_bilinear(restored, (512, 512)),
                                          resize_bilinear(frames, (512, 512)),
                                          resize_bilinear(mouth, (512, 512)), num_levels=10)
        return _to_u8(resize_bilinear(torch.clamp(blended, 0.0, 255.0), (h, w)))

    def __call__(self, frames, boxes, landmarks5=None) -> torch.Tensor:
        """frames [B, H, W, 3] 0..255 (numpy or tensor); boxes [B, 4]
        x1y1x2y2; ``landmarks5`` [B, 5, 2] (frame pixels, RetinaFace's point
        order) skip the tail's RetinaFace pass. Returns [B, H, W, 3] uint8 on
        the device."""
        dev = self.device
        x = _to_u8(frames_to_nchw(frames, dev)).float()
        bx = _f32_on(boxes, dev)
        lms = None if landmarks5 is None else _f32_on(landmarks5, dev)
        k = self.restorer.chunk
        out = []
        for i in range(0, len(x), k):
            c = x[i:i + k]
            lm = None if lms is None else lms[i:i + k]
            out.append(self._blend(self.restorer.restore(c, lm).float(), c, bx[i:i + k]))
        return torch.cat(out).permute(0, 2, 3, 1)


def make_mouth_restorer(models: dict, chunk: int = 16, parse_size: int = 512,
                        dtype: str = "bfloat16", approx_warp: bool = False,
                        det_dtype: str = "float32", device=None) -> Optional[MouthRestorer]:
    """The reference's Step-6 tail (inference.py:299-312). models needs
    'retinaface', 'gfpgan' (GFPGANv1Clean or GFPGANv1) and 'parsenet';
    returns None unless all three are given (as s2v_tpu's cli builds the
    hook only then). ``det_dtype`` sets both RetinaFace's and ParseNet's
    convs, as s2v_tpu's cli sets both from ``model.detector_dtype``."""
    if not all(models.get(k) is not None for k in ("retinaface", "gfpgan", "parsenet")):
        return None
    restorer = GFPGANRestorer({k: models[k] for k in ("retinaface", "gfpgan")}, chunk=chunk,
                              dtype=dtype, approx_warp=approx_warp, det_dtype=det_dtype,
                              device=device)
    return MouthRestorer(restorer, models["parsenet"], parse_size)
