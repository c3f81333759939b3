"""Fine-tuning batches from the pipeline's artifacts (reference:
training.py:408-470, batches from the inference datagen; s2v_tpu/train/
data.py).

``build_enet_batches`` assembles ENet's (mel, face, ref, target) batches:
the lower-half-masked original crop beside the re-aligned reference on the
channels, the original crop as the target.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from s2v_torch.audio.melspec import mel_chunks_for_frames, num_mel_chunks
from s2v_torch.models.s3fd import pad_and_smooth_boxes
from s2v_torch.ops.image import frames_to_nchw
from s2v_torch.ops.warp import crop_resize_boxes


def build_enet_batches(
    pipeline,                 # LipSyncPipeline
    stabilized,               # [N, 256, 256, 3] uint8: DNet's stabilised frames
    mel: torch.Tensor,        # [80, T]
    full_frames,              # [N, H, W, 3] uint8
    coordinates,              # the FFHQ crop's (oy1, oy2, ox1, ox2)
    fps: float,
    batch_size: int = 16,
    img_size: int = 384,
) -> List[Dict[str, np.ndarray]]:
    """training.py's datagen batches for ``finetune``, numpy in the JAX
    layout: mel [B, 80, 16, 1], face [B, img, img, 6] (masked | ref), ref
    and target [B, img, img, 3], in [0, 1]. The boxes are S3FD's on the
    full frames, padded and smoothed as inference pads them. The ``train``
    command passes the stabilised frames, as s2v_tpu's does (its docstring
    says Step-5-enhanced)."""
    n_chunks = num_mel_chunks(mel.shape[1], fps)
    n = min(len(stabilized), n_chunks, len(full_frames))
    chunks = mel_chunks_for_frames(mel, n_chunks, fps)[:n].cpu().numpy()

    boxes = pipeline.detect_boxes(full_frames[:n])
    boxes = pad_and_smooth_boxes(boxes, full_frames.shape[1:3]).astype(np.int32)
    refs = pipeline.build_reference_faces(stabilized[:n], full_frames[:n], coordinates, boxes)
    full = frames_to_nchw(full_frames[:n], pipeline.device)
    ofaces = crop_resize_boxes(full, torch.as_tensor(boxes, device=pipeline.device),
                               (img_size, img_size)) / 255.0
    ofaces = ofaces.permute(0, 2, 3, 1).cpu().numpy()
    refs = (refs / 255.0).permute(0, 2, 3, 1).cpu().numpy()
    masked = ofaces.copy()
    masked[:, img_size // 2:] = 0
    faces = np.concatenate([masked, refs], axis=-1)

    return [{"mel": chunks[s:s + batch_size][..., None], "face": faces[s:s + batch_size],
             "ref": refs[s:s + batch_size], "target": ofaces[s:s + batch_size]}
            for s in range(0, n, batch_size)]
