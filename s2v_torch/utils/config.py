"""Configuration read by the port's pipeline: the subset of
s2v_tpu/utils/config.py that the Step-6 + final-enhancement slice uses, as
frozen dataclasses with the same names, fields and defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Audio frontend constants (reference: futils/hparams.py:20-84)."""

    sample_rate: int = 16000
    n_fft: int = 800
    hop_size: int = 200
    win_size: int = 800
    num_mels: int = 80
    fmin: float = 55.0
    fmax: float = 7600.0
    preemphasis: float = 0.97
    preemphasize: bool = True
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 4.0
    symmetric_mels: bool = True
    signal_normalization: bool = True
    allow_clipping_in_normalization: bool = True

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    img_size: int = 384          # ENet working crop
    dtype: str = "bfloat16"      # compute dtype of the generators on the card
    # reuse the pipeline's 68-point landmark sweeps (mapped to 5 points) in
    # the final enhancer instead of a RetinaFace pass
    reuse_detections: bool = False


@dataclass(frozen=True)
class InferenceConfig:
    pads: Tuple[int, int, int, int] = (0, 20, 0, 0)
    lnet_batch_size: int = 16
    static: bool = False
    nosmooth: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    infer: InferenceConfig = field(default_factory=InferenceConfig)
