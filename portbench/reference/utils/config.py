"""The port's configuration tree: s2v_tpu/utils/config.py's frozen
dataclasses with the same names, fields and defaults, and its overlay
helpers (dotted-key overrides, CLI flags, .json/.py/.yml files). The
reference's five config systems (argparse options in
futils/inference_utils.py:16-51, HParams in futils/hparams.py, OmegaConf,
face3d's and arcface's options) map onto this one tree. PyYAML is imported
only for a .yml file.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Optional, Tuple


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
    rescale: bool = True
    rescaling_max: float = 0.9

    # per-frame conditioning window (reference: inference.py:209)
    mel_step_size: int = 16

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    """Generator stack geometry (reference: models/{LNet,ENet,DNet}.py)."""

    img_size: int = 384          # ENet working crop (inference_utils.py:32)
    lnet_size: int = 96          # LNet generator resolution (ENet.py:104)
    dnet_size: int = 256         # DNet stabilization resolution (facing.py:86)
    num_style_feat: int = 512
    coeff_window: int = 26       # 3DMM temporal context: range(i-13, i+13),
                                 # 26 frames (inference_utils.py:73-76)
    coeff_nc: int = 73           # 70 coeffs + 3 trans params fed to MappingNet
    dtype: str = "bfloat16"      # compute dtype of the generators on the card
    param_dtype: str = "float32"
    # Compute dtype of the detection and landmark convs (S3FD, FAN and
    # RetinaFace; ParseNet in the mouth tail too, as s2v_tpu's cli sets
    # it). bfloat16 runs them under bf16 autocast; box, landmark and anchor
    # decodes stay float32.
    detector_dtype: str = "float32"
    # ParseNet working resolution in the enhancement and restoration
    # stages; 512 is the reference geometry (face_parsing.py).
    parse_size: int = 512
    # s2v_tpu's approximate sheared warps (``ops.warp.affine_warp_shear``)
    # for the similarity warps of Step 5, the mouth tail, the final stage
    # and the reference faces; False keeps the exact ``affine_warp``.
    approx_warp: bool = False
    # Reuse the pipeline's 68-point landmark sweeps (mapped to 5 points)
    # instead of RetinaFace passes: one sweep of the stabilised frames feeds
    # Step 5's enhancer and the reference faces, and the Step-1 landmarks
    # feed the mouth tail and the final enhancer. The reference re-detects
    # at each of those points (face_enhancement.py:91, gfpgan/utils.py:97,
    # inference.py:348), so False is the default.
    reuse_detections: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """Device mesh layout (s2v_tpu's). DP = frame axis; MP = class/tensor axis."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1      # -1: all devices
    model_parallel: int = 1
    # frame-sharded inference: every stage's chunks split over the mesh's
    # data axis (portbench.reference.cli.build_mesh)
    infer_mesh: bool = False


@dataclass(frozen=True)
class InferenceConfig:
    """Pipeline flags (reference: futils/inference_utils.py:16-51)."""

    face: str = ""
    audio: str = ""
    outfile: str = "results/output.mp4"
    exp_img: str = "neutral"     # 'neutral' | 'smile' | image path
    up_face: str = "original"    # 'original' | 'sad' | 'angry' | 'surprise'
    fps: float = 25.0
    pads: Tuple[int, int, int, int] = (0, 20, 0, 0)
    face_det_batch_size: int = 4
    lnet_batch_size: int = 16
    static: bool = False
    box: Tuple[int, int, int, int] = (-1, -1, -1, -1)
    crop: Tuple[int, int, int, int] = (0, -1, 0, -1)
    nosmooth: bool = False
    one_shot: bool = False
    without_rl1: bool = False  # store_true flag; off by default (options():45)
    cropped_image: bool = False
    re_preprocess: bool = False
    tmp_dir: str = "temp"
    checkpoint_dir: str = "checkpoints"


@dataclass(frozen=True)
class TrainConfig:
    """Fine-tuning loop (reference: training.py:189-471)."""

    lr: float = 1e-2
    epochs: int = 10
    batch_size: int = 16
    l1_weight: float = 1.0
    perceptual_weight: float = 0.01
    id_weight: float = 0.1
    checkpoint_every: int = 1
    seed: int = 0


@dataclass(frozen=True)
class PipelineConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    infer: InferenceConfig = field(default_factory=InferenceConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _coerce(ftype: Any, value: Any) -> Any:
    if value is None:
        return None
    # `from __future__ import annotations` makes dataclass field types
    # strings — resolve the common scalar names
    if isinstance(ftype, str):
        base = ftype.split("[")[0]
        ftype = {"int": int, "float": float, "str": str, "bool": bool,
                 "Tuple": tuple, "tuple": tuple}.get(base, ftype)
    origin = getattr(ftype, "__origin__", None)
    if origin in (tuple, Tuple) or ftype is tuple:
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
            value = [int(v) if v.lstrip("-").isdigit() else float(v)
                     for v in value]
        return tuple(value)
    if ftype is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if ftype in (int, float, str):
        return ftype(float(value)) if ftype is int and isinstance(value, str) \
            and "." in value else ftype(value)
    return value


def override(cfg: Any, overrides: dict) -> Any:
    """Return a copy of a (nested) frozen dataclass with dotted-key overrides.
    A key that names no field raises ValueError (s2v_tpu's ``override``
    drops it silently, so a misspelt flag there changes nothing).

    >>> override(PipelineConfig(), {"audio.num_mels": 80, "infer.fps": 30})
    """
    updates: dict = {}
    nested: dict = {}
    names = {f.name for f in fields(cfg)}
    for key, value in overrides.items():
        head, _, rest = key.partition(".")
        if head not in names or bool(rest) != is_dataclass(getattr(cfg, head)):
            raise ValueError(f"unknown config key {key!r} in {type(cfg).__name__}")
        if rest:
            nested.setdefault(head, {})[rest] = value
        else:
            updates[head] = value

    kwargs = {}
    for f in fields(cfg):
        if f.name in nested:
            kwargs[f.name] = override(getattr(cfg, f.name), nested[f.name])
        elif f.name in updates:
            kwargs[f.name] = _coerce(f.type, updates[f.name])
    return dataclasses.replace(cfg, **kwargs)


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)


def from_cli(argv: Optional[list] = None) -> PipelineConfig:
    """Parse ``--key.path value`` CLI overrides onto the default config."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            key = arg[2:]
            if "=" in key:
                key, value = key.split("=", 1)
                i += 1
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                value = argv[i + 1]
                i += 2
            else:
                value = "true"
                i += 1
            overrides[key] = value
        else:
            i += 1
    return override(PipelineConfig(), overrides)


def _flatten(prefix: str, node) -> dict:
    out = {}
    for k, v in node.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(key, v))
        else:
            out[key] = v
    return out


def load_config_file(path: str, base: Any = None) -> Any:
    """Config-file overlay — the analogue of the reference's five config
    systems (arcface py-file configs via utils_config.get_config, emb
    OmegaConf YAML, face3d argparse options, GFPGAN basicsr YAML, GPEN
    argparse): nested YAML/JSON (or a .py file defining ``config = {...}``)
    flattened to dotted keys and applied over the dataclass tree."""
    import json
    import os
    import runpy

    base = base if base is not None else PipelineConfig()
    ext = os.path.splitext(path)[1].lower()
    if ext == ".py":
        ns = runpy.run_path(path)
        if "config" not in ns:
            raise ValueError(f"{path} must define a dict named `config`")
        data = ns["config"]
    elif ext in (".yml", ".yaml"):
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
    elif ext == ".json":
        with open(path) as f:
            data = json.load(f)
    else:
        raise ValueError(f"unsupported config extension {ext!r} "
                         "(use .yml/.yaml/.json/.py)")
    if not isinstance(data, dict):
        raise ValueError(f"{path} must contain a mapping at the top level")
    def norm(v):
        if isinstance(v, (list, tuple)):  # YAML/JSON lists -> tuple fields
            return ",".join(str(x) for x in v)
        return v if isinstance(v, str) else repr(v)

    flat = {k: norm(v) for k, v in _flatten("", data).items()}
    return override(base, flat)
