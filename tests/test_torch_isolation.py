"""The port stands alone: importing every s2v_torch module pulls in neither
jax nor s2v_tpu, its sources import Pillow only inside the few functions
that read or write image files (the card's machine has Pillow too, but
no inference path needs it), and its entry points refuse to run without a
card unless the caller asks for the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import s2v_torch

REPO = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(s2v_torch.__path__, "s2v_torch."))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _modules()
    assert "s2v_torch.pipeline.inference" in mods and "s2v_torch.ops.kernels" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 's2v_tpu', 'flax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_port_sources_import_pillow_only_for_the_jpeg_degradation():
    """Every import statement of the package, function-level ones included:
    Pillow appears only inside the training data chain's JPEG step, which
    ``jpeg_range=None`` skips, in the ArcFace data's JPEG decode and
    synthetic-pack writer, and in the face3d data preparation, which reads
    image folders and writes mask PNGs, and in the training artifacts'
    image grid (the inference path, the 3DMM alignment included, has
    none)."""
    found = []
    for path in (REPO / "s2v_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        owner = {id(n): fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
                 for n in ast.walk(fn)}  # an import's innermost function wins
        for n in ast.walk(tree):
            mods = ([a.name for a in n.names] if isinstance(n, ast.Import)
                    else [n.module or ""] if isinstance(n, ast.ImportFrom) else [])
            if any(m.split(".")[0] == "PIL" for m in mods):
                found.append((path.relative_to(REPO).as_posix(), owner.get(id(n))))
    assert set(found) == {("s2v_torch/prep/degradations.py", "add_jpg_compression"),
                          ("s2v_torch/train/arcface_data.py", "__getitem__"),
                          ("s2v_torch/train/arcface_data.py", "write_synthetic_pack"),
                          ("s2v_torch/prep/face3d_data.py", "prepare_dataset"),
                          ("s2v_torch/utils/artifacts.py", "image_grid")}, found


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "s2v_tpu", "flax")]


def test_entry_points_raise_without_a_card():
    code = ("import torch\n"
            "assert not torch.cuda.is_available()\n"
            "from s2v_torch.device import resolve_device\n"
            "for dev in (None, 'cuda'):\n"
            "    try:\n"
            "        resolve_device(dev)\n"
            "    except RuntimeError:\n"
            "        continue\n"
            "    raise SystemExit('ran without a card')\n"
            "assert resolve_device('cpu').type == 'cpu'\n"
            "import torch.nn as nn\n"
            "from s2v_torch.utils.export import export_program, load_exported\n"
            "blob = export_program(nn.Linear(2, 2), (torch.zeros(1, 2),))\n"
            "for dev in (None, 'cuda'):\n"
            "    try:\n"
            "        load_exported(blob, dev)\n"
            "    except RuntimeError:\n"
            "        continue\n"
            "    raise SystemExit('loaded an exported program without a card')\n"
            "assert load_exported(blob, 'cpu')(torch.ones(1, 2)).shape == (1, 2)\n")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def _bfm():
    import numpy as np

    from s2v_torch.models.bfm import FaceModelData, ParametricFaceModel

    z = np.zeros
    data = FaceModelData(z(9, np.float32), z((9, 80), np.float32), z((9, 64), np.float32),
                         z(9, np.float32), z((9, 80), np.float32), np.array([[0, 1, 2]]),
                         z((3, 8), np.int64), z(68, np.int64))
    return lambda device: ParametricFaceModel(data, device=device)


def _face3d_step():
    from s2v_torch.train.face3d_train import make_face3d_train_step

    face_model = _bfm()("cpu")
    return lambda device: make_face3d_train_step(face_model, device=device)


def _expression_trainer():
    from s2v_torch.models.ganimation import SplitGenerator
    from s2v_torch.train.ganimation_train import make_expression_trainer

    return lambda device: make_expression_trainer(SplitGenerator(ngf=4, n_blocks=1),
                                                  SplitGenerator(ngf=4, n_blocks=1),
                                                  device=device)


def _encodec_codec():
    from s2v_torch.models.encodec import EncodecCodec, EncodecModel

    model = EncodecModel(n_q=1)
    return lambda device: EncodecCodec(model, device=device)


def _audio_to_codes():
    import numpy as np

    from s2v_torch.models.encodec import EncodecCodec, EncodecModel
    from s2v_torch.prep.tools import audio_to_codes

    model = EncodecModel(n_q=1)
    wav = np.zeros(4800, np.float32)

    def make(device):  # called as a user would, with no codec, when no device is named
        codec = None if device is None else EncodecCodec(model, device=device)
        return audio_to_codes(wav, 24000, 2, 25.0, codec=codec)

    return make


@pytest.mark.parametrize("build", [_bfm, _face3d_step, _expression_trainer, _encodec_codec,
                                   _audio_to_codes],
                         ids=["bfm", "face3d_step", "expression_trainer", "encodec_codec",
                              "audio_to_codes"])
def test_face3d_expression_and_codec_entry_points_refuse_to_run_without_a_card(build):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    make = build()
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(dev)
    make("cpu")
