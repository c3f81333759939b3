"""The port's config tree and flag parsing against s2v_tpu's: the same
dataclasses, fields and defaults; ``parse_args`` (s2v_torch.cli) and
``load_config_file`` give the same tree, compared through ``to_dict``.
Unknown flags exit in both packages; a dotted key that names no field
raises in the port (s2v_tpu drops it silently)."""

import json

import pytest

from s2v_torch import cli as t_cli
from s2v_torch.utils import config as t_cfg
from s2v_tpu import cli as j_cli
from s2v_tpu.utils import config as j_cfg

FLAG_SETS = {
    "defaults": [],
    "flat_and_dotted": ["--face", "a.mp4", "--fps", "30", "--train.epochs", "3", "--static"],
    "tuples": ["--box", "-1", "-1", "-1", "-1", "--pads", "0", "10", "0", "0",
               "--crop", "4", "-1", "4", "-1"],
    "equals_and_alias": ["--outfile=o.npz", "--LNet_batch_size", "8", "--tmp_dir", "t",
                         "--re_preprocess", "--one_shot", "--nosmooth"],
    "every_section": ["--audio.num_mels", "64", "--audio.rescale", "false",
                      "--model.dtype", "float32", "--model.parse_size", "256",
                      "--model.reuse_detections", "true", "--parallel.data_parallel", "2",
                      "--infer.exp_img", "smile", "--train.lr", "0.5", "--train.seed", "7"],
}


def test_dataclasses_match_jax():
    for name in ("AudioConfig", "ModelConfig", "ParallelConfig", "InferenceConfig",
                 "TrainConfig", "PipelineConfig"):
        assert (t_cfg.to_dict(getattr(t_cfg, name)())
                == j_cfg.to_dict(getattr(j_cfg, name)())), name
    assert t_cfg.to_json(t_cfg.PipelineConfig()) == j_cfg.to_json(j_cfg.PipelineConfig())
    assert t_cfg.AudioConfig().n_freq == j_cfg.AudioConfig().n_freq


@pytest.mark.parametrize("flags", FLAG_SETS.values(), ids=FLAG_SETS.keys())
def test_parse_args_matches_jax(flags):
    assert t_cfg.to_dict(t_cli.parse_args(flags)) == j_cfg.to_dict(j_cli.parse_args(flags))


@pytest.mark.parametrize("flags", [
    [],
    ["--infer.face", "a.mp4", "--infer.fps=30", "--infer.static"],
    ["--infer.pads", "0,10,0,0", "--model.dtype", "float32", "--train.lr", "0.5"],
])
def test_from_cli_matches_jax(flags):
    assert t_cfg.to_dict(t_cfg.from_cli(flags)) == j_cfg.to_dict(j_cfg.from_cli(flags))


CONFIG_FILES = {
    ".json": json.dumps({"infer": {"fps": 24.0, "one_shot": True, "pads": [0, 5, 0, 0]},
                         "model": {"dtype": "float32"}}),
    ".py": "config = {'infer': {'fps': 24.0, 'crop': (2, -1, 2, -1)}, 'train': {'epochs': 2}}\n",
    ".yml": "infer:\n  fps: 24.0\n  one_shot: true\naudio:\n  fmin: 40.0\n",
}


@pytest.mark.parametrize("ext", CONFIG_FILES)
def test_config_file_then_flag_override_matches_jax(tmp_path, ext):
    if ext == ".yml":
        pytest.importorskip("yaml")
    path = tmp_path / f"c{ext}"
    path.write_text(CONFIG_FILES[ext])
    flags = ["--config", str(path), "--fps", "60"]
    got, want = t_cli.parse_args(flags), j_cli.parse_args(flags)
    assert t_cfg.to_dict(got) == j_cfg.to_dict(want)
    assert got.infer.fps == 60.0  # the explicit flag wins
    assert (t_cfg.to_dict(t_cfg.load_config_file(str(path)))
            == j_cfg.to_dict(j_cfg.load_config_file(str(path))))


@pytest.mark.parametrize("flags, error", [
    (["--no_such_flag", "x"], SystemExit),
    (["--infer.no_such_field", "x"], ValueError),
    (["--nosection.fps", "1"], ValueError),
    (["--infer.fps.x", "1"], ValueError),
])
def test_unknown_flags_raise(flags, error):
    with pytest.raises(error):
        t_cli.parse_args(flags)


def test_unknown_config_file_keys_and_extensions_raise(tmp_path):
    bad = tmp_path / "c.json"
    bad.write_text(json.dumps({"infer": {"fsp": 1}}))
    with pytest.raises(ValueError, match="unknown config key"):
        t_cfg.load_config_file(str(bad))
    other = tmp_path / "c.toml"
    other.write_text("")
    with pytest.raises(ValueError, match="unsupported config extension"):
        t_cfg.load_config_file(str(other))
