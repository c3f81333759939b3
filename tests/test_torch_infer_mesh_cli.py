"""``python -m s2v_torch.cli infer ... --parallel.infer_mesh true`` on the
CPU: ``main([...], device="cpu")`` with ``--parallel.data_parallel 2`` (two
CPU replicas) on the checkpoint files of tests/test_torch_cli.py and a
4-frame 192^2 clip, against the port's run without the mesh and the JAX
package's ``main`` with the mesh on its 8 virtual CPU devices laid out as
data 4 x model 2 (so that every 4-frame chunk splits over the data axis),
f32. The frames agree within one
gray level (at most 0.1% of subpixels off by more than 1, mean under 0.01,
none off by more than 1 against the port's own run; measured against JAX:
none off by more than 1, mean 1.2e-4), and the pipeline and every hook the
command built hold its mesh.
"""

import numpy as np

from s2v_torch import cli as t_cli
from s2v_torch.pipeline import inference as t_inf
from s2v_tpu import cli as j_cli
from test_torch_cli import ckpt, subset, write_wav  # noqa: F401  (the checkpoint fixture)
from test_torch_pipeline import assert_close_frames
from torch_parity import one_torch_thread


def test_infer_mesh_matches_the_plain_run_and_jax(ckpt, tmp_path):  # noqa: F811
    root = subset(ckpt, tmp_path / "ckpt", without=("GPEN-BFR-2048.pth",))
    rng = np.random.RandomState(41)
    yy, xx = np.mgrid[0:192, 0:192]
    base = np.stack([xx * 255.0 / 192, yy * 255.0 / 192, (xx + yy) * 127.0 / 384], -1)
    frames = np.clip(base[None] + rng.randn(4, 192, 192, 3) * 30, 0, 255).astype(np.uint8)
    np.savez(tmp_path / "clip.npz", frames=frames, fps=25.0)
    audio = write_wav(tmp_path / "speech.wav", 200, n=4400)  # 4 outputs
    argv = ["infer", "--face", str(tmp_path / "clip.npz"), "--audio", audio,
            "--checkpoint_dir", root, "--model.dtype", "float32"]
    mesh_flags = ["--parallel.infer_mesh", "true"]

    def run(name, extra):
        return np.load(t_cli.main(argv + ["--outfile", str(tmp_path / f"{name}.npz"),
                                          "--tmp_dir", str(tmp_path / name), *extra],
                                  device="cpu"))["frames"]

    j_cli.main(argv + ["--outfile", str(tmp_path / "jax.npz"), "--tmp_dir",
                       str(tmp_path / "jax"), *mesh_flags, "--parallel.data_parallel", "4",
                       "--parallel.model_parallel", "2"])
    want = np.load(tmp_path / "jax.npz")["frames"]
    built = []
    real = t_inf.LipSyncPipeline.__init__

    def record(self, *a, **k):
        real(self, *a, **k)
        built.append(self)

    try:
        t_inf.LipSyncPipeline.__init__ = record
        with one_torch_thread():
            single = run("single", [])
            mesh = run("mesh", [*mesh_flags, "--parallel.data_parallel", "2"])
    finally:
        t_inf.LipSyncPipeline.__init__ = real
    plain, meshed = built
    assert plain.mesh is None and meshed.mesh.shape == {"data": 2, "model": 1}
    m = meshed.models
    assert all(h.mesh is meshed.mesh for h in (m.ref_enhancer.enhancer,
                                               m.mouth_restorer.restorer))
    assert mesh.shape == single.shape == want.shape == (4, 192, 192, 3)
    assert_close_frames(mesh, single)
    assert np.abs(mesh.astype(np.int32) - single.astype(np.int32)).max() <= 1
    assert_close_frames(mesh, want)
