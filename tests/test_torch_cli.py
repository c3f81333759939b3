"""The port's CLI against s2v_tpu's on one checkpoint directory of
reference-format files, written with ``torch.save`` from seeded port
modules (``s2v_torch.cli.write_checkpoint_dir``).

S3FD, FAN (4 modules) and ReconNet are at full width, because s2v_tpu's
converters fix their depth; the rest is slim in width at the depths the
converters fix (LNet's 9 decoder blocks, ParseNet's 10, RRDBNet's 23, the
8-layer style MLPs) and RetinaFace is cfg_re50 with a 64-channel FPN
(``convert_retinaface`` reads ResNet50 only).

- Each module's geometry is read back from its own state_dict, and a file
  of another geometry raises instead of loading.
- ``load_models``: each port module's state_dict through s2v_tpu's
  ``convert_*`` gives back the tree s2v_tpu's ``load_models`` builds from
  the same files; the hooks exist exactly where s2v_tpu's do, for several
  subsets of the files and with the ``weights/`` subfolder; RetinaFace and
  ParseNet are one module each.
- every setting of s2v_tpu's ``infer`` loads and reaches the modules that
  run it (``parallel.infer_mesh`` with two CPU replicas: the pipeline and
  its hooks on one ``FrameMesh``), and a directory whose only
  GFPGAN is a GFPGANv1.pth (the original arch, slim at out_size 512: the
  depth ``convert_gfpgan_v1`` fixes) or that holds a GANimation file
  loads them as s2v_tpu's ``load_models`` does (the same trees).
- ``main(["infer", ...], device="cpu")`` writes the output file (one run
  on a 4-frame 192^2 clip, shared by the module) and, under
  ``--trace_out``, its spans and counters as a Chrome trace: one
  ``setup.load_models``, one ``infer.run``, every network of the run. The GPEN-BFR-2048 file is
  left out of that run: its final stage at 2048^2 costs over a minute on
  the CPU (the smoke runs it on the card).
- ``--parallel.infer_mesh true`` with ``--parallel.data_parallel 2`` (two
  CPU replicas) on the same files and clip, against that plain run and
  the JAX package's ``main`` with the mesh on its 8 virtual CPU devices laid
  out as data 4 x model 2 (so that every 4-frame chunk splits over the
  data axis), f32. The frames agree within one gray level (at most 0.1% of
  subpixels off by more than 1, mean under 0.01, none off by more than 1
  against the port's own run; measured against JAX: none off by more than
  1, mean 1.2e-4), and the pipeline and every hook the command built hold
  its mesh.
- ``find-audio`` picks the same file at the same distance as s2v_tpu's.

The port's runs use one torch thread (``torch_parity.one_torch_thread``):
under the suite's six workers torch's thread per core oversubscribes the
machine.
"""

import functools
import json
import os
import wave

import numpy as np
import pytest
import torch

from s2v_torch import cli as t_cli
from s2v_torch.audio import melspectrogram, num_mel_chunks
from s2v_torch.io.audio_io import load_wav
from s2v_torch.models.dnet import DNet, dnet_arch
from s2v_torch.models.enet import ENet, enet_arch
from s2v_torch.models.fan import FAN
from s2v_torch.models.ganimation import SplitGenerator, ganimation_arch
from s2v_torch.models.gfpgan import GFPGANv1, GFPGANv1Clean, gfpgan_arch
from s2v_torch.models.gpen import FullGenerator, fullgenerator_arch
from s2v_torch.models.parsenet import ParseNet, parsenet_arch
from s2v_torch.models.resnet import ReconNet, recon_arch
from s2v_torch.models.retinaface import RetinaFace, retinaface_arch
from s2v_torch.models.rrdbnet import RRDBNet, rrdbnet_arch
from s2v_torch.models.s3fd import S3FD
from s2v_torch.ops.warp import affine_warp_shear
from s2v_torch.pipeline import inference as t_inf
from s2v_torch.utils import trace
from s2v_torch.utils.weights import load_torch_checkpoint
from s2v_tpu import cli as j_cli
from s2v_tpu.utils import weights as JW
from test_torch_models import assert_same_tree, numpy_sd
from test_torch_pipeline import assert_close_frames
from torch_parity import one_torch_thread

LM3D = np.asarray([[-0.3, 0.2, 0.1], [0.3, 0.2, 0.1], [0.0, 0.0, 0.3],
                   [-0.2, -0.3, 0.1], [0.2, -0.3, 0.1]], np.float64)
SLIM_GPEN = dict(narrow=0.25, channel_multiplier=0.5, style_dim=64)
GFPGANER = dict(input_is_latent=True, different_w=True, sft_half=True)
STACK = ("RetinaFace-R50.pth", "ParseNet-latest.pth", "GFPGANv1.4.pth", "GPEN-BFR-512.pth",
         "GPEN-BFR-2048.pth", "realesrnet_x2.pth")


def seeded_modules():
    torch.manual_seed(0)
    mods = dict(
        s3fd=S3FD(), fan=FAN(), recon=ReconNet(), dnet=DNet(16, 8, 8, 32),
        enet=ENet(lnet_res_blocks=9, channel_multiplier=0.25, narrow=0.25, lnet_base_nc=8,
                  lnet_max_nc=32),
        retinaface=RetinaFace(out_channel=64),
        parsenet=ParseNet(base_ch=16, max_ch=32, min_ch=8, res_depth=10),
        gfpgan=GFPGANv1Clean(num_style_feat=64, channel_multiplier=0.5, narrow=0.25),
        gfpgan_v1=GFPGANv1(num_style_feat=64, narrow=0.25, **GFPGANER),
        ganimation=SplitGenerator(ngf=8),
        gpen512=FullGenerator(size=512, **SLIM_GPEN),
        gpen2048=FullGenerator(size=2048, **SLIM_GPEN),
        srmodel=RRDBNet(scale=2, num_feat=16, num_block=23, num_grow_ch=8))
    with torch.no_grad():  # random S3FD weights find no face: raise its face class
        mods["s3fd"].conv3_3_norm_mbox_conf.bias[3] += 2.0
    return mods


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    expression = (np.random.RandomState(55).randn(64) * 0.1).astype(np.float32)
    return t_cli.write_checkpoint_dir(str(tmp_path_factory.mktemp("ckpt")), seeded_modules(),
                                      lm3d=LM3D, expression=expression)


def subset(ckpt, root, without=(), only=None, under_weights=()):
    """A directory of links to ``ckpt``'s files: all but ``without`` (or
    ``only`` those), ``under_weights`` moved into ``weights/``."""
    os.makedirs(os.path.join(root, "weights"), exist_ok=True)
    for name in os.listdir(ckpt):
        if name in without or (only is not None and name not in only):
            continue
        dest = os.path.join(root, "weights" if name in under_weights else "", name)
        os.symlink(os.path.join(ckpt, name), dest)
    return str(root)


@pytest.fixture(scope="module")
def loaded(ckpt):
    return j_cli.load_models(ckpt), t_cli.load_models(ckpt, device="cpu")


@pytest.mark.parametrize("name, convert", [
    ("s3fd", JW.convert_s3fd), ("fan", JW.convert_fan), ("recon", JW.convert_recon_net),
    ("dnet", JW.convert_dnet), ("enet", None)])
def test_load_models_round_trips_to_the_jax_trees(loaded, name, convert):
    jax_models, port = loaded
    sd = numpy_sd(getattr(port, name).state_dict())
    if name == "enet":  # ENet.pth and LNet.pth, as s2v_tpu's load_models reads them
        lnet = {k[len("low_res."):]: v for k, v in sd.items() if k.startswith("low_res.")}
        tree = JW.convert_enet(sd, lnet)
    else:
        tree = convert(sd)
    assert_same_tree(tree, getattr(jax_models, name))


def test_load_models_reads_the_bfm_and_expression_files(loaded):
    jax_models, port = loaded
    np.testing.assert_array_equal(port.lm3d, jax_models.lm3d)
    np.testing.assert_allclose(port.lm3d, LM3D)
    np.testing.assert_array_equal(port.expression, jax_models.expression)
    assert port.expression.dtype == np.float32


@pytest.mark.parametrize("name, convert, module", [
    ("retinaface", JW.convert_retinaface, lambda m: m.final_enhancer.enhancer.models["retinaface"]),
    ("parsenet", JW.convert_parsenet, lambda m: m.ref_enhancer.enhancer.models["parsenet"]),
    ("gfpgan", JW.convert_gfpgan_clean, lambda m: m.mouth_restorer.restorer.models["gfpgan"]),
    ("gpen2048", functools.partial(JW.convert_gpen_full, size=2048),
     lambda m: m.final_enhancer.enhancer.models["facegan"]),
    ("srmodel", JW.convert_rrdbnet, lambda m: m.final_enhancer.enhancer.models["srmodel"])])
def test_restoration_modules_round_trip_to_the_jax_trees(ckpt, loaded, name, convert, module):
    """s2v_tpu's load_models hands these trees to its hooks; each is the
    converter of the file as that load_models reads it."""
    file, key = t_cli.CHECKPOINT_FILES[name]
    want = convert(JW.load_torch_checkpoint(os.path.join(ckpt, file), key=key))
    assert_same_tree(convert(numpy_sd(module(loaded[1]).state_dict())), want)


def test_retinaface_and_parsenet_are_one_module_each(loaded):
    port = loaded[1]
    ref, final, tail = port.ref_enhancer.enhancer, port.final_enhancer.enhancer, port.mouth_restorer
    assert ref.models["retinaface"] is final.models["retinaface"] is tail.restorer.models[
        "retinaface"]
    assert ref.models["parsenet"] is final.models["parsenet"] is tail.parsenet
    assert "facegan" not in ref.models  # Step 5 runs no GPEN
    assert ref.in_size == 512 and final.in_size == 2048 and final.sr_scale == 2
    assert tail.restorer.size == 512


SLIM = dict(
    enet=(lambda: ENet(lnet_res_blocks=2, channel_multiplier=0.25, narrow=0.25,
                       lnet_base_nc=8, lnet_max_nc=32), enet_arch, {}),
    dnet=(lambda: DNet(16, 8, 8, 32), dnet_arch, {}),
    recon=(lambda: ReconNet(layers=(1, 2, 1, 1), base_planes=8), recon_arch, {}),
    gpen=(lambda: FullGenerator(size=64, narrow=0.25, channel_multiplier=0.5, style_dim=64,
                                n_mlp=2), fullgenerator_arch, dict(size=64)),
    parsenet=(lambda: ParseNet(base_ch=16, max_ch=32, min_ch=8, res_depth=2), parsenet_arch, {}),
    rrdbnet=(lambda: RRDBNet(scale=2, num_feat=16, num_block=2, num_grow_ch=8), rrdbnet_arch,
             dict(scale=2)),
    gfpgan=(lambda: GFPGANv1Clean(out_size=64, num_style_feat=64, channel_multiplier=0.5,
                                  narrow=0.5, num_mlp=2), gfpgan_arch, dict(out_size=64)),
    retinaface=(lambda: RetinaFace(out_channel=64), retinaface_arch, {}),
    gfpgan_v1=(lambda: GFPGANv1(out_size=64, num_style_feat=64, narrow=0.5, num_mlp=2,
                                **GFPGANER),
               functools.partial(gfpgan_arch, arch="original", **GFPGANER), dict(out_size=64)),
    ganimation=(lambda: SplitGenerator(ngf=8, n_blocks=2), ganimation_arch, {}))
PRODUCTION = dict(
    enet=(ENet, enet_arch, {}), dnet=(DNet, dnet_arch, {}), recon=(ReconNet, recon_arch, {}),
    gpen=(lambda: FullGenerator(size=2048), fullgenerator_arch, dict(size=2048)),
    parsenet=(ParseNet, parsenet_arch, {}),
    rrdbnet=(lambda: RRDBNet(scale=2, num_feat=64, num_block=23, num_grow_ch=32), rrdbnet_arch,
             dict(scale=2)),
    gfpgan=(GFPGANv1Clean, gfpgan_arch, {}), retinaface=(RetinaFace, retinaface_arch, {}),
    gfpgan_v1=(lambda: GFPGANv1(**GFPGANER),
               functools.partial(gfpgan_arch, arch="original", **GFPGANER), {}),
    ganimation=(SplitGenerator, ganimation_arch, {}))


@pytest.mark.parametrize("widths, name", [(w, n) for w in ("slim", "production") for n in SLIM])
def test_geometry_is_read_from_the_state_dict(widths, name):
    """Each ``*_arch`` builds, from a module's own state_dict, a module with
    the same keys and shapes (production widths on the meta device)."""
    make, arch, kw = (SLIM if widths == "slim" else PRODUCTION)[name]
    with torch.device("meta"):
        want = make().state_dict()
        got = arch(want, **kw).state_dict()
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_a_checkpoint_of_another_geometry_does_not_load(ckpt, tmp_path):
    """A missing key falls back to the default geometry, whose strict load
    then names what is missing; a width that does not fit raises too."""
    sd = load_torch_checkpoint(os.path.join(ckpt, "DNet.pt"), key="net_G_ema")
    torch.save({"net_G_ema": {k: v for k, v in sd.items() if k != "mapping_net.first.0.weight"}},
               tmp_path / "DNet.pt")
    with pytest.raises(RuntimeError, match="mapping_net.first.0.weight"):
        t_cli.load_models(str(tmp_path), device="cpu")
    sd["editing_net.encoder.down0.model.0.weight"] = sd[
        "editing_net.encoder.down0.model.0.weight"][:, :4]
    torch.save({"net_G_ema": sd}, tmp_path / "DNet.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        t_cli.load_models(str(tmp_path), device="cpu")


HOOKS = ("ref_enhancer", "final_enhancer", "mouth_restorer")


@pytest.mark.parametrize("files", [
    dict(), dict(without=("GPEN-BFR-512.pth",)), dict(without=("realesrnet_x2.pth",)),
    dict(without=("ParseNet-latest.pth",)), dict(without=("GFPGANv1.4.pth",)),
    dict(without=("RetinaFace-R50.pth", "GPEN-BFR-2048.pth")),
    dict(under_weights=("RetinaFace-R50.pth", "ParseNet-latest.pth", "GPEN-BFR-512.pth",
                        "GPEN-BFR-2048.pth", "realesrnet_x2.pth"))],
    ids=["all", "no_gpen512", "no_realesrnet", "no_parsenet", "no_gfpgan", "no_retinaface",
         "weights_subfolder"])
def test_hooks_exist_where_jax_has_them(ckpt, tmp_path, files):
    root = subset(ckpt, tmp_path, only=STACK, **files)
    jax_models, port = j_cli.load_models(root), t_cli.load_models(root, device="cpu")
    assert ({h: getattr(port, h) is not None for h in HOOKS}
            == {h: getattr(jax_models, h) is not None for h in HOOKS})
    if port.final_enhancer is not None:
        assert port.final_enhancer.enhancer.use_sr == ("realesrnet_x2.pth" not in
                                                       files.get("without", ()))
    if not files:
        assert all(getattr(port, h) is not None for h in HOOKS)


def test_gfpgan_v13_is_taken_when_v14_is_absent(ckpt, tmp_path):
    root = subset(ckpt, tmp_path, only=("RetinaFace-R50.pth", "ParseNet-latest.pth"))
    os.symlink(os.path.join(ckpt, "GFPGANv1.4.pth"), os.path.join(root, "GFPGANv1.3.pth"))
    assert t_cli.load_models(root, device="cpu").mouth_restorer is not None


@pytest.mark.parametrize("flags", [
    ["--parallel.infer_mesh", "true", "--parallel.data_parallel", "2"],
    ["--model.approx_warp", "true"],
    ["--model.detector_dtype", "bfloat16"], ["--box", "0", "64", "0", "64"],
    ["--cropped_image"], ["--without_rl1"]])
def test_unported_settings_raise(ckpt, tmp_path, flags):
    """No setting is refused any more: each loads from the files and
    reaches what runs it. The mesh: two CPU replicas, held by the pipeline
    and every hook, whose chunks then take two frames per replica."""
    cfg = t_cli.parse_args(flags)
    if flags[0] == "--parallel.infer_mesh":
        mesh = t_cli.build_mesh(cfg, "cpu")
        assert mesh.shape == {"data": 2, "model": 1}
        assert [d.type for d in mesh.data_devices] == ["cpu", "cpu"]
        models = t_cli.load_models(subset(ckpt, tmp_path, only=STACK), cfg, device="cpu",
                                   mesh=mesh)
        pipe = t_inf.LipSyncPipeline(cfg, models, device="cpu", mesh=mesh)
        assert pipe.mesh is mesh and pipe.device == torch.device("cpu")
        step5, final = models.ref_enhancer.enhancer, models.final_enhancer.enhancer
        restorer = models.mouth_restorer.restorer
        assert all(e.mesh is mesh for e in (step5, final, restorer))
        assert (step5.chunk, final.chunk, restorer.chunk) == (32, 2, 32)
        assert t_cli.build_mesh(t_cli.parse_args([]), "cpu") is None
        return
    models = t_cli.load_models(subset(ckpt, tmp_path, only=STACK), cfg, device="cpu")
    pipe = t_inf.LipSyncPipeline(cfg, models, device="cpu")
    restorer, final = models.mouth_restorer.restorer, models.final_enhancer.enhancer
    step5 = models.ref_enhancer.enhancer
    shear = cfg.model.approx_warp
    assert all((e.warp is affine_warp_shear) == shear for e in (restorer, final, step5))
    det = cfg.model.detector_dtype
    assert all(e.nets["retinaface"].dtype == det for e in (restorer, final, step5))
    assert models.mouth_restorer.net.dtype == det
    assert pipe.cfg.infer.box == (tuple(int(v) for v in flags[1:]) if flags[0] == "--box"
                                  else (-1, -1, -1, -1))
    assert pipe.cfg.infer.cropped_image == (flags == ["--cropped_image"])
    assert pipe.cfg.infer.without_rl1 == (flags == ["--without_rl1"])


@pytest.mark.parametrize("files, flags, new_path", [
    (("GFPGANv1.pth",), [], True), (("GFPGANv1.pth", "GFPGANv1.4.pth"), [], False),
    (("30_net_gen.pth",), ["--up_face", "angry"], True),
    (("ganimation.pth",), ["--up_face", "sad"], True), (("30_net_gen.pth",), [], False)])
def test_unported_checkpoints_raise(ckpt, tmp_path, files, flags, new_path):
    """Nothing is refused any more. A GFPGANv1.pth without v1.4 or v1.3 is
    the original arch with GFPGANer's wiring, else v1.4 wins; a GANimation
    file (either name) gives an editor exactly when --up_face is not
    original (``new_path``: the cases this port took up last). The loaded
    trees are s2v_tpu's load_models' for the same files."""
    root = subset(ckpt, tmp_path, only=("RetinaFace-R50.pth", "ParseNet-latest.pth"))
    for name in files:
        src = "30_net_gen.pth" if name == "ganimation.pth" else name
        os.symlink(os.path.join(ckpt, src), os.path.join(root, name))
    cfg = t_cli.parse_args(flags)
    port = t_cli.load_models(root, cfg, device="cpu")
    jax_models = j_cli.load_models(root, j_cli.parse_args(flags))
    if "GFPGANv1.pth" in files:
        gfpgan = port.mouth_restorer.restorer.models["gfpgan"]
        assert isinstance(gfpgan, GFPGANv1) == new_path
        if new_path:
            assert gfpgan.input_is_latent and gfpgan.different_w
            tree = JW.convert_gfpgan_v1(numpy_sd(gfpgan.state_dict()))
            assert_same_tree(tree, jax_models.mouth_restorer.restorer.models["gfpgan"])
            assert t_inf.LipSyncPipeline(cfg, port, device="cpu").models.mouth_restorer
    else:
        assert (port.up_face_editor is not None) == new_path
        assert (jax_models.up_face_editor is not None) == new_path
        assert_same_tree(JW.convert_ganimation(numpy_sd(port.ganimation.state_dict())),
                         jax_models.ganimation)
        if new_path:
            assert port.up_face_editor.generator is port.ganimation


@pytest.mark.parametrize("command, queue", [("bench", 1)])
def test_unported_commands_raise(command, queue):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, queue {queue}"):
        t_cli.main([command, "--face", "x.npz"], device="cpu")
    with pytest.raises(SystemExit):
        t_cli.main(["no-such-command"], device="cpu")


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.load_models(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["infer", "--checkpoint_dir", str(tmp_path)])


def write_wav(path, f0, n=4000):
    t = np.arange(n) / 16000.0
    pcm = (np.sin(2 * np.pi * f0 * t) * 0.4 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


def recording_pipelines(built):
    """``LipSyncPipeline.__init__`` that also appends each pipeline to
    ``built`` (patched around a ``main`` call)."""
    real = t_inf.LipSyncPipeline.__init__

    def record(self, *a, **k):
        real(self, *a, **k)
        built.append(self)

    return real, record


@pytest.fixture(scope="module")
def plain_infer(ckpt, tmp_path_factory):
    """One ``main(["infer", ...], device="cpu")`` without GPEN-BFR-2048 on a
    4-frame 192^2 clip with 4 outputs; its argv, output path, tmp dir and
    the pipeline it built."""
    work = tmp_path_factory.mktemp("infer")
    root = subset(ckpt, work / "ckpt", without=("GPEN-BFR-2048.pth",))
    rng = np.random.RandomState(41)
    yy, xx = np.mgrid[0:192, 0:192]
    base = np.stack([xx * 255.0 / 192, yy * 255.0 / 192, (xx + yy) * 127.0 / 384], -1)
    frames = np.clip(base[None] + rng.randn(4, 192, 192, 3) * 30, 0, 255).astype(np.uint8)
    np.savez(work / "clip.npz", frames=frames, fps=25.0)
    audio = write_wav(work / "speech.wav", 200, n=4400)  # 4 outputs
    argv = ["infer", "--face", str(work / "clip.npz"), "--audio", audio,
            "--checkpoint_dir", root, "--model.dtype", "float32"]
    built = []
    real, record = recording_pipelines(built)
    trace.reset()  # the trace file holds this run alone
    try:
        t_inf.LipSyncPipeline.__init__ = record
        with one_torch_thread():
            out = t_cli.main(argv + ["--outfile", str(work / "out" / "result.npz"),
                                     "--tmp_dir", str(work / "tmp"),
                                     "--trace_out", str(work / "trace.json")], device="cpu")
    finally:
        t_inf.LipSyncPipeline.__init__ = real
    return dict(work=work, argv=argv, audio=audio, out=out, pipeline=built[0])


def test_infer_end_to_end_on_the_cpu(plain_infer):
    work = plain_infer["work"]
    assert plain_infer["out"] == str(work / "out" / "result.npz")
    data = np.load(plain_infer["out"])
    mel = melspectrogram(torch.from_numpy(load_wav(plain_infer["audio"])))
    n = num_mel_chunks(mel.shape[1], 25.0)
    assert data["frames"].shape == (n, 192, 192, 3) and data["frames"].dtype == np.uint8
    assert float(data["fps"]) == 25.0 and data["frames"].std() > 1.0
    assert len([f for f in os.listdir(work / "tmp") if f.startswith("clip_")]) == 5
    spans = json.loads((work / "trace.json").read_text())
    names = [e["name"] for e in spans["traceEvents"] if e["ph"] == "X"]
    assert names.count("setup.load_models") == names.count("infer.run") == 1
    assert {n for n in names if n.startswith("net.")} == {
        "net.s3fd", "net.fan", "net.recon", "net.dnet", "net.enet", "net.retinaface",
        "net.parsenet", "net.gfpgan"}
    assert spans["counters"]["cache.miss"] == 5 and spans["dropped"] == 0


def test_infer_mesh_matches_the_plain_run_and_jax(plain_infer, tmp_path):
    argv, mesh_flags = plain_infer["argv"], ["--parallel.infer_mesh", "true"]
    j_cli.main(argv + ["--outfile", str(tmp_path / "jax.npz"), "--tmp_dir",
                       str(tmp_path / "jax"), *mesh_flags, "--parallel.data_parallel", "4",
                       "--parallel.model_parallel", "2"])
    want = np.load(tmp_path / "jax.npz")["frames"]
    single = np.load(plain_infer["out"])["frames"]
    built = []
    real, record = recording_pipelines(built)
    try:
        t_inf.LipSyncPipeline.__init__ = record
        with one_torch_thread():
            mesh = np.load(t_cli.main(argv + ["--outfile", str(tmp_path / "mesh.npz"),
                                              "--tmp_dir", str(tmp_path / "mesh"), *mesh_flags,
                                              "--parallel.data_parallel", "2"],
                                      device="cpu"))["frames"]
    finally:
        t_inf.LipSyncPipeline.__init__ = real
    plain, (meshed,) = plain_infer["pipeline"], built
    assert plain.mesh is None and meshed.mesh.shape == {"data": 2, "model": 1}
    m = meshed.models
    assert all(h.mesh is meshed.mesh for h in (m.ref_enhancer.enhancer,
                                               m.mouth_restorer.restorer))
    assert mesh.shape == single.shape == want.shape == (4, 192, 192, 3)
    assert_close_frames(mesh, single)
    assert np.abs(mesh.astype(np.int32) - single.astype(np.int32)).max() <= 1
    assert_close_frames(mesh, want)


def test_find_audio_matches_jax(tmp_path, capsys):
    for name, f0 in [("a.wav", 220), ("b.wav", 440), ("src.wav", 225)]:
        write_wav(tmp_path / name, f0)
    printed = {}
    for side, main in (("port", t_cli.main), ("jax", j_cli.main)):
        args = ["find-audio", "--face", "clip.mp4", "--audio", str(tmp_path / "src.wav"),
                "--tmp_dir", str(tmp_path / side)]
        main(args)
        printed[side] = capsys.readouterr().out
        assert "a.wav" in printed[side] and "distance:" in printed[side]
        main(args)  # the cached answer
        assert "distance" not in capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert t_cli.main(["find-audio", "--face", "clip.mp4", "--audio", str(tmp_path / "src.wav"),
                       "--tmp_dir", str(tmp_path / "port")]) == str(tmp_path / "a.wav")
