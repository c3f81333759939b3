"""The port's face3d training path (s2v_torch.models.bfm,
train/face3d_losses.py, train/face3d_train.py, prep/face3d_data.py)
against s2v_tpu's on the CPU, f32, inputs from numpy seeds.

- BFM: ``compute_for_render`` on tests/test_bfm.py's synthetic model
  (drawn from a RandomState of its own) within 1e-5 of each output's scale.
- ``rasterize``, which never builds s2v_tpu's face x pixel grid, against
  s2v_tpu's: masks identical; images within 1e-5 except at near-ties
  (pixels whose two nearest covering depths lie within 1e-5, found from a
  dense numpy copy of s2v_tpu's depths); the gradients to the vertices
  and the attributes of a random cotangent (zero at the near-ties) within
  1e-4 relative L2. Cases: random meshes of the JAX tests' kind
  (triangles spanning the image, faces that repeat a vertex) under the
  trainer's default camera and a 100 px focal, in one chunk and in chunks
  of 500 candidate pairs (``CANDIDATES``); a small grid mesh; two coplanar faces over the same
  pixels, where the lower index must win in either order. A face whose
  vertices project to one point or onto one pixel row passes s2v_tpu's
  clamped test on every pixel or the whole row, far outside its box: the
  port matches mask and image there too; its vertex gradient is excluded
  (a cancellation of terms scaled by 1/1e-9, rounding noise on both
  sides), the attributes' is held.
- The losses within 1e-5 relative.
- One ``make_face3d_train_step`` step at 32^2, batch 8, from JAX's initial
  state (loaded through ``recon_from_jax``) on the synthetic model, with
  the skin mask and an identity term on both sides. This step is
  ill-conditioned: the backward of ResNet50's train-mode BatchNorms, whose
  last ones see 1x1 maps of 8 samples, amplifies rounding. JAX's own step
  on the same batch in another order, which changes only the rounding,
  moves its clipped gradient by 2-6% relative L2 (the regulariser alone,
  which bypasses the render, by 2.4-3.9%) and its colour term by up to
  0.9% (measured here). So the port is held to 3x JAX's own spread over
  two such orders: each metric (at least 1e-5 relative), the clipped
  gradient over all parameters and over each of the eight groups (the
  backbone and each coefficient head) in relative L2 (the port's after
  the step; JAX's from Adam's first moment, (1 - b1) g after one step),
  and each new BatchNorm statistic (at least 1e-5). The step runs with
  ``BALANCED`` loss weights, which give each of the six terms a gradient
  of the same norm (with the defaults, the regulariser's and the
  reflectance term's are 0.1-0.2% of the total and no bound at this
  spread could see them); ``DEFAULT_WEIGHTS`` is compared as a dict. With
  these weights JAX's spread is 3.5% and the bound 10.5%; the port reads
  1.7%. Faults planted in a scratch copy of the trainer read (whole
  gradient): any one term dropped 0.39, the identity term's render
  detached 0.39, the photometric term's render detached 0.40,
  rasterize's camera replaced by the face model's 0.65, BatchNorm in eval
  mode 1.41, no clipping 2.1e4; each also fails in most groups. Faults
  that leave the function unchanged read 0.0172 like the port: clipping
  in torch's form (norm + 1e-6 against a norm of ~2e4), the identity
  target under a graph (the image carries none) and the cosine's
  arguments swapped. JAX's first step takes ~13-25 s here: it compiles
  once, in a module fixture.
- Face3d data: ``rgb_to_ycbcr`` and ``skin_mask`` bit-equal; the files and
  lists ``prepare_dataset`` writes byte-equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_bfm
from s2v_torch.models import bfm as TB
from s2v_torch.prep import face3d_data as TD
from s2v_torch.train import face3d_losses as TL
from s2v_torch.train.face3d_train import make_face3d_train_step as t_make_step
from s2v_torch.utils.weights import recon_from_jax
from s2v_tpu.models import bfm as JB
from s2v_tpu.prep import face3d_data as JD
from s2v_tpu.train import face3d_losses as JL
from s2v_tpu.train.face3d_train import make_face3d_train_step as j_make_step
from torch_parity import one_torch_thread

SIZE, B = 32, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def synthetic_data(n_verts=30, n_faces=40, seed=221):
    """test_bfm.synthetic_model from a RandomState of its own (its shared
    one advances with every call in the worker)."""
    shared = test_bfm.RNG
    test_bfm.RNG = np.random.RandomState(seed)
    try:
        d = test_bfm.synthetic_model(n_verts, n_faces)
    finally:
        test_bfm.RNG = shared
    return TB.FaceModelData(**vars(d)), d


def scale_close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_compute_for_render_matches_jax():
    tdata, jdata = synthetic_data()
    coeffs = np.random.RandomState(3).randn(4, 257).astype(np.float32) * 0.1
    want = JB.ParametricFaceModel(jdata, focal=100.0, center=16.0).compute_for_render(
        jnp.asarray(coeffs))
    got = TB.ParametricFaceModel(tdata, focal=100.0, center=16.0, device="cpu").compute_for_render(
        torch.from_numpy(coeffs))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale_close(g.numpy(), w, 1e-5)


def dense_near_ties(verts, faces, size, focal, center, eps=1e-5):
    """[B, H, W]: pixels whose two nearest covering depths, by s2v_tpu's
    formula in numpy f32, lie within ``eps``."""
    v = np.asarray(verts, np.float32)
    xy = v[..., :2] * np.float32(focal) / v[..., 2:] + np.float32(center)
    px, py, z = xy[..., 0], np.float32(size - 1.0) - xy[..., 1], v[..., 2]
    ys, xs = np.mgrid[0:size, 0:size]
    xs, ys = xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32)
    out = []
    for b in range(v.shape[0]):
        (ax, ay, az), (bx, by, bz), (cx, cy, cz) = [
            (px[b, faces[:, k], None], py[b, faces[:, k], None], z[b, faces[:, k], None])
            for k in range(3)]
        det = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        det = np.where(np.abs(det) < 1e-9, np.float32(1e-9), det)
        w0 = ((by - cy) * (xs - cx) + (cx - bx) * (ys - cy)) / det
        w1 = ((cy - ay) * (xs - ax) + (ax - cx) * (ys - ay)) / det
        w2 = np.float32(1.0) - w0 - w1
        zp = np.where((w0 >= 0) & (w1 >= 0) & (w2 >= 0), w0 * az + w1 * bz + w2 * cz, np.inf)
        two = np.sort(np.concatenate([zp, np.full_like(zp[:1], np.inf)]), 0)[:2]
        with np.errstate(invalid="ignore"):  # inf - inf where nothing covers
            out.append((np.isfinite(two[1]) & (two[1] - two[0] <= eps)).reshape(size, size))
    return np.stack(out)


def check_rasterize(verts, faces, attrs, size, focal, center, vertex_grads=True):
    ji, jm = JB.rasterize(jnp.asarray(verts), faces, jnp.asarray(attrs), size, focal, center)
    ji, jm = np.asarray(ji), np.asarray(jm)
    v = torch.tensor(verts, requires_grad=True)
    a = torch.tensor(attrs, requires_grad=True)
    ti, tm = TB.rasterize(v, faces, a, size, focal, center)
    np.testing.assert_array_equal(tm.numpy(), jm)
    ties = dense_near_ties(verts, faces, size, focal, center)
    keep = ~ties[..., None]
    np.testing.assert_allclose(ti.detach().numpy() * keep, ji * keep, rtol=0, atol=1e-5)
    g = np.random.RandomState(0).randn(*ji.shape).astype(np.float32) * keep
    jgv, jga = jax.grad(lambda vv, aa: jnp.sum(
        JB.rasterize(vv, faces, aa, size, focal, center)[0] * g), (0, 1))(
            jnp.asarray(verts), jnp.asarray(attrs))
    (ti * torch.from_numpy(g)).sum().backward()
    assert rel_l2(a.grad.numpy(), jga) <= 1e-4
    if vertex_grads:
        assert rel_l2(v.grad.numpy(), jgv) <= 1e-4, rel_l2(v.grad.numpy(), jgv)
    return jm, ji


@pytest.mark.parametrize("camera", [(1015.0, 112.0), (100.0, 16.0)], ids=["default", "focal100"])
@pytest.mark.parametrize("candidates", [TB.CANDIDATES, 500], ids=["one_chunk", "chunks"])
def test_rasterize_matches_jax_on_random_meshes(camera, candidates, monkeypatch):
    monkeypatch.setattr(TB, "CANDIDATES", candidates)
    rng = np.random.RandomState(11)
    covered = []
    for _ in range(3):
        verts = rng.randn(2, 30, 3).astype(np.float32)
        verts[..., 2] += 10.0
        faces = rng.randint(0, 30, (40, 3))  # some faces repeat a vertex
        attrs = rng.rand(2, 30, 3).astype(np.float32)
        jm, _ = check_rasterize(verts, faces, attrs, SIZE, *camera)
        covered.append(jm.mean())
    assert 0.05 < np.mean(covered) < 1.0


def test_rasterize_matches_jax_on_a_grid_mesh():
    n = 7
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float32)
    verts = np.stack([(gx - 3.1) * 0.23, (gy - 2.9) * 0.21,
                      10.0 + 0.05 * np.sin(gx) * np.cos(gy)], -1).reshape(1, -1, 3)
    verts = np.concatenate([verts, verts[:, ::-1] * [[[1.0, 1.0, 1.02]]]]).astype(np.float32)
    quads = [(r * n + c, r * n + c + 1, (r + 1) * n + c, (r + 1) * n + c + 1)
             for r in range(n - 1) for c in range(n - 1)]
    faces = np.array([f for a, b, c, d in quads for f in ((a, b, c), (b, d, c))])
    attrs = np.random.RandomState(2).rand(2, n * n, 3).astype(np.float32)
    jm, _ = check_rasterize(verts, faces, attrs, SIZE, 200.0, 16.0)
    assert jm.mean() > 0.3


@pytest.mark.parametrize("order", [(0, 1), (1, 0)], ids=["red_first", "green_first"])
def test_rasterize_coplanar_faces_lower_index_wins(order):
    tri = np.array([[-3.0, -3.0, 10.0], [3.0, -3.0, 10.0], [0.0, 4.0, 10.0]], np.float32)
    verts = np.concatenate([tri, tri])[None]
    attrs = np.array([[[1.0, 0, 0]] * 3 + [[0, 1.0, 0]] * 3], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]])[list(order)]
    jm, ji = check_rasterize(verts, faces, attrs, SIZE, 50.0, 16.0)
    first = attrs[0, faces[0, 0]]
    covered = jm[0, ..., 0] > 0
    assert covered.sum() > 100
    np.testing.assert_allclose(ji[0][covered], np.broadcast_to(first, ji[0][covered].shape),
                               atol=1e-6)


def test_rasterize_collapsed_faces_cover_what_jax_covers():
    verts = np.array([[[-1.0, 0.0, 10.0], [0.5, 0.0, 10.0], [0.3, -0.4, 9.0],
                       [-0.2, 0.6, 11.0], [0.25, 0.05, 10.5]]], np.float32)
    attrs = np.random.RandomState(1).rand(1, 5, 3).astype(np.float32)
    # (0, 0, 1): a line on pixel row 15 (y = 0 projects to 31 - 16);
    # (4, 4, 4): one point
    for faces, rows in ((np.array([[0, 0, 1], [2, 3, 4]]), 15), (np.array([[4, 4, 4]]), None)):
        jm, _ = check_rasterize(verts, faces, attrs, SIZE, 10.0, 16.0, vertex_grads=False)
        if rows is None:
            assert jm.all()
        else:
            assert jm[0, rows, :, 0].all()


def test_losses_match_jax():
    rng = np.random.RandomState(231)
    a, b = rng.rand(2, 16, 16, 3).astype(np.float32), rng.rand(2, 16, 16, 3).astype(np.float32)
    m = (rng.rand(2, 16, 16, 1) > 0.3).astype(np.float32)
    t = torch.from_numpy
    pairs = [(TL.photo_loss(t(a), t(b), t(m)), JL.photo_loss(a, b, m))]
    pred, gt = rng.rand(2, 68, 2).astype(np.float32), rng.rand(2, 68, 2).astype(np.float32)
    pairs.append((TL.landmark_loss(t(pred), t(gt)), JL.landmark_loss(pred, gt)))
    coeffs = {k: rng.randn(2, n).astype(np.float32)
              for k, n in (("id", 80), ("exp", 64), ("tex", 80), ("gamma", 27))}
    pairs += list(zip(TL.reg_loss({k: t(v) for k, v in coeffs.items()}),
                      JL.reg_loss({k: jnp.asarray(v) for k, v in coeffs.items()})))
    tex, skin = rng.rand(2, 30, 3).astype(np.float32), (rng.rand(30) > 0.5).astype(np.float32)
    pairs.append((TL.reflectance_loss(t(tex), t(skin)), JL.reflectance_loss(tex, skin)))
    f = rng.randn(4, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    g = np.roll(f, 1, 0)
    pairs.append((TL.perceptual_loss(t(f), t(g)), JL.perceptual_loss(f, g)))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def jax_embed(x):
    m = jnp.tanh(jnp.mean(x, axis=(1, 2)) * 3.0 - 1.0)
    return m / jnp.linalg.norm(m, axis=-1, keepdims=True)


def torch_embed(x):
    m = torch.tanh(x.mean((1, 2)) * 3.0 - 1.0)
    return m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)


PERMS = ([1, 0, 2, 3, 4, 5, 6, 7], [7, 6, 5, 4, 3, 2, 1, 0])
# each term's gradient about 8e3 in norm at JAX's initial state on this batch
BALANCED = dict(feat=1.25, color=0.66, reg=0.085, gamma=10.0, lm=1.4e-3, reflc=640.0)


@pytest.fixture(scope="module")
def steps():
    """One step of each package's trainer from JAX's initial state, and
    JAX's step on the batch in two other orders (the compiled step reused)."""
    tdata, jdata = synthetic_data()
    rng = np.random.RandomState(271)
    skin = (rng.rand(30) > 0.4).astype(np.float32)
    batch = {"image": rng.rand(B, SIZE, SIZE, 3).astype(np.float32),
             "gt_lm": (rng.rand(B, 68, 2) * SIZE).astype(np.float32),
             "mask": (rng.rand(B, SIZE, SIZE, 1) > 0.2).astype(np.float32)}
    init_fn, step_fn = j_make_step(JB.ParametricFaceModel(jdata, focal=100.0, center=16.0),
                                   skin_mask=skin, id_embed_fn=jax_embed, image_size=SIZE,
                                   weights=BALANCED)
    state0 = init_fn(jax.random.PRNGKey(0))
    variables = {"params": state0["params"], "batch_stats": state0["batch_stats"]}
    jax_runs = [step_fn(state0, {k: jnp.asarray(v[order]) for k, v in batch.items()})
                for order in [list(range(B))] + list(PERMS)]

    from s2v_torch.models.resnet import ReconNet

    recon = ReconNet()
    recon.load_state_dict(recon_from_jax(jax.tree_util.tree_map(np.asarray, variables)),
                          strict=True)
    fm = TB.ParametricFaceModel(tdata, focal=100.0, center=16.0, device="cpu")
    t_init, t_step = t_make_step(fm, skin_mask=skin, id_embed_fn=torch_embed, image_size=SIZE,
                                 weights=BALANCED, device="cpu")
    state = t_init(recon=recon)
    state, tm = t_step(state, batch)
    return jax_runs, state, tm


def jax_grads(jstate):
    """The clipped gradient of JAX's step from Adam's first moment, by the
    port's parameter names."""
    mu = jstate["opt"][1][0].mu
    return recon_from_jax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, {"params": mu, "batch_stats": jstate["batch_stats"]}))


def flat(d, names):
    return np.concatenate([np.asarray(d[k]).ravel() for k in names])


def test_default_weights_match_jax():
    from s2v_torch.train.face3d_train import DEFAULT_WEIGHTS as T_WEIGHTS
    from s2v_tpu.train.face3d_train import DEFAULT_WEIGHTS as J_WEIGHTS

    assert T_WEIGHTS == J_WEIGHTS


def test_train_step_metrics_match_jax(steps):
    jax_runs, state, tm = steps
    (jstate, jm), others = jax_runs[0], jax_runs[1:]
    assert int(jstate["step"]) == state.step == 1
    assert set(tm) == set(jm) == {"color", "lm", "reg", "gamma", "reflc", "feat", "loss"}
    assert float(tm["color"]) > 0.01  # the default camera's render covers pixels
    for k in jm:
        spread = max(abs(float(m[k]) - float(jm[k])) for _, m in others)
        tol = max(3 * spread, 1e-5 * abs(float(jm[k])))
        assert abs(float(tm[k]) - float(jm[k])) <= tol, (k, float(tm[k]), float(jm[k]), spread)


def test_train_step_gradients_and_batch_stats_match_jax(steps):
    jax_runs, state, _ = steps
    names = sorted(n for n, _ in state.module.named_parameters())
    want = flat(jax_grads(jax_runs[0][0]), names)
    spread = max(rel_l2(flat(jax_grads(s), names), want) for s, _ in jax_runs[1:])
    assert spread < 0.1  # else the comparison below holds nothing
    grads = {n: p.grad for n, p in state.module.named_parameters()}
    got = flat(grads, names)
    assert rel_l2(got, want) <= 3 * spread, (rel_l2(got, want), spread)
    groups = {}
    for n in names:  # the backbone and each coefficient head
        groups.setdefault(n.split(".")[0] if n.startswith("backbone") else n[:n.index(".", 13)],
                          []).append(n)
    assert len(groups) == 8
    for group in groups.values():
        want_g = flat(jax_grads(jax_runs[0][0]), group)
        spread_g = max(rel_l2(flat(jax_grads(s), group), want_g) for s, _ in jax_runs[1:])
        assert rel_l2(flat(grads, group), want_g) <= 3 * spread_g, (group[0], spread_g)

    def stats(jstate):
        return recon_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": jstate["params"], "batch_stats": jstate["batch_stats"]}))

    bufs = {k: v.numpy() for k, v in state.module.state_dict().items() if "running_" in k}
    assert bufs
    want = stats(jax_runs[0][0])
    others = [stats(s) for s, _ in jax_runs[1:]]
    for k, v in bufs.items():
        spread = max(rel_l2(o[k].numpy(), want[k].numpy()) for o in others)
        assert rel_l2(v, want[k].numpy()) <= max(3 * spread, 1e-5), k


def test_skin_mask_and_ycbcr_are_bit_equal():
    img = (np.random.RandomState(13).rand(3, 24, 20, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(TD.rgb_to_ycbcr(img), JD.rgb_to_ycbcr(img))
    np.testing.assert_array_equal(TD.skin_mask(img), JD.skin_mask(img))


def test_prepare_dataset_writes_the_same_files(tmp_path):
    from PIL import Image

    outs = {}
    for name, mod in (("port", TD), ("jax", JD)):
        folder = tmp_path / name / "imgs"
        folder.mkdir(parents=True)
        for i in range(3):
            Image.fromarray((np.random.RandomState(i).rand(32, 32, 3) * 255).astype(np.uint8)
                            ).save(folder / f"im{i}.png")
        (folder / "notes.txt").write_text("skipped")

        def landmarks(batch):
            return np.tile(np.linspace(0, 31, 68)[None, :, None], (len(batch), 1, 2)) + \
                batch.mean() / 255.0

        lists = mod.prepare_dataset([str(folder)], landmarks, mode="train",
                                    save_folder=str(tmp_path / name / "datalist"))
        files = {}
        for root, _, names in os.walk(tmp_path / name):
            for n in names:
                p = os.path.join(root, n)
                files[os.path.relpath(p, tmp_path / name)] = open(p, "rb").read()
        outs[name] = ([[os.path.relpath(p, tmp_path / name) for p in ls] for ls in lists],
                      {k: v.replace(str(tmp_path / name).encode(), b"ROOT")
                       for k, v in files.items()})
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0][0]) == 3
