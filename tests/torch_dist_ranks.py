"""Rank bodies of the port's multi-process tests, and ``spawn`` to run one
group of them (tests/test_torch_{parallel,dist_train,arcface}.py).

This module imports torch and s2v_torch only: the children that
``torch.multiprocessing`` spawns import it, and neither JAX nor a test file
(the parent computes the JAX references and passes them as numpy). Each
group meets through a ``FileStore`` in the test's own directory (no TCP
port, so concurrent test workers cannot clash), runs torch on one thread,
and has a process-group timeout and a join deadline, so that a hang fails
its test instead of running on.
"""

import datetime
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120.0


def _entry(rank, fn, world, workdir, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, workdir, *args):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in a gloo group; returns each rank's result (picklable). Raises the
    first child's error, or TimeoutError (after killing the group) when the
    group has not finished within ``TIMEOUT_S``."""
    workdir = str(workdir)
    ctx = mp.start_processes(_entry, args=(fn, world, workdir, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} did not finish within {TIMEOUT_S:.0f} s")
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def parallel_ranks(rank, world, refs):
    """PartialFC at model axis 2, the windows of a clip split over data axis
    2, hosts, ZeRO-1 and ``replicas_agree`` (one group, two ranks)."""
    from s2v_torch.parallel import hosts
    from s2v_torch.parallel.halo import sharded_coeff_windows, windowed_map
    from s2v_torch.parallel.mesh import (allreduce_grads, data_group, make_process_mesh,
                                         model_group, replicas_agree)
    from s2v_torch.parallel.partial_fc import (make_sharded_classifier, partial_fc_loss,
                                               sampling_generator, shard_rows)
    from s2v_torch.parallel.zero import shard_opt_state, state_numel

    out = {}
    by_model = make_process_mesh(1, 2)
    by_data = make_process_mesh(2, 1)
    mg, dg = model_group(by_model), data_group(by_data)
    assert by_model.mesh_dim_names == ("data", "model") and tuple(by_model.shape) == (1, 2)

    # PartialFC: loss and gradients per margin
    feats, labels = _t(refs["feats"]), torch.as_tensor(refs["labels"])
    w = shard_rows(_t(refs["weight"]), mg)
    for margin in ("none", "cosface", "arcface"):
        loss_fn, grad_fn = make_sharded_classifier(mg, margin_kind=margin)
        gf, gw = grad_fn(feats, labels, w)
        out[margin] = dict(loss=float(loss_fn(feats, labels, w)), gf=_np(gf), gw=_np(gw))

    # sampling: sample_rate 1.0 is the full loss; 0.25 keeps the positives
    # and puts gradient on sampled rows only
    sf, sl = _t(refs["s_feats"]), torch.as_tensor(refs["s_labels"])
    sw = shard_rows(_t(refs["s_weight"]), mg).requires_grad_(True)
    gen = sampling_generator(7, 0, dist.get_rank(mg))
    out["rate1"] = float(partial_fc_loss(sf, sl, sw.detach(), mg, "cosface", sample_rate=1.0,
                                         generator=gen))
    loss = partial_fc_loss(sf, sl, sw, mg, "cosface", sample_rate=0.25, generator=gen)
    (loss / 2).backward()
    out["sampled"] = dict(loss=float(loss), gw=_np(sw.grad))

    # windows of a clip split over the data axis, both paths
    for name, n in (("halo", 32), ("gather", 8)):
        full = _t(refs["coeffs"][:n])
        local = full.chunk(2)[dist.get_rank(dg)]
        out[f"windows_{name}"] = _np(sharded_coeff_windows(local, 26, dg))
    local = _t(refs["coeffs"][:32]).chunk(2)[dist.get_rank(dg)]
    out["box_mean"] = _np(windowed_map(
        lambda b: torch.stack([b[i:i + 5].mean(0) for i in range(b.shape[0] - 4)]),
        local, 5, dg))

    out["hosts"] = (hosts.process_index(), hosts.process_count(), hosts.is_leader(),
                    hosts.shard_work(list(range(7))), hosts.leader_only(lambda: rank)())

    # ZeRO-1: two SGD + momentum steps with the state sharded over the data
    # group against the same steps with replicated state
    x, y = _t(refs["zx"]).chunk(2)[rank], _t(refs["zy"]).chunk(2)[rank]
    results = {}
    for mode in ("repl", "zero"):
        lin = torch.nn.Linear(64, 16)
        with torch.no_grad():
            lin.weight.copy_(_t(refs["zw"]).t())
            lin.bias.copy_(_t(refs["zb"]))
        opt = (shard_opt_state(lin.parameters(), dg, torch.optim.SGD, lr=0.05, momentum=0.9)
               if mode == "zero" else torch.optim.SGD(lin.parameters(), lr=0.05, momentum=0.9))
        for _ in range(2):
            opt.zero_grad()
            ((lin(x) - y) ** 2).mean().backward()
            allreduce_grads(lin.parameters(), dg)
            opt.step()
        results[mode] = (_np(lin.weight), state_numel(opt))
        out[f"zero_agree_{mode}"] = replicas_agree(lin.parameters(), dg)
    out["zero"] = results
    probe = [torch.ones(3) * (1.0 + (rank == 1) * 1e-6)]
    out["agree"] = (replicas_agree([torch.ones(3)], dg), replicas_agree(probe, dg))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dist_train.py
# ---------------------------------------------------------------------------


def _flat_grads(module):
    return torch.cat([p.grad.reshape(-1) for p in module.parameters() if p.grad is not None])


def train_ranks(rank, world, refs):
    """GPEN step pairs 0-1 (R1 at 0, ``d_reg_every`` 2) and two ENet
    fine-tune steps, each rank on its shard of the batch; then the same two
    steps through ``finetune``'s epoch loop, whose leader checkpoints the
    replicated state into ``refs["enet_ckpt"]``."""
    from s2v_torch.models.enet import ENet
    from s2v_torch.models.gpen import Discriminator, FullGenerator
    from s2v_torch.parallel.mesh import data_group, make_process_mesh, replicas_agree
    from s2v_torch.train.finetune_enet import finetune, make_enet_finetune_step
    from s2v_torch.utils.config import TrainConfig

    mesh = make_process_mesh(world, 1)
    group = data_group(mesh)
    out = {}
    gan = run_gan(FullGenerator(**refs["g_kw"]), Discriminator(**refs["d_kw"]), refs,
                  shard=(rank, world), mesh=mesh)
    state = gan.pop("state")
    tensors = (list(state.g.parameters()) + list(state.d.parameters())
               + list(state.g_ema.parameters())
               + [v for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
                  for v in st.values() if torch.is_tensor(v) and v.dim() > 0])
    gan["replicas_agree"] = replicas_agree(tensors, group)
    out["gan"] = gan

    enet = ENet(**refs["enet_kw"])
    enet.load_state_dict({k: torch.from_numpy(v) for k, v in refs["enet_sd"].items()})
    st, step = make_enet_finetune_step(enet, TrainConfig(lr=1e-3), device="cpu", mesh=mesh)
    batch = {k: np.array_split(v, world)[rank] for k, v in refs["enet_batch"].items()}
    out["enet"] = run_enet(step, st, batch)
    out["enet"]["replicas_agree"] = replicas_agree(enet.parameters(), group)
    # the epoch loop takes the global batch and each rank its shard
    enet2 = ENet(**refs["enet_kw"])
    enet2.load_state_dict({k: torch.from_numpy(v) for k, v in refs["enet_sd"].items()})
    state = finetune(enet2, [refs["enet_batch"]], TrainConfig(lr=1e-3, epochs=2),
                     device="cpu", mesh=mesh, checkpoint_dir=refs["enet_ckpt"])
    out["enet"]["finetune"] = dict(steps=state.step, params={
        k: _np(p) for k, p in enet2.named_parameters() if p.requires_grad})
    # a global batch of 3 that the two ranks cannot split evenly is refused
    odd = {k: np.concatenate([v, v[:1]]) for k, v in refs["enet_batch"].items()}
    try:
        finetune(enet2, [odd], TrainConfig(lr=1e-3), device="cpu", mesh=mesh)
        out["enet"]["odd_batch"] = None
    except ValueError as e:
        out["enet"]["odd_batch"] = str(e)
    return out


def run_enet(step, state, batch, n_steps=2):
    """``n_steps`` fine-tune steps: each step's metrics and trained
    parameters."""
    steps = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        steps.append(dict(metrics={k: float(v) for k, v in m.items()},
                          params={k: _np(p) for k, p in state.module.named_parameters()
                                  if p.requires_grad}))
    return dict(steps=steps)


def run_gan(g, d, refs, shard=(0, 1), mesh=None):
    """GPEN step pairs 0-1 from ``refs``' weights on this rank's shard of its
    batch: per step, the metrics and the flattened gradient of the module
    stepped; the final parameters and EMA."""
    from s2v_torch.train.gan import make_gan_trainer

    g.load_state_dict({k: torch.from_numpy(v) for k, v in refs["g_sd"].items()})
    d.load_state_dict({k: torch.from_numpy(v) for k, v in refs["d_sd"].items()})
    state, d_step, g_step = make_gan_trainer(g, d, device="cpu", d_reg_every=2, mesh=mesh)
    rank, world = shard
    batch = {k: np.array_split(v, world)[rank] for k, v in refs["batch"].items()}
    steps = []
    for _ in range(2):
        state, dm = d_step(state, batch)
        steps.append(dict(metrics={k: float(v) for k, v in dm.items()},
                          grads=_np(_flat_grads(state.d))))
        state, gm = g_step(state, batch)
        steps.append(dict(metrics={k: float(v) for k, v in gm.items()},
                          grads=_np(_flat_grads(state.g))))
    return dict(steps=steps, state=state,
                g={k: _np(p) for k, p in state.g.named_parameters()},
                d={k: _np(p) for k, p in state.d.named_parameters()},
                g_ema={k: _np(p) for k, p in state.g_ema.named_parameters()})


# ---------------------------------------------------------------------------
# tests/test_torch_arcface.py
# ---------------------------------------------------------------------------


def same_tree(a, b) -> bool:
    """Whether two trees of tensors, dicts, lists and values are equal, the
    tensors bit for bit."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def arcface_checkpoint(state, make, layout, ckpt_dir):
    """Save this rank's ArcFace state at its step, restore it into a fresh
    state of the same layout (another seed's backbone, the initial
    classifier), and try it on a state of the other layout: whether the
    restore is bit for bit, the files written, and the other layout's
    error."""
    from s2v_torch.utils.checkpoint import TrainCheckpointer, state_tree

    ck = TrainCheckpointer(os.path.join(ckpt_dir, layout))
    ck.save(state.step, state)
    fresh = ck.restore(make(layout, seed=1))
    other = {"mp2": "dp2", "dp2_zero": "dp2"}[layout]
    try:
        ck.restore(make(other, seed=1))
        error = None
    except ValueError as e:
        error = f"{type(e).__name__}: {e}"
    return dict(bitwise=same_tree(state_tree(fresh), state_tree(state)),
                files=sorted(os.listdir(ck.directory)), other_error=error)


def arcface_ranks(rank, world, refs):
    """Two ArcFace steps at data 2 x model 1 and data 1 x model 2, and with
    the momentum sharded (ZeRO-1) and replicated; the class-shard and ZeRO
    states then go through ``TrainCheckpointer`` (``arcface_checkpoint``)."""
    from s2v_torch.models.iresnet import IResNet
    from s2v_torch.parallel.mesh import make_process_mesh, replicas_agree
    from s2v_torch.parallel.zero import state_numel
    from s2v_torch.train.arcface import make_arcface_trainer

    layouts = {"dp2": (2, 1, False), "mp2": (1, 2, False), "dp2_zero": (2, 1, True)}

    def make(name, seed=0):
        dp, mp_, zero = layouts[name]
        torch.manual_seed(seed)
        backbone = IResNet(refs["layers"], refs["emb"])
        if seed == 0:
            backbone.load_state_dict({k: torch.from_numpy(v) for k, v in refs["sd"].items()})
        mesh = make_process_mesh(dp, mp_)
        return mesh, *make_arcface_trainer(refs["classes"], mesh, refs["emb"], refs["layers"],
                                           lr=0.1, zero_opt=zero, device="cpu",
                                           backbone=backbone, clf_weight=refs["clf"])

    out = {}
    for name, (dp, mp_, zero) in layouts.items():
        mesh, state, step = make(name)
        backbone = state.backbone
        d = rank // mp_
        images = np.array_split(refs["images"], dp)[d]
        labels = np.array_split(refs["labels"], dp)[d]
        losses, states = [], []
        for _ in range(2):
            state, m = step(state, images, labels)
            losses.append(float(m["loss"]))
            states.append(dict(sd={k: _np(v) for k, v in backbone.state_dict().items()},
                               clf=_np(state.clf_weight)))
        out[name] = dict(losses=losses, states=states, state_numel=state_numel(state.opt),
                         agree=replicas_agree(list(backbone.parameters())
                                              + list(backbone.buffers()),
                                              mesh.get_group("data")))
        if name in ("mp2", "dp2_zero"):
            out[name]["checkpoint"] = arcface_checkpoint(
                state, lambda n, seed: make(n, seed)[1], name, refs["ckpt_dir"])
    return out
