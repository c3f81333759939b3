"""Adversarial training from a pool of batches on the card: d_step then
g_step, pair after pair, in a closed loop over ``pool_batches`` batches of
(lq, hq) that set-up draws from the seed (``core.synth.faces`` and
``degrade``), so that the trainer's step sets the pace.

Set-up builds the trainer once, from weights drawn from the seed, and
drives it through its first ``FIRST`` pairs on batches that all differ
(R1 falls on the first d_step); that same trainer carries on in the
window. End to end: ``train_pairs_per_s``, the pairs completed in the
window (R1 pairs as they fall) over the window's wall. Correctness: the
plain reference follows the first ``FIRST`` pairs from the same weights and
batches, and the program's readings of them are held to its: the first
pair's losses, D's first gradient as the optimizer got it (Adam's first
moment after one step: GPEN's beta1 is 0) and the parameters' change over
the pairs. These pairs go through the window's own calls on the window's own
pool, and the trainer that ran them is the one the window drives.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np

from portbench.core import compare, synth
from portbench.core.trace import Spans, profiled, synchronize, timed

END_TO_END = "train_pairs_per_s"
FIRST = 3          # pairs that set-up runs and the reference follows
PROFILED = 16      # pairs profiled in a traced run, and in their twin: one R1 pair among them
STILL = 1e-3       # leaves whose first gradient is under this share of the median leaf's


def leaves(state):
    for part in ("g", "d", "g_ema"):
        for k, p in getattr(state, part).named_parameters():
            yield f"{part}.{k}", p


def first_pairs(torch, trainer, pool, pairs: int = FIRST, from_adam: bool = True) -> dict:
    """Drive ``trainer`` (state, d_step, g_step) through ``pairs`` pairs on
    the pool's first batches; returns each step's loss, every leaf's norm of
    its first gradient (from Adam's first moment when ``from_adam``, else
    from ``.grad``) and of its change over the pairs."""
    state, d_step, g_step = trainer
    start = {k: p.detach().clone() for k, p in leaves(state)}
    losses, grad = [], {}

    def first(module, opt, part):
        for k, p in module.named_parameters():
            g = opt.state.get(p, {}).get("exp_avg") if from_adam else p.grad
            grad[f"{part}.{k}"] = 0.0 if g is None else float(g.norm())

    for pair in range(pairs):
        batch = pool[pair % len(pool)]
        state, m = d_step(state, batch)
        losses.append(float(m["d_loss"]))
        if pair == 0:
            first(state.d, state.d_opt, "d")
        state, m = g_step(state, batch)
        losses.append(float(m["g_loss"]))
        if pair == 0:
            first(state.g, state.g_opt, "g")
    change = {k: float((p.detach() - start[k]).norm()) for k, p in leaves(state)}
    return dict(losses=losses, grad=grad, change=change)


def gaps(got: dict, want: dict) -> Dict[str, float]:
    """The numbers compared. D's first step (with R1's double backward), by
    its loss and by its gradient's worst leaf; G's first step by its loss;
    each leaf's change over the pairs, by the worst leaf. Every later step,
    and G's first, follows an Adam step, whose sign-like first moves turn
    rounding into gaps: a lower precision reads inside them, so those
    losses are not compared, and G's gradient (which swings 1000x from
    seed to seed with D's first update) is not either: no fault reads ten
    times its sound runs. Leaves whose first gradient in the reference is
    under ``STILL`` of the median leaf's move under Adam by round-off
    alone, and are left out of the change (an EMA leaf goes with its
    generator leaf)."""
    g = want["grad"]
    floor = STILL * float(np.median(list(g.values())))
    keep = [k for k in want["change"]
            if g.get(k.replace("g_ema.", "g.", 1), 0.0) >= floor]
    d_grad = {k: v for k, v in g.items() if k.startswith("d.")}
    return dict(d_loss_gap=compare.relative_gap(got["losses"][:1], want["losses"][:1]),
                d_grad_gap=compare.leaf_gap(got["grad"], d_grad)[0],
                g_loss_gap=compare.relative_gap(got["losses"][1:2], want["losses"][1:2]),
                change_gap=compare.leaf_gap(got["change"], want["change"], keep)[0])


def pool(torch, sizes: dict, traffic: dict, seed: int, device) -> list:
    gen = synth.generator(torch, synth.stream(seed, 2), device)
    n, s = sizes["batch"], sizes["generator"]["size"]
    out = []
    for _ in range(traffic["pool_batches"]):
        hq = synth.faces(torch, n, s, gen, device)
        out.append(dict(lq=synth.degrade(torch, hq, gen, traffic["degrade_scale"]), hq=hq))
    return out


class Driver:
    def __init__(self, torch, sizes: dict, cfg, traffic: dict, seed: int,
                 seconds: float, device, workdir: str, cache_dir):
        self.torch, self.sizes, self.cfg, self.tr = torch, sizes, cfg, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.info: Dict[str, object] = {}
        self.bytes_written = 0   # the pool and the weights live on the card

    def setup(self) -> None:
        torch = self.torch
        self.weights = self.cfg.make_weights(torch, self.sizes, synth.stream(self.seed, 1),
                                             self.device)
        self.pool = pool(torch, self.sizes, self.tr, self.seed, self.device)
        self.trainer = self.cfg.program_trainer(torch, self.sizes, self.weights, self.device)
        t0 = time.perf_counter()
        self.readings = first_pairs(torch, self.trainer, self.pool)
        synchronize(torch, self.device)
        self.pair = FIRST
        # the pairs' mean, R1 and cuDNN's first calls included: an estimate
        self.expected = max(PROFILED, math.ceil(self.seconds * FIRST / (time.perf_counter() - t0)))
        self.info.update(first_losses=self.readings["losses"])

    def _pair(self, spans=None) -> None:
        state, d_step, g_step = self.trainer
        batch = self.pool[self.pair % len(self.pool)]
        if spans is None:
            state, _ = d_step(state, batch)
            state, _ = g_step(state, batch)
        else:
            with spans("d_step_r1" if state.step % self.sizes["d_reg_every"] == 0 else "d_step"):
                state, _ = d_step(state, batch)
            with spans("g_step"):
                state, _ = g_step(state, batch)
        synchronize(self.torch, self.device)
        self.pair += 1

    def window(self, seconds: float, trace: bool) -> dict:
        torch = self.torch
        spans = Spans(torch, self.device) if trace else None
        every = self.sizes["d_reg_every"]
        # two runs of PROFILED pairs in the middle of the window, each from
        # a pair with R1 and apart from the spans: an unprofiled twin timed
        # on the host clock, then the profiled pairs
        twin_at = (max(math.ceil((self.pair + self.expected / 2 - PROFILED) / every),
                       math.ceil(self.pair / every)) * every if trace else -1)
        apart = {twin_at: (timed, []), twin_at + PROFILED: (profiled, [])} if trace else {}
        t0 = time.perf_counter()
        done = 0
        while True:
            if self.pair in apart:
                how, sink = apart[self.pair]
                spans.active = False
                with how(torch, sink, self.device):
                    for _ in range(PROFILED):
                        self._pair(spans)
                spans.active = True
                done += PROFILED
            else:
                self._pair(spans)
                done += 1
            if time.perf_counter() - t0 >= seconds and self.pair > twin_at + PROFILED:
                break
        wall = time.perf_counter() - t0
        got = {how: sink[0] for how, sink in apart.values() if sink}
        return dict(units=done, unit="pairs", wall_s=wall, attempted=done, failed=0,
                    metric=done / wall, spans=spans,
                    span_units=done - 2 * PROFILED if trace else done,
                    profile=got.get(profiled), twin_s=got.get(timed), profiled_units=PROFILED)

    def flop_s_at_peak(self) -> float:
        """The FLOPs of the profiled pairs' twin (``PROFILED`` pairs, one
        with R1) by the reference, over the float32 peak (TF32 off)."""
        from portbench.core.peaks import FLOP_PER_S

        f = self.cfg.step_flops(self.torch, self.sizes)
        total = PROFILED * (f["d"] + f["g"]) + (f["d_r1"] - f["d"])
        return total / FLOP_PER_S["float32"]

    def free(self) -> None:
        self.trainer = None
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        ref = self.cfg.reference_trainer(self.torch, self.sizes, self.weights, self.device)
        want = first_pairs(self.torch, ref, self.pool, from_adam=False)
        return gaps(self.readings, want)
