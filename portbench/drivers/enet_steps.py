"""ENet fine-tuning steps over one clip's batches on the card, closed loop.

Set-up writes the ``train`` command's checkpoint directory (the trained
networks from the seed, the Steps 1-3 networks from the configuration's
cache), draws the traffic's ``clip_frames``-frame clip and
``speech_seconds`` of speech from the seed, and builds what the command
trains on: ``load_models``, Steps 1-3 and ``build_enet_batches`` (the
configuration's ``program``), the batches moved to the card once. The
batches are as the ``train`` command builds them: of ``batch`` frames, the
last of what is left (a 2.56 s clip gives 61 frames: 16, 16, 16, 13). The
fine-tune step then runs its first ``FIRST`` steps on batches 0, 1, 2, and
set-up goes on over the rest of the pass, so that every batch's shape has
run before the window; that same state carries on in the window, over the
batches in turn.

End to end: ``train_pairs_per_s``, where a pair is one (masked face |
reference, target) frame as training.py's datagen yields them: the frames
of the steps completed in the window (each step's batch size), over the
window's wall (its start to the card's end of the last step issued once
``seconds`` have passed).
The window waits for the card only at its end, as a loop that reads
nothing back between steps runs; a wait after every step leaves each
step's host-bound start (ENet's style encoder and LNet's small kernels) as
idle time on the card.
Correctness: the plain reference follows the first ``FIRST`` steps from the
same weights on the same batches, and the program's readings of them are
held to its (``gaps``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict

from portbench.core import compare, synth
from portbench.core.trace import Spans, profiled, synchronize, timed

END_TO_END = "train_pairs_per_s"
FIRST = 3        # steps that set-up runs and the reference follows
PROFILED = 4     # steps profiled in a traced run, and in their twin: one pass over the batches
BETA1 = 0.9      # Adam's first moment after one step is (1 - BETA1) times the gradient
TERMS = ("l1", "perceptual", "id")


def style_leaves(module) -> Dict[str, object]:
    return {k: p for k, p in module.named_parameters() if "style_conv" in k}


def first_steps(torch, state, step_fn, batches, steps: int = FIRST) -> dict:
    """Drive the program's ``step_fn`` through ``steps`` steps on the
    batches in turn; returns the first forward's prediction (on the host),
    the first step's terms, each style leaf's first gradient norm (from
    Adam's first moment), each style leaf's change norm over the steps and
    how many other entries of ENet's state (parameters and buffers) moved."""
    enet = state.module
    start = {k: v.detach().clone() for k, v in enet.state_dict().items()}
    preds = []
    hook = enet.register_forward_hook(lambda _m, _a, out: preds.append(out[0].detach().cpu()))
    try:
        for i in range(steps):
            state, m = step_fn(state, batches[i % len(batches)])
            if i == 0:
                hook.remove()
                losses = {k: float(m[k]) for k in TERMS}
                grad = {k: float(state.opt.state[p]["exp_avg"].norm()) / (1 - BETA1)
                        if p in state.opt.state else 0.0 for k, p in style_leaves(enet).items()}
    finally:
        hook.remove()
    now = enet.state_dict()
    change = {k: float((now[k] - start[k]).norm()) for k in style_leaves(enet)}
    frozen = sum(not torch.equal(now[k], start[k]) for k in now if "style_conv" not in k)
    return dict(pred=preds[0], losses=losses, grad=grad, change=change, frozen_changed=frozen)


def reference_steps(reference, batches, steps: int = FIRST) -> dict:
    """The same readings of the reference's (trained leaves, step)
    (``first_steps``); nothing else of the reference's state can move."""
    trained, step = reference
    start = {k: p.detach().clone() for k, p in trained.items()}
    for i in range(steps):
        out = step(batches[i % len(batches)])
        if i == 0:
            first = dict(pred=out["pred"].cpu(), losses={k: out[k] for k in TERMS},
                         grad={k: 0.0 if g is None else float(g.norm())
                               for k, g in out["grad"].items()})
    change = {k: float((p.detach() - start[k]).norm()) for k, p in trained.items()}
    return dict(first, change=change, frozen_changed=0)


def gaps(got: dict, want: dict) -> Dict[str, float]:
    """The numbers compared: the first prediction's largest gap over the
    reference's largest magnitude (infinite where the shapes differ); the
    worst relative gap of the first step's three terms; the style leaves'
    first gradient and their change over the steps, by the worst leaf
    (``compare.leaf_gap``); and how many entries outside the style convs
    moved."""
    ref = want["pred"].float()
    pred_gap = (float((got["pred"].float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
                if got["pred"].shape == ref.shape else math.inf)
    terms = [k for k in TERMS if k in want["losses"]]
    return dict(pred_gap=pred_gap,
                loss_gap=compare.relative_gap([got["losses"][k] for k in terms],
                                              [want["losses"][k] for k in terms]),
                grad_gap=compare.leaf_gap(got["grad"], want["grad"])[0],
                change_gap=compare.leaf_gap(got["change"], want["change"])[0],
                frozen_changed=float(got["frozen_changed"]))


class Driver:
    def __init__(self, torch, sizes: dict, cfg, traffic: dict, seed: int,
                 seconds: float, device, workdir: str, cache_dir):
        self.torch, self.sizes, self.cfg, self.tr = torch, sizes, cfg, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.dir, self.cache_dir = workdir, cache_dir
        self.info: Dict[str, object] = {}
        self.bytes_written = 0

    def _inputs(self) -> tuple:
        """The clip (.npz) and the speech (.wav) from the seed; their paths."""
        import numpy as np

        torch, s = self.torch, self.sizes["frame_size"]
        clip = os.path.join(self.dir, "clip.npz")
        gen = synth.generator(torch, synth.stream(self.seed, 2), self.device)
        frames = synth.clip_frames(torch, self.tr["clip_frames"], s, s, gen, self.device)
        np.savez(clip, frames=frames, fps=self.sizes["fps"])
        wav = os.path.join(self.dir, "speech.wav")
        gen = synth.generator(torch, synth.stream(self.seed, 3), self.device)
        synth.write_wav(wav, synth.speech(torch, self.tr["speech_seconds"], gen))
        return clip, wav

    def setup(self) -> None:
        from portbench.drivers.infer_requests import du

        torch, sizes = self.torch, self.sizes
        self.cfg.program_functions()
        cached = self.cache_dir / "weights"
        before = du(cached)
        steps_dir = self.cfg.ensure_steps_weights(torch, sizes, cached, self.device)
        self.weights = self.cfg.make_weights(torch, sizes, synth.stream(self.seed, 1),
                                             self.device)
        ckpt = self.cfg.write_checkpoints(torch, self.weights, steps_dir,
                                          os.path.join(self.dir, "checkpoints"))
        clip, wav = self._inputs()
        self.train_cfg = self.cfg.train_config(sizes, clip, wav, ckpt,
                                               os.path.join(self.dir, "tmp"))
        self.state, self.step_fn, self.batches = self.cfg.program(torch, self.train_cfg,
                                                                  self.device)
        self.bytes_written = du(cached) - before + du(self.dir)
        os.sync()  # the 1.3 GB of weight files' writeback belongs to set-up, not to the window
        t0 = time.perf_counter()
        self.readings = first_steps(torch, self.state, self.step_fn, self.batches)
        synchronize(torch, self.device)
        # the first steps' mean, cuDNN's first calls included: an estimate
        self.expected = max(PROFILED, math.ceil(self.seconds * FIRST / (time.perf_counter() - t0)))
        self.step = FIRST
        while self.step < len(self.batches):  # the pass's other batches: their shapes warm up
            self._step()
        self.info.update(batch_frames=[self.frames(i) for i in range(len(self.batches))],
                         first_losses=self.readings["losses"])

    def frames(self, step: int) -> int:
        """The frames of step ``step``'s batch."""
        return len(self.batches[step % len(self.batches)]["mel"])

    def _step(self, spans=None) -> None:
        """One step; only the traced window's spans wait for the card after
        it (``Spans``): elsewhere steps follow one another on the card's
        queue, as a loop that reads nothing back between steps runs them."""
        batch = self.batches[self.step % len(self.batches)]
        if spans is None:
            self.state, _ = self.step_fn(self.state, batch)
        else:
            with spans("step"):
                self.state, _ = self.step_fn(self.state, batch)
        self.step += 1

    def window(self, seconds: float, trace: bool) -> dict:
        torch = self.torch
        spans = Spans(torch, self.device) if trace else None
        n = len(self.batches)
        # two runs of PROFILED steps in the middle of the window, each from
        # batch 0 and apart from the spans: an unprofiled twin timed on the
        # host clock, then the profiled steps
        twin_at = math.ceil((self.step + self.expected // 2) / n) * n if trace else -1
        apart = {twin_at: (timed, []), twin_at + PROFILED: (profiled, [])} if trace else {}
        profiled_frames = sum(self.frames(i) for i in range(PROFILED))
        t0 = time.perf_counter()
        done = frames = 0
        while True:
            if self.step in apart:
                how, sink = apart[self.step]
                spans.active = False
                with how(torch, sink, self.device):
                    for _ in range(PROFILED):
                        self._step(spans)
                spans.active = True
                done += PROFILED
                frames += profiled_frames
            else:
                frames += self.frames(self.step)
                self._step(spans)
                done += 1
            if time.perf_counter() - t0 >= seconds and self.step > twin_at + PROFILED:
                break
        synchronize(torch, self.device)
        wall = time.perf_counter() - t0
        got = {how: sink[0] for how, sink in apart.values() if sink}
        return dict(units=frames, unit="pairs", wall_s=wall, attempted=done, failed=0,
                    metric=frames / wall, spans=spans,
                    span_units=frames - 2 * profiled_frames if trace else frames,
                    profile=got.get(profiled), twin_s=got.get(timed),
                    profiled_units=profiled_frames)

    def flop_s_at_peak(self) -> float:
        """The FLOPs of the profiled steps' twin (``PROFILED`` steps from
        batch 0, each at its batch's size) by the reference, over the float32
        peak (TF32 off)."""
        from portbench.core.peaks import FLOP_PER_S

        per_batch = {n: self.cfg.step_flops(self.torch, self.sizes, n)
                     for n in {self.frames(i) for i in range(PROFILED)}}
        flops = sum(per_batch[self.frames(i)] for i in range(PROFILED))
        return flops / FLOP_PER_S["float32"]

    def free(self) -> None:
        self.state = self.step_fn = None
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        ref = self.cfg.reference_step(self.torch, self.sizes, self.weights, self.device)
        want = reference_steps(ref, self.batches)
        return gaps(self.readings, want)
