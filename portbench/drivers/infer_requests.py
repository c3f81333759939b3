"""Requests of the ``infer`` command, one at a time in a closed loop.

Each request is a speech track of ``speech_seconds`` at 16 kHz over a clip
of ``clip_frames`` frames of ``frame_size``^2 at the configuration's frame
rate: the same template clip for every request (``fresh_clips`` false:
re-dubbing, whose per-clip artifacts the program caches, filled in set-up
by one request), or a clip of its own that the program has not seen, by
file name and by pixels (``fresh_clips`` true). Clips and speech are drawn
from the seed and written under the temporary directory in set-up; the
output file (``.npz``, the headless writer) is read back, its frames
counted, the compared ones kept, and deleted.

End to end: ``infer_fps``, the output frames of every request completed in
the window over the window's wall (its start to the end of the request in
flight when ``seconds`` have passed). Correctness: a sample of the
completed requests and of their output frames, drawn from the seed, against
the configuration's plain reference on the same clip, speech and weights.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Dict, List

import numpy as np

from portbench.core import compare, synth
from portbench.core.trace import Spans, profiled, synchronize, timed

END_TO_END = "infer_fps"
STAGES = ("extract_landmarks", "ffhq_crop", "extract_coeffs", "stabilize", "enhance_reference",
          "synthesize")
HOOKS = ("mouth_restorer", "final_enhancer")
WARMUP = 2 ** 20  # the speech stream index of the warm-up request


def du(path) -> int:
    """Bytes in the files under ``path`` (0 where there is none)."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


class Driver:
    def __init__(self, torch, sizes: dict, cfg, traffic: dict, seed: int,
                 seconds: float, device, workdir: str, cache_dir):
        self.torch, self.sizes, self.cfg, self.tr = torch, sizes, cfg, traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.dir, self.cache_dir = workdir, cache_dir
        self.frames_done = self.failed = 0
        self.bytes_written = 0   # every file the run writes, counted as it is written
        self.kept: List[dict] = []     # per completed request: its clip, wav and kept frames
        self.calls: List[tuple] = []   # (role, spec, autocast) of the profiled request's twin
        self.info: Dict[str, object] = {}

    # -- inputs -------------------------------------------------------------

    def _clip(self, k: int) -> str:
        """Clip ``k`` (0 is the template) written as .npz; returns its path."""
        torch, s, tr = self.torch, self.sizes["frame_size"], self.tr
        path = os.path.join(self.dir, f"clip{k:04d}.npz")
        gen = synth.generator(torch, synth.stream(self.seed, 1, k), self.device)
        frames = synth.clip_frames(torch, tr["clip_frames"], s, s, gen, self.device)
        np.savez(path, frames=frames, fps=self.sizes["fps"])
        self.bytes_written += os.path.getsize(path)
        return path

    def _speech(self, i: int) -> str:
        path = os.path.join(self.dir, f"speech{i:04d}.wav")
        gen = synth.generator(self.torch, synth.stream(self.seed, 2, i), self.device)
        synth.write_wav(path, synth.speech(self.torch, self.tr["speech_seconds"], gen))
        self.bytes_written += os.path.getsize(path)
        return path

    def _inputs(self, n: int) -> None:
        """Clips and speech for the window's requests up to ``n`` (exclusive):
        request i takes speech i and the template clip 0, or its own clip
        i + 1."""
        while len(self.speech) < n:
            i = len(self.speech)
            self.speech.append(self._speech(i))
            self.clips.append(self._clip(i + 1) if self.tr["fresh_clips"] else self.template)

    # -- set-up ---------------------------------------------------------------

    def _written_by_run(self, path: str) -> None:
        """Count what one ``run`` wrote: its output, the copy under
        ``tmp_dir`` that it muxes from, and the cache artifacts it added."""
        muxed = os.path.getsize(os.path.join(self.tmp, "result.npz"))
        before, self.cached = self.cached, du(self.tmp) - muxed
        self.bytes_written += os.path.getsize(path) + muxed + self.cached - before

    def setup(self) -> None:
        torch, tr = self.torch, self.tr
        weights = self.cache_dir / "weights"
        before = du(weights)
        self.weights_dir = self.cfg.ensure_weights(torch, self.sizes, weights, self.device)
        self.bytes_written += du(weights) - before
        self.cached = 0
        self.tmp = os.path.join(self.dir, "tmp")
        self.out = os.path.join(self.dir, "out.npz")
        self.template, self.clips, self.speech = self._clip(0), [], []
        self.pipe = self.cfg.program(torch, self.sizes, self.weights_dir, self.tmp, self.device)
        self.networks = self.cfg.program_networks(self.pipe)
        rng = np.random.default_rng(synth.stream(self.seed, 3))
        # the warm-up request, on clip 0: the template, whose artifacts the
        # window's requests then find in the program's cache, or a clip that
        # no window request uses (fresh)
        t0 = time.perf_counter()
        path = self.pipe.run(self.template, self._speech(WARMUP), self.out)
        synchronize(torch, self.device)
        self.t_request = time.perf_counter() - t0
        self.n_out = int(np.load(path, allow_pickle=False)["frames"].shape[0])
        self._written_by_run(path)
        os.remove(path)
        self.sample = sorted(rng.choice(self.n_out, size=min(tr["compare_frames"], self.n_out),
                                        replace=False).tolist())
        self.sample_rng = rng
        # enough inputs that the window cannot run out of them
        self.expected = max(1, math.ceil(self.seconds / self.t_request))
        self._inputs(2 * self.expected + 4)
        self.info.update(warmup_request_s=self.t_request, output_frames=self.n_out,
                         compared_frames=self.sample)

    # -- the window -------------------------------------------------------------

    def _request(self, i: int) -> None:
        t0 = time.perf_counter()
        path = self.pipe.run(self.clips[i], self.speech[i], self.out)
        frames = np.load(path, allow_pickle=False)["frames"]
        self._written_by_run(path)
        os.remove(path)
        self.frames_done += int(frames.shape[0])
        self.kept.append(dict(clip=self.clips[i], speech=self.speech[i],
                              frames=np.ascontiguousarray(frames[self.sample])))
        self.info.setdefault("request_s", []).append(time.perf_counter() - t0)

    def _spans(self) -> Spans:
        spans = Spans(self.torch, self.device)
        for name in STAGES:
            spans.wrap(self.pipe, name, name)
        for name in HOOKS:
            spans.wrap(self.pipe.models, name, name)
        return spans

    def _record_calls(self):
        """Forward pre-hooks on every network: the shapes of each call in
        the profiled request's twin, for its FLOP count by the reference."""
        torch = self.torch
        handles = []
        for role, module in self.networks.items():
            def pre(_m, args, kwargs, _role=role):
                self.calls.append((_role, compare.spec(torch, args, kwargs),
                                   bool(torch.is_autocast_enabled(torch.device(self.device).type))))
            handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
        return handles

    def _apart(self, i: int, spans: Spans, profile: bool, sink: list) -> None:
        """Request ``i`` with the spans switched off: under the profiler, or
        as its unprofiled twin, timed on the host clock with the networks'
        calls recorded (the wall and the work that the idle share and the
        MFU divide)."""
        how = profiled if profile else timed
        handles = [] if profile else self._record_calls()
        before = self.frames_done
        spans.active = False
        try:
            with how(self.torch, sink, self.device), spans("request"):
                self._request(i)
        finally:
            spans.active = True
            for h in handles:
                h.remove()
        self.apart_frames += self.frames_done - before
        if profile:
            self.profiled_frames = self.frames_done - before

    def window(self, seconds: float, trace: bool) -> dict:
        torch = self.torch
        spans = self._spans() if trace else None
        # two requests in the middle of the window run apart from the spans:
        # an unprofiled twin, then the profiled request
        twin_at = max(1, self.expected // 2) if trace else -1
        sinks: Dict[bool, list] = {False: [], True: []}
        self.apart_frames = self.profiled_frames = 0
        t0 = time.perf_counter()
        i = 0
        while True:
            if i >= len(self.speech):
                self._inputs(i + 1)   # only where the estimate fell short
            try:
                if trace and i in (twin_at, twin_at + 1):
                    self._apart(i, spans, i > twin_at, sinks[i > twin_at])
                elif spans is not None:
                    with spans("request"):
                        self._request(i)
                else:
                    self._request(i)
            except Exception as e:  # a failed request counts, and the loop goes on
                self.failed += 1
                print(f"request {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
            i += 1
            if time.perf_counter() - t0 >= seconds and i > twin_at + 1:
                break
        wall = time.perf_counter() - t0
        if trace:
            self.info.update(twin_request=twin_at, profiled_request=twin_at + 1)
        return dict(units=self.frames_done, unit="frames", wall_s=wall, attempted=i,
                    failed=self.failed, metric=self.frames_done / wall, spans=spans,
                    span_units=self.frames_done - self.apart_frames,
                    profile=sinks[True][0] if sinks[True] else None,
                    twin_s=sinks[False][0] if sinks[False] else None,
                    profiled_units=self.profiled_frames)

    def flop_s_at_peak(self) -> float:
        """The networks of the profiled request's twin: the reference's
        FLOPs at each call's shapes over the peak of the precision it ran
        in."""
        from portbench.core.flops import ideal_seconds

        nets = self.cfg.reference_networks(self.torch, self.sizes, "meta",
                                           sorted({r for r, _, _ in self.calls}))
        return ideal_seconds(self.torch, nets, self.calls)

    def free(self) -> None:
        self.pipe = self.networks = None
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------------

    def check(self) -> Dict[str, float]:
        """The kept output frames of a sample of the completed requests
        against the reference's; returns the numbers compared."""
        from portbench.reference.io.audio_io import load_wav

        done = self.kept
        if not done:
            return {}
        n = min(self.tr["compare_requests"], len(done))
        picks = sorted(self.sample_rng.choice(len(done), size=n, replace=False).tolist())
        ref = self.cfg.Reference(self.torch, self.sizes, self.weights_dir, self.device)
        got, want = [], []
        for p in picks:
            clip = np.load(done[p]["clip"], allow_pickle=False)["frames"]
            wav = load_wav(done[p]["speech"], self.sizes["sample_rate"])
            want.append(ref.outputs(clip, wav, self.sample))
            got.append(done[p]["frames"])
        self.info["compared_requests"] = picks
        return compare.frames(np.concatenate(got), np.concatenate(want))
