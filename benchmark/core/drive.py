"""The window: how a traffic's ``mode`` drives ``zoic_tpu_torch.Camera``.

* ``frames``: a closed loop of whole calls, issued back to back with no
  synchronise between them, cycling through set-up's frames of samples,
  a fresh retry seed a call; the window ends in a synchronise.
* ``buckets``: one client; each call is one bucket of the frame, in
  order, and ends in a synchronise before the next starts.
* ``refocus``: whole frames, each ``Camera.update`` to the schedule's next
  focus (ending in a synchronise) and then the frame's one call; the
  window starts and ends at a frame boundary.

Every call is numbered ``k`` from the start of set-up's warm-up; the call
number picks its samples and its retry seed.  A reservoir drawn from the
seed keeps the outputs of ``check_calls`` of the window's calls for the
comparison that decides ``correct``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

import torch

from . import inputs
from .profile import WINDOW, span


@dataclasses.dataclass
class Call:
    """What the comparison needs of one call: its samples' place, its
    retry seed, its focus and the program's outputs."""

    k: int
    frame: int
    offset: int
    n: int
    seed: int
    focus: Optional[float]
    rays: object = None
    stats: object = None


class Reservoir:
    """A uniform sample of ``size`` calls of the window, drawn from the
    run's seed as the calls come."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = random.Random(inputs.mix(seed, 3))

    def offer(self, call: Call) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(call)
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.kept[j] = call


class Driver:
    """One cell's camera, its inputs and the window's loop."""

    def __init__(self, cam, traffic: dict, frames, sizes, seed: int,
                 refocus: Optional[Callable] = None):
        self.cam = cam
        self.frames, self.sizes, self.seed = frames, sizes, seed
        self.offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.mode = traffic["mode"]
        self.refocus = refocus          # focus -> CameraConfig
        self.schedule = (inputs.focus_schedule(traffic)
                         if self.mode == "refocus" else None)
        self.k = 0

    # ---------------------------------------------------------- one call

    def _call(self, focus=None, trace=False) -> Call:
        k = self.k
        self.k += 1
        per = len(self.sizes)
        f = (k // per) % len(self.frames)
        j = k % per
        off, n = self.offsets[j], self.sizes[j]
        seed = inputs.call_seed(self.seed, k)
        sx, sy, lx, ly = (t[off:off + n] if per > 1 else t
                          for t in self.frames[f])
        with span("bench.call", trace):
            rays, stats = self.cam.create_rays(sx, sy, lx, ly, seed=seed)
        return Call(k, f, off, n, seed, focus, rays, stats)

    def _focus(self, i: int) -> float:
        # the schedule's first focus is the one set-up compiled
        return self.schedule[(i + 1) % len(self.schedule)]

    def _update(self, focus: float, trace=False) -> float:
        t0 = time.perf_counter()
        with span("bench.update", trace):
            self.cam.update(self.refocus(focus))
            if self._cuda:
                torch.cuda.synchronize()
        return time.perf_counter() - t0

    @property
    def _cuda(self) -> bool:
        return self.frames[0][0].is_cuda

    def _sync(self, trace=False) -> None:
        if self._cuda:
            with span("bench.sync", trace):
                torch.cuda.synchronize()

    # ------------------------------------------------------------ set-up

    def warmup(self) -> None:
        """Every shape the window uses, once: a call on each of set-up's
        frames, a whole frame of buckets, or one frame of the focus pull."""
        if self.mode == "buckets":
            for _ in range(len(self.sizes)):
                self._call()
                self._sync()
        else:
            for _ in range(len(self.frames)):
                self._call()
        self._sync()

    # ------------------------------------------------------------ window

    def window(self, seconds: float, keep: Reservoir) -> dict:
        """The measured window; returns its numbers and host spans."""
        calls = rays = 0
        lat, host, upd = [], [], []
        t0 = time.perf_counter()
        if self.mode == "frames":
            while time.perf_counter() - t0 < seconds:
                c = self._call()
                keep.offer(c)
                calls += 1
                rays += c.n
            self._sync()
        elif self.mode == "buckets":
            while time.perf_counter() - t0 < seconds:
                a = time.perf_counter()
                c = self._call()
                b = time.perf_counter()
                self._sync()
                lat.append(time.perf_counter() - a)
                host.append(b - a)
                keep.offer(c)
                calls += 1
                rays += c.n
        elif self.mode == "refocus":
            i = 0
            while True:
                focus = self._focus(i)
                upd.append(self._update(focus))
                c = self._call(focus)
                keep.offer(c)
                calls += 1
                rays += c.n
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            self._sync()
            self.frame_index = i
        else:
            raise ValueError(f"unknown traffic mode {self.mode!r}")
        window = time.perf_counter() - t0
        return {"window_s": window, "calls": calls, "rays": rays,
                "latency_s": lat, "host_s": host, "update_s": upd}

    def traced(self, n: int) -> dict:
        """``n`` calls (or frames) inside ``bench.window``, with CUDA events
        around them; the weights of each call are kept for the floor
        count."""
        weights, sizes = [], []
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        with span(WINDOW, True):
            ev0.record()
            for i in range(n):
                if self.mode == "refocus":
                    self._update(self._focus(getattr(self, "frame_index", 0)
                                             + i), trace=True)
                c = self._call(trace=True)
                if self.mode == "buckets":
                    self._sync(trace=True)
                weights.append(c.rays.weight)
                sizes.append(c.n)
            ev1.record()
            self._sync(trace=True)
        return {"events_s": ev0.elapsed_time(ev1) * 1e-3, "weights": weights,
                "sizes": sizes}
