"""The traced stretch of a run: device operations from the profiler, the
benchmark's own host spans, and one time axis for both.

Only ``--trace 1`` runs trace.  A driver calls :meth:`Tracer.begin` and
:meth:`Tracer.end` around a stretch of whole steps or operations, records a
span around each call into the program (:meth:`Tracer.span`) and one record
a step (:meth:`Tracer.step`).  The profiler records device activity only
(kernels, copies, sets), so the host pays no per-operator cost.  At both ends
a synchronised, idle device runs a tiny marker kernel the moment the host
clock is read; its start on the device timeline puts host and device times
on one axis, zero at the first marker, to within a launch's latency.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from typing import Iterator

import torch

#: the program's kernels by the names the profiler gives them
KERNELS = {
    "A": re.compile(r"(^|\W)encode_kernel(\W|$)"),
    "B": re.compile(r"(^|\W)decode_kernel(\W|$)"),
    "C": re.compile(r"(^|\W)(attn_kernel|merge_kernel)(\W|$)"),
}
#: the marker kernel, ``at::cuda::(anonymous namespace)::spin_kernel(long)``
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
#: markers run and discarded before the first one that counts
WARM_MARKERS = 5


@dataclasses.dataclass
class View:
    """What the per-layer metric readers read: the traced stretch on one axis
    (seconds from the first marker), the cell, and the steps it holds."""

    cell: object
    kernels: list[tuple[str, float, float]]     # (name, start, duration)
    steps: list[dict]                           # kind, t0, t1, host_s, and the driver's fields
    spans: list[tuple[str, float, float]]       # (name, t0, t1) on the host
    window_s: float

    def kernel_s(self, key: str) -> float:
        """Device seconds of one of the program's kernels (``KERNELS``)."""
        pat = KERNELS[key]
        return sum(d for n, _, d in self.kernels if pat.search(n))

    def steps_of(self, kind: str) -> list[dict]:
        return [s for s in self.steps if s["kind"] == kind]

    def busy_in(self, intervals: list[tuple[float, float]]) -> float:
        """Device-busy seconds inside the given intervals of the axis."""
        busy = _union((s, s + d) for _, s, d in self.kernels)
        return sum(hi - lo for lo, hi, _ in _overlaps(busy, _union(intervals)))

    @property
    def busy_s(self) -> float:
        return self.busy_in([(0.0, self.window_s)])


def _overlaps(xs, ys):
    """(lo, hi, index into ys) of each overlap of two sorted, disjoint lists."""
    i = j = 0
    while i < len(xs) and j < len(ys):
        (a, b), (x, y) = xs[i][:2], ys[j][:2]
        if min(b, y) > max(a, x):
            yield max(a, x), min(b, y), j
        if b < y:
            i += 1
        else:
            j += 1


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Tracer:
    """Inactive unless ``enabled``; then one traced stretch a run."""

    def __init__(self, enabled: bool, device: torch.device) -> None:
        self.enabled = enabled and device.type == "cuda"
        self.device = device
        self.active = False
        self.done = False
        self._prof = None
        self._host0 = self._host1 = 0.0
        self.steps: list[dict] = []
        self.spans: list[tuple[str, float, float]] = []

    def _marker(self) -> float:
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize(self.device)
        return t

    def begin(self) -> None:
        if not self.enabled or self.active or self.done:
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(WARM_MARKERS):       # the first activities after a start can be lost
            self._marker()
            time.sleep(0.04)
        self._host0 = self._marker()
        self.active = True

    def end(self) -> None:
        if not self.active:
            return
        self._host1 = self._marker()
        self._prof.__exit__(None, None, None)
        self.active, self.done = False, True

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.active:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def step(self, kind: str, t0: float, t1: float, **info) -> None:
        """One step or operation of the traced stretch, timed on the host."""
        if self.active:
            self.steps.append({"kind": kind, "t0": t0, "t1": t1, **info})

    def view(self, cell) -> View | None:
        """The traced stretch, or None where nothing was traced."""
        if self._prof is None or not self.done:
            return None
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            events.append((e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
        ends = marker_window([s for n, s, _ in events if MARKER in n],
                             self._host1 - self._host0)
        if ends is None:
            return None
        dev0, dev1 = ends
        h0 = self._host0
        kernels = [(n, s - dev0, d) for n, s, d in events
                   if MARKER not in n and dev0 <= s <= dev1]
        steps = []
        for s in self.steps:
            host_s = sum(b - a for _, a, b in self.spans if s["t0"] <= a and b <= s["t1"])
            steps.append({**s, "t0": s["t0"] - h0, "t1": s["t1"] - h0, "host_s": host_s})
        spans = [(n, a - h0, b - h0) for n, a, b in self.spans]
        return View(cell, kernels, steps, spans, window_s=dev1 - dev0)


def marker_window(marks: list[float], host_span: float) -> tuple[float, float] | None:
    """(start, end) of the traced stretch on the device's clock: the last
    marker ends it, and it starts at the earlier marker whose distance to
    the last matches the host's (a session's first activities can be lost
    or stamped early); None where no marker matches."""
    if len(marks) < 2:
        return None
    marks = sorted(marks)
    end = marks[-1]
    start = min(marks[:-1], key=lambda m: abs(end - m - host_span))
    if abs(end - start - host_span) > max(2e-3, 0.02 * host_span):
        return None
    return start, end


def breakdown(view: View, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by the host span it fell in (``harness`` outside every span)."""
    by_name: dict[str, float] = {}
    for n, _, d in view.kernels:
        by_name[n] = by_name.get(n, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = _union((s, s + d) for _, s, d in view.kernels)
    gaps, prev = [], 0.0
    for a, b in busy + [(view.window_s, view.window_s)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans = sorted((x, y, n) for n, x, y in view.spans)
    idle = {"harness": sum(b - a for a, b in gaps)}
    for lo, hi, j in _overlaps(gaps, spans):
        name = spans[j][2]
        idle[name] = idle.get(name, 0.0) + hi - lo
        idle["harness"] -= hi - lo
    gaps_out = sorted(((k, v) for k, v in idle.items() if v > 0), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps_out]}
