"""The port's recorder: spans on the decode path and a fixed set of counters.

A span (:func:`span`) records its name, its start and end in absolute
``time.perf_counter()`` seconds, and the index of the span it opened inside.
Spans record only while a torch profiler session runs (torch's own flag
``torch.autograd.profiler._is_profiler_enabled``, which every
``torch.profiler.profile`` sets, CUDA-only sessions included) or inside
:func:`recording`, the operator's switch.  Off, a span site reads two flags
and returns one shared no-op context manager: no allocation, no clock read.
The spans live in a ring of :data:`SPAN_CAP` that keeps the newest; the ones
it overwrote are counted as ``spans_dropped``.  Spans nest by a single
stack, so they are recorded from one thread.

The counters are the names in :data:`COUNTERS`; :func:`count` adds to one.
A count given as an int is always added.  A count given as a device tensor
(``words.dropped``, the encode's per-page ``n_dropped``) is held only while
recording and summed when :func:`snapshot` reads it, so the path that made
it neither launches a kernel nor waits for the card.

    with obs.recording():
        ...                                  # append / attention_decode
    snap = obs.snapshot()
    snap["counters"]["uploads"]              # blocking host-to-device copies
    snap["spans"][0]                         # (name, start, end, parent index or -1)
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch
from torch.autograd import profiler as _profiler

#: every counter the port keeps
COUNTERS = (
    "uploads",            # blocking host-to-device copies (repro_torch._device.upload)
    "launches.encode",    # kernel A launches
    "launches.decode",    # kernel B launches
    "launches.attn",      # kernel C launches
    "launches.attn_sliced",  # of those, launches whose attention runs in token slices
    "launches.attn_tail",    # of those, launches whose merge took the raw tail (the tail form)
    "launches.attn_multipage",  # of those, launches over rows that span several page slots
    "table_prep.hit",     # prepared-table memo hits
    "table_prep.miss",    # and misses
    "words.encoded",      # words the KV cache encoded into page slots
    "words.dropped",      # outlier words those encodes dropped (while recording)
    "pages.evicted",      # window-layer flushes into a ring slot that held a page
)
#: spans the ring holds
SPAN_CAP = 1 << 16
#: device counts held before they are folded into one a counter and device
PENDING_CAP = 4096

_INDEX = {name: i for i, name in enumerate(COUNTERS)}
_values = [0] * len(COUNTERS)
_pending: list[tuple[int, torch.Tensor]] = []
_explicit = 0                      # depth of open recording() blocks
_names: list[str | None] = [None] * SPAN_CAP
_start = [0.0] * SPAN_CAP
_end = [0.0] * SPAN_CAP
_parent = [-1] * SPAN_CAP          # the parent's sequence number, -1 for none
_stack: list[int] = []             # sequence numbers of the open spans
_n = 0                             # spans begun since the last reset


class _Noop:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> None:
        return None


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "seq")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        global _n
        seq = _n
        _n = seq + 1
        i = seq % SPAN_CAP
        _names[i] = self.name
        _parent[i] = _stack[-1] if _stack else -1
        _end[i] = float("nan")
        _stack.append(seq)
        self.seq = seq
        _start[i] = time.perf_counter()

    def __exit__(self, *exc: object) -> None:
        t = time.perf_counter()
        seq = self.seq
        if _stack and _stack[-1] == seq:
            _stack.pop()
        if _n - SPAN_CAP <= seq < _n:      # not overwritten, nor reset away
            _end[seq % SPAN_CAP] = t


def span(name: str) -> _Span | _Noop:
    """A context manager that records ``name`` while recording is on."""
    if _explicit or _profiler._is_profiler_enabled:
        return _Span(name)
    return _NOOP


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and device counts inside the block."""
    global _explicit
    _explicit += 1
    try:
        yield
    finally:
        _explicit -= 1


def count(name: str, n: int | torch.Tensor = 1) -> None:
    """Add ``n`` to the counter ``name``: an int always, the sum of a
    tensor's elements only while recording (summed at :func:`snapshot`)."""
    i = _INDEX[name]
    if not isinstance(n, torch.Tensor):
        _values[i] += n
    elif _explicit or _profiler._is_profiler_enabled:
        _pending.append((i, n))
        if len(_pending) >= PENDING_CAP:
            _pending[:] = _fold(_pending)


def _fold(pending: list[tuple[int, torch.Tensor]]) -> list[tuple[int, torch.Tensor]]:
    """One int64 sum a counter and device, still on its device."""
    groups: dict[tuple[int, torch.device], list[torch.Tensor]] = {}
    for i, t in pending:
        groups.setdefault((i, t.device), []).append(t.reshape(-1))
    return [(i, torch.cat(ts).sum(dtype=torch.int64).reshape(1))
            for (i, _), ts in groups.items()]


def snapshot(spans: bool = True) -> dict:
    """``{"counters": {name: int}, "spans": [(name, start, end, parent)],
    "spans_dropped": int}``, the spans oldest first, ``parent`` an index into
    the list (-1 for none or overwritten) and ``end`` NaN while open;
    ``spans=False`` leaves the two span keys out.  Reads device counts, so
    it waits for the work that made them."""
    for i, t in _fold(_pending):
        _values[i] += int(t)
    _pending.clear()
    out: dict = {"counters": dict(zip(COUNTERS, _values))}
    if spans:
        first = max(0, _n - SPAN_CAP)
        rows = []
        for seq in range(first, _n):
            i = seq % SPAN_CAP
            p = _parent[i]
            rows.append((_names[i], _start[i], _end[i], p - first if p >= first else -1))
        out["spans"] = rows
        out["spans_dropped"] = first
    return out


def reset(*names: str) -> None:
    """Zero the named counters, or every counter and span when none is named."""
    global _n
    idx = {_INDEX[name] for name in names} if names else set(range(len(COUNTERS)))
    for i in idx:
        _values[i] = 0
    _pending[:] = [(i, t) for i, t in _pending if i not in idx]
    if not names:
        _n = 0
        _stack.clear()


__all__ = ["COUNTERS", "PENDING_CAP", "SPAN_CAP", "count", "recording", "reset", "snapshot",
           "span"]
