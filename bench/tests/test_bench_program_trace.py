"""The program's spans on a traced view's axis (``bench/program_trace.py``)
and the five metrics that read them, on a synthetic view: two decode steps,
the second a flush step, with the recorder holding an earlier stretch too."""
from __future__ import annotations

import pytest

from bench import harness, program_trace
from bench.trace import View

H0 = 1000.0              # the host clock at the view's first marker
EARLIER = 500.0          # where an earlier stretch of the same process ran

# (name, start, end, children) on the view's axis
STEP1 = [
    ("kv_cache.append", 0.10, 0.20, []),
    ("kv_cache.attention_decode", 0.20, 0.90, [
        ("paged_attn", 0.21, 0.50, [("upload", 0.30, 0.32, []), ("upload", 0.33, 0.35, [])]),
        ("kv_cache.tail_merge", 0.55, 0.85, [("upload", 0.60, 0.62, [])]),
    ]),
]
STEP2 = [
    ("kv_cache.append", 1.10, 1.60, [
        ("kv_cache.flush", 1.15, 1.55, [("encode", 1.20, 1.30, []), ("encode", 1.35, 1.45, [])]),
    ]),
    ("kv_cache.attention_decode", 1.60, 1.95, [
        ("paged_attn", 1.61, 1.80, [("upload", 1.62, 1.63, []), ("upload", 1.64, 1.65, [])]),
        ("kv_cache.tail_merge", 1.82, 1.90, [("upload", 1.83, 1.84, [])]),
    ]),
]
STEPS = [{"kind": "decode", "t0": 0.0, "t1": 1.0, "flush": False, "pos": 7},
         {"kind": "decode", "t0": 1.0, "t1": 2.0, "flush": True, "pos": 8}]
BUSY = [(0.0, 0.05), (0.32, 0.60), (1.0, 1.12), (1.62, 1.70)]


def _rows(tree, shift: float, rows: list, parent: int = -1) -> list:
    """The recorder's rows (oldest first) of a tree of spans, ``shift`` on."""
    for name, a, b, kids in tree:
        rows.append((name, a + shift, b + shift, parent))
        _rows(kids, shift, rows, len(rows) - 1)
    return rows


def _view(pairs: int | None = None, window_s: float = 2.0) -> View:
    """The benchmark's own spans: each around its program call, the first
    opening at the same instant (so the offset is exactly H0)."""
    spans = []
    for name, a, b, _ in STEP1 + STEP2:
        bench = name.split(".", 1)[1]
        spans.append((bench, a if not spans else a - 1e-4, b + 1e-4))
    kernels = [(f"k{i}", a, b - a) for i, (a, b) in enumerate(BUSY)]
    return View(None, kernels, STEPS, spans[:pairs], window_s=window_s)


def _snap(trees=(STEP1, STEP2)) -> dict:
    rows = _rows(STEP1, EARLIER, [])                  # an earlier stretch
    for tree in trees:
        _rows(tree, H0, rows)
    return {"spans": rows, "counters": {}, "spans_dropped": 0}


def test_spans_of_the_last_stretch_on_the_views_axis():
    snap = _snap()
    snap["spans"].append(("upload", H0 + 2.5, H0 + 2.6, -1))     # after the stretch
    # the device's window may end before the host's last span: that span stays
    spans = program_trace.program_spans(_view(window_s=1.825), snap)
    want = _rows(STEP1 + STEP2, 0.0, [])
    assert [s[0] for s in spans] == [s[0] for s in want]
    assert [s[3] for s in spans] == [s[3] for s in want]
    for got, exp in zip(spans, want):
        assert got[1:3] == pytest.approx(exp[1:3], abs=1e-9)


def test_spans_that_do_not_pair_give_none():
    assert program_trace.program_spans(_view(), _snap(trees=(STEP2,))) is None   # too few
    swapped = _snap()
    rows = swapped["spans"]
    i = max(j for j, r in enumerate(rows) if r[0] == "kv_cache.attention_decode")
    rows[i] = ("kv_cache.append",) + rows[i][1:]
    assert program_trace.program_spans(_view(), swapped) is None                  # out of order
    late = _snap()
    name, a, b, parent = late["spans"][i]
    late["spans"][i] = (name, a, b + 0.5, parent)
    assert program_trace.program_spans(_view(), late) is None      # ends past its bench span


def test_idle_split_by_the_innermost_span(monkeypatch):
    monkeypatch.setattr(program_trace, "_snapshot", _snap)
    view = _view()
    idle = program_trace.idle_by_span(view)
    want = {"outside": 0.20, "kv_cache.append": 0.18, "kv_cache.attention_decode": 0.14,
            "paged_attn": 0.20, "upload": 0.05, "kv_cache.tail_merge": 0.30,
            "kv_cache.flush": 0.20, "encode": 0.20}
    assert idle == pytest.approx(want, abs=1e-9)
    wrapper = program_trace.idle_by_span(view, key=program_trace.in_wrapper)
    assert wrapper["wrapper"] == pytest.approx(0.20 + 0.20 + 0.02, abs=1e-9)
    assert wrapper["upload"] == pytest.approx(0.03, abs=1e-9)    # the tail merge's
    assert sum(wrapper.values()) == pytest.approx(sum(want.values()), abs=1e-9)


def test_the_metrics_read_the_spans(monkeypatch):
    monkeypatch.setattr(program_trace, "_snapshot", _snap)
    view = _view()
    want = {"uploads.decode": 3.0, "attn_host_ms.decode": 210.0, "tail_ms.decode": 175.0,
            "flush_host_ms.decode": 400.0, "wrapper_idle_ms.decode": 210.0}
    for name, value in want.items():
        got = harness.load_module(harness.BENCH, "metrics", name).read(view)
        assert got == pytest.approx(value, abs=1e-6), name
    # no upload in the stretch reads 0; a program without the recorder reads nothing
    no_uploads = [(n, a, b, k) for n, a, b, k in STEP1 if n == "kv_cache.append"]
    monkeypatch.setattr(program_trace, "_snapshot", lambda: _snap(trees=(no_uploads,)))
    one = _view(pairs=1)
    assert harness.load_module(harness.BENCH, "metrics", "uploads.decode").read(one) == 0
    monkeypatch.setattr(program_trace, "_snapshot", lambda: None)
    fresh = _view()
    for name in want:
        assert harness.load_module(harness.BENCH, "metrics", name).read(fresh) is None
