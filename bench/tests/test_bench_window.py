"""The window cell (``trinity-large-preview.decode-16k``) on the CPU: a tiny
run of its driver ``kv_decode_mixed`` is correct, the control and every
planted window fault are not, the window-aware counts hold across a wrap of
the ring, the four readers that read the window's work give the right
numbers on a synthetic view, and the reference copy imports nothing of the
program."""
from __future__ import annotations

import ast
import math
import time
import types

import pytest
import torch

from bench import calibrate_window, harness
from bench.counts import peaks, window, work
from bench.tests.tiny import REPO, TINY_FR
from bench.trace import View

CELL = "trinity-large-preview.decode-16k"
CPU = torch.device("cpu")
#: the cell cut to a few pages on the CPU: Trinity's period of three window
#: layers and a full one, a window of 10 tokens (a ring of 3 slots of 4)
TINY_CONFIG = {"num_hidden_layers": 4, "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
               "sliding_window": 10, "num_key_value_heads": 2, "num_attention_heads": 4,
               "head_dim": 32}
#: a window of 10 keys: the leans raised so that the own key and the
#: window's first take most of the softmax, as 12 does over the cell's 4,096
TINY_TRAFFIC = {"batch": 4, "context": 32, "round_steps": 8, "trace_steps": 4,
                "queries": {"std": 16.0, "own_key_logit": 8.0, "edge_logit": 8.0}}
#: the driver's clock in these runs: each read advances it 1 ms, so a window
#: of WINDOW_S runs the same steps however loaded the CPU is (about 2.5 rounds)
TICK_S, WINDOW_S = 1e-3, 0.06


def tiny_cell():
    cell = harness.load_cell(CELL, REPO)
    cell.config.update(TINY_CONFIG, fr=dict(TINY_FR), table_fit={"iters": 8, "sample_words": 4096})
    cell.traffic.update(TINY_TRAFFIC)
    return cell


class _Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += TICK_S
        return self.t


def _run(cell, monkeypatch, fault: str | None = None, change=None) -> dict:
    """A tiny run on the CPU on the driver's ticking clock, ``fault``
    planted in its window, ``change(driver)`` made to the driver first."""
    real_load = harness.load_module

    def load(root, kind, name):
        mod = real_load(root, kind, name)
        if kind != "drivers":
            return mod
        mod.time = _Clock()
        if change is not None:
            change(mod)
        if fault is None:
            return mod

        def window_(st, secs, tracer):
            with calibrate_window.planted(fault):
                return mod.window(st, secs, tracer)

        return types.SimpleNamespace(**{**vars(mod), "window": window_})

    monkeypatch.setattr(harness, "load_module", load)
    return harness.run(cell, 2**31 + 29, WINDOW_S, False, CPU, time.perf_counter())


def test_cell_is_declared_as_the_harness_finds_it():
    cell = harness.load_cell(CELL, REPO)
    assert cell.traffic["driver"] == "kv_decode_mixed" and cell.chips == 1
    assert window.layer_windows(cell.config).count(4096) == 45
    assert window.layer_windows(cell.config).count(0) == 15
    g = cell.geom()
    assert (g.n_layers, g.n_heads, g.n_kv, g.head_dim, g.batch, g.page_tokens) == \
        (60, 6, 1, 128, 128, 16)
    names = {m["name"] for m in cell.per_layer}
    assert {"attn_roofline.mixed", "attn_roofline.window", "mfu.decode_mixed",
            "window_host_ms.decode"} <= names
    assert not {"attn_roofline", "mfu.decode"} & names


def test_tiny_run_is_correct(monkeypatch):
    """Rounds restart over the restored rings: a run of several rounds is
    correct, and its check read every ring slot of the window layer."""
    result = _run(tiny_cell(), monkeypatch)
    assert result["correct"], result["checks"]
    assert result["steps"] > 2 * 8 and result["failed"] == 0
    assert result["checks"]["attn_gap"]["value"] > 0


@pytest.mark.parametrize("fault", calibrate_window.FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    result = _run(tiny_cell(), monkeypatch, fault)
    assert result["checks"]["attn_gap"]["value"] > result["checks"]["attn_gap"]["limit"], \
        (fault, result["checks"])
    assert not result["correct"]


def test_control_is_not_correct(monkeypatch):
    """The reference over a float8 cache fails a limit on three seeds that
    the program keeps."""
    real_load = harness.load_module

    def load(root, kind, name):
        mod = real_load(root, kind, name)
        mod.time = _Clock()
        return mod

    monkeypatch.setattr(harness, "load_module", load)
    cell = tiny_cell()
    got = calibrate_window.readings(cell, [5, 6, 7], 3, WINDOW_S, CPU)
    limits = cell.traffic["limits"]
    assert all(v <= limits[k] for k, vs in got["program"].items() for v in vs), got
    for j in range(3):
        assert any(got["control"][k][j] > limits[k] for k in limits), got


def test_restore_keeps_the_next_round_reading_its_prefix(monkeypatch):
    """Without the restore a round reads the pages the last round's
    flushes (and the set-up's warm-up flush) left in the ring, not the
    prefix's: the run is not correct."""
    result = _run(tiny_cell(), monkeypatch, change=lambda mod: setattr(mod, "_restore",
                                                                       lambda st: None))
    assert not result["correct"], result["checks"]


# Trinity's share of one chip at the cell's batch: a KV_FR page is 3,332 bytes serialised
TRINITY = work.Geom(n_layers=60, n_heads=6, n_kv=1, head_dim=128, batch=128,
                    page_words=2048, page_bytes=3332)


def test_window_counts_across_a_wrap():
    """A window of 4,096 tokens at 16 a page: the pages holding tokens in
    [pos - 4,095, cur * 16) are 256 off a flush step and 255 on one, the
    reused slot not counted; a full layer's equal ``work``'s."""
    g, W = TRINITY, 4096
    assert window.read_pages(16320, g, W) == 1020 - 764 == 256         # lo 12,225: page 764
    assert window.page_tokens_attended(16320, g, W) == 16320 - 12225
    assert window.read_pages(16335, g, W) == 1020 - 765 == 255         # the flush step of page 1,020
    assert window.page_tokens_attended(16335, g, W) == 16320 - 12240
    assert window.read_pages(100, g, W) == 6                           # before the ring fills
    for pos in (100, 16320, 16335, 16383):
        assert window.attn_work(pos, g, 0) == work.attn_work(pos, g)
        f, b = window.decode_layer_work(pos, g, 0)
        assert (60 * f, 60 * b) == work.decode_step_work(pos, g)
    flops, nbytes = window.attn_work(16320, g, W)
    assert flops == 4 * 128 * 6 * 4095 * 128
    assert nbytes == 2 * 128 * 256 * 3332 + 2 * 128 * 6 * 128 * 2
    # the window layer attends over pos + 1 - lo = 4,096 tokens, the full one over pos + 1
    f, _ = window.decode_layer_work(16383, g, W)
    assert f == 4 * 128 * 6 * 4096 * 128
    ws = [W, W, W, 0] * 15
    total = window.decode_step_work(16320, g, ws)
    assert total[0] == 45 * window.decode_layer_work(16320, g, W)[0] + \
        15 * window.decode_layer_work(16320, g, 0)[0]


def _reader(name):
    return harness.load_module(harness.BENCH, "metrics", name)


def _view(kernels, spans=()):
    cell = harness.load_cell(CELL, REPO)
    steps = [{"kind": "decode", "t0": 0.0, "t1": 0.1, "pos": 16320, "flush": False},
             {"kind": "decode", "t0": 0.1, "t1": 0.25, "pos": 16335, "flush": True}]
    return View(cell, kernels, steps, list(spans), window_s=0.25)


def test_window_readers_on_a_synthetic_view(monkeypatch):
    ring = "void (anonymous namespace)::attn_kernel<4, false, true>((anonymous namespace)::AttnArgs)"
    full = "void (anonymous namespace)::attn_kernel<4, false, false>((anonymous namespace)::AttnArgs)"
    merge = "void (anonymous namespace)::merge_kernel((anonymous namespace)::AttnArgs)"
    view = _view([(ring, 0.0, 0.04), (full, 0.05, 0.03), (merge, 0.09, 0.01),
                  (ring, 0.1, 0.05), (full, 0.16, 0.03)])
    g, ws = TRINITY, [4096, 4096, 4096, 0] * 15
    bound = {p: [peaks.bound_s(*window.attn_work(p, g, w)) for w in ws] for p in (16320, 16335)}
    win = sum(b for p in bound for b, w in zip(bound[p], ws) if w)
    allb = sum(sum(v) for v in bound.values())
    assert math.isclose(_reader("attn_roofline.window").read(view), 100 * win / 0.09)
    assert math.isclose(_reader("attn_roofline.mixed").read(view), 100 * allb / 0.16)
    step = sum(peaks.bound_s(*window.decode_step_work(p, g, ws)) for p in (16320, 16335))
    assert math.isclose(_reader("mfu.decode_mixed").read(view), 100 * step / 0.25)
    # no ring kernel in the trace: the window's share reads nothing
    assert _reader("attn_roofline.window").read(_view([(full, 0.0, 0.1)])) is None
    # the span metric: kv_cache.window spans a traced step, in ms
    from bench import program_trace

    rows = [("kv_cache.attention_decode", 0.01, 0.05, -1), ("kv_cache.window", 0.011, 0.049, 0),
            ("kv_cache.attention_decode", 0.11, 0.2, -1), ("kv_cache.window", 0.12, 0.19, 2)]
    monkeypatch.setattr(program_trace, "program_spans", lambda v: rows)
    assert math.isclose(_reader("window_host_ms.decode").read(view), 1e3 * (0.038 + 0.07) / 2)
    monkeypatch.setattr(program_trace, "program_spans", lambda v: rows[::2])
    assert _reader("window_host_ms.decode").read(view) is None
    monkeypatch.setattr(program_trace, "program_spans", lambda v: None)
    assert _reader("window_host_ms.decode").read(view) is None


def test_reference_copy_imports_nothing_of_the_program():
    path = harness.BENCH / "reference" / "window_attention.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "torch"}


def test_reference_copy_agrees_with_the_programs_reference():
    from bench.reference import window_attention as ref_win
    from repro_torch.serving.reference import window_attention

    g = torch.Generator().manual_seed(2)
    q = torch.randn(3, 4, 16, generator=g)
    k, v = torch.randn(2, 3, 40, 2, 16, generator=g)
    for pos, w in ((39, 0), (39, 7), (5, 7), (20, 1)):
        assert torch.equal(ref_win.window_attention(q, k, v, pos, w, rows=2),
                           window_attention(q, k, v, pos, w))
