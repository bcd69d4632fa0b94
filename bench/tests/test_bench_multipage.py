"""The multipage cell (``deepseek-7b.decode-4k``): rows of 4,096 words over
two page slots a token.  On the CPU, a tiny copy of the cell (rows of two
256-word pages) runs whole through the harness on a ticking clock and is
correct while the control and every decode fault are not; the frozen counts
read two slots a token; the span metric's reader gives the right number on a
synthetic view.  On the card, the cell cut to two layers keeps its limits on
three seeds while the control and each attention fault fail one, and a
traced run reads every per-layer metric the cell names.

    python -m pytest -q -m cuda bench/tests/test_bench_multipage.py
"""
from __future__ import annotations

import math
import time
import types

import pytest
import torch

from bench import calibrate, faults, harness
from bench.counts import work
from bench.tests.tiny import REPO, TINY_FR, TINY_Q
from bench.trace import View

CELL = "deepseek-7b.decode-4k"
CPU = torch.device("cpu")
#: the cell cut to a few pages on the CPU: 8 KV heads of 64 (a 512-word row)
#: over two 256-word page slots a token, G 1, as the cell's two slots of 16 heads
TINY_CONFIG = {"num_hidden_layers": 2, "num_key_value_heads": 8, "num_attention_heads": 8,
               "head_dim": 64}
TINY_TRAFFIC = {"batch": 2, "context": 16, "round_steps": 8, "trace_steps": 4,
                "queries": TINY_Q}
#: the driver's clock in these runs: each read advances it 1 ms, so a window
#: of WINDOW_S runs the same steps however loaded the CPU is (about 2 rounds)
TICK_S, WINDOW_S = 1e-3, 0.05
#: the per-layer metrics the cell reports, and those it leaves out
REPORTED = {"host_ms.decode", "attn_roofline", "flush_ms.decode", "idle_frac.decode", "mfu.decode",
            "uploads.decode", "attn_host_ms.decode", "flush_host_ms.decode",
            "wrapper_idle_ms.decode", "multipage_host_ms.decode"}


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


def _ticking(monkeypatch, fault: str | None = None) -> None:
    """The harness's drivers on the ticking clock, ``fault`` planted in
    their window."""
    real_load = harness.load_module

    def load(root, kind, name):
        mod = real_load(root, kind, name)
        if kind != "drivers":
            return mod
        mod.time = _Clock()
        if fault is None:
            return mod

        def window(st, secs, tracer):
            with faults.planted(fault):
                return mod.window(st, secs, tracer)

        return types.SimpleNamespace(**{**vars(mod), "window": window})

    monkeypatch.setattr(harness, "load_module", load)


def _run(monkeypatch, fault: str | None = None) -> dict:
    _ticking(monkeypatch, fault)
    return harness.run(tiny_cell(), 2**31 + 41, WINDOW_S, False, CPU, time.perf_counter())


def test_cell_is_declared_as_the_harness_finds_it():
    cell = harness.load_cell(CELL, REPO)
    assert cell.traffic["driver"] == "kv_decode" and cell.chips == 1
    assert cell.config["reduced"] == []
    g = cell.geom()
    assert (g.n_layers, g.n_heads, g.n_kv, g.head_dim, g.batch) == (30, 32, 32, 128, 32)
    assert (g.page_tokens, g.pages_per_row) == (1, 2)
    tr = cell.traffic
    assert (tr["context"], tr["round_steps"]) == (4032, 64)
    assert tr["context"] + tr["round_steps"] == cell.config["max_position_embeddings"]
    assert {m["name"] for m in cell.per_layer} == REPORTED
    assert {m["name"] for m in cell.end_to_end} == {"decode_tok_s", "step_p95_ms", "setup_s"}


def test_tiny_run_is_correct(monkeypatch):
    result = _run(monkeypatch)
    assert result["correct"], result["checks"]
    assert result["steps"] > 8 and result["failed"] == 0
    assert result["checks"]["attn_gap"]["value"] > 0


@pytest.mark.parametrize("fault", faults.BY_DRIVER["kv_decode"])
def test_fault_is_not_correct(fault, monkeypatch):
    result = _run(monkeypatch, fault)
    assert not result["correct"], (fault, result["checks"])


def test_control_is_not_correct(monkeypatch):
    """The reference over a float8 cache fails a limit on three seeds that
    the program keeps."""
    _ticking(monkeypatch)
    cell = tiny_cell()
    got = calibrate.readings(cell, [5, 6, 7], 3, WINDOW_S, CPU)
    limits = cell.traffic["limits"]
    assert all(v <= limits[k] for k, vs in got["program"].items() for v in vs), got
    for j in range(3):
        assert any(got["control"][k][j] > limits[k] for k in limits), got


def test_counts_read_two_slots_a_token():
    """Kernel C at position 4,032 reads the 4,032 tokens before it, two
    compressed slots each, K and V; a step's flush writes two slots a side."""
    g = harness.load_cell(CELL, REPO).geom()
    assert g.page_bytes == 3332
    flops, nbytes = work.attn_work(4032, g)
    assert flops == 4 * 32 * 32 * 4032 * 128
    assert nbytes == 2 * 32 * 4032 * 2 * 3332 + 2 * 32 * 32 * 128 * 2
    _, step = work.decode_step_work(4032, g)
    row = 32 * 4096 * 2
    assert step == 30 * (nbytes + 2 * row + 2 * row + 2 * 32 * 2 * 3332)


def test_multipage_reader_on_a_synthetic_view(monkeypatch):
    from bench import program_trace

    reader = harness.load_module(harness.BENCH, "metrics", "multipage_host_ms.decode")
    steps = [{"kind": "decode", "t0": 0.0, "t1": 0.1, "pos": 4032},
             {"kind": "decode", "t0": 0.1, "t1": 0.2, "pos": 4033}]
    view = View(harness.load_cell(CELL, REPO), [], steps, [], window_s=0.2)
    rows = [("kv_cache.attention_decode", 0.01, 0.05, -1), ("kv_cache.multipage", 0.011, 0.049, 0),
            ("kv_cache.attention_decode", 0.11, 0.2, -1), ("kv_cache.multipage", 0.12, 0.19, 2)]
    monkeypatch.setattr(program_trace, "program_spans", lambda v: rows)
    assert math.isclose(reader.read(view), 1e3 * (0.038 + 0.07) / 2)
    monkeypatch.setattr(program_trace, "program_spans", lambda v: rows[::2])
    assert reader.read(view) is None
    monkeypatch.setattr(program_trace, "program_spans", lambda v: None)
    assert reader.read(view) is None


def _two_layers():
    cell = harness.load_cell(CELL, REPO)
    cell.config["num_hidden_layers"] = 2
    return cell


@pytest.mark.cuda
def test_control_fails_where_the_program_holds(card):
    cell = _two_layers()
    got = calibrate.readings(cell, [11, 12, 13], 3, 2.0, card, n_fault=3)
    assert set(got["faults"]) == set(faults.ATTENTION), got
    limits = cell.traffic["limits"]
    assert all(v <= limits[k] for k, vs in got["program"].items() for v in vs), got
    for side in [got["control"], *got["faults"].values()]:
        for j in range(3):
            assert any(side[k][j] > limits[k] for k in limits), got


@pytest.mark.cuda
def test_traced_run_reads_its_metrics(card):
    from repro_torch import obs

    cell = _two_layers()
    before = obs.snapshot(spans=False)["counters"]
    # the profiler's first start in a process takes seconds: give the
    # window room for the traced steps after it
    result = harness.run(cell, 2**31 + 9, 20.0, True, card, time.perf_counter())
    after = obs.snapshot(spans=False)["counters"]
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}, result.get("breakdown")
    for k, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (k, m)
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["metrics"]["uploads.decode"]["value"] == 0
    launched = {k: after[k] - before[k] for k in ("launches.attn", "launches.attn_multipage",
                                                  "launches.attn_tail")}
    assert launched["launches.attn"] > 0 and len(set(launched.values())) == 1, launched
