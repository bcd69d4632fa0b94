"""On the card: each cell at its own widths and context, cut to two layers,
keeps its limits on three seeds while the control (a float8 cache) and, in
the decode cells, each attention fault of ``bench/faults.py`` fail one, and
a traced run reads every per-layer metric the cell names, with no
share of a roofline or a peak above 100 %.

    python -m pytest -q -m cuda bench/tests
"""
from __future__ import annotations

import time

import pytest

from bench import calibrate, faults, harness
from bench.tests.tiny import REPO

CELLS = ("mixtral-8x22b.decode-32k", "musicgen-large.decode-2k",
         "mixtral-8x22b.prefill-readback-32k")


def _two_layers(name: str):
    cell = harness.load_cell(name, REPO)
    cell.config["num_hidden_layers"] = 2
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_holds(name, card):
    cell = _two_layers(name)
    got = calibrate.readings(cell, [11, 12, 13], 3, 2.0, card, n_fault=3)
    if cell.traffic["driver"] == "kv_decode":
        assert set(got["faults"]) == set(faults.ATTENTION), got
    limits = cell.traffic["limits"]
    assert all(v <= limits[k] for k, vs in got["program"].items() for v in vs), got
    for side in [got["control"], *got["faults"].values()]:
        for j in range(3):
            assert any(side[k][j] > limits[k] for k in limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_metrics(name, card):
    cell = _two_layers(name)
    # the profiler's first start in a process takes seconds: give the
    # window room for the traced steps after it
    result = harness.run(cell, 2**31 + 9, 20.0, True, card, time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}, result.get("breakdown")
    for k, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (k, m)
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
