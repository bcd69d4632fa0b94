"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a tiny run on the CPU (the harness's look for a
card is the only part skipped) with one fault of ``bench/faults.py`` planted
in the program during the window.  The cells run on one chip, so no exchange
between chips can be left out.  A sound run and the control are held to the
same limits.
"""
from __future__ import annotations

import time
import types

import pytest
import torch

from bench import calibrate, faults, harness

CPU = torch.device("cpu")
DECODE = ("mixtral-8x22b.decode-32k", "musicgen-large.decode-2k")
READBACK = "mixtral-8x22b.prefill-readback-32k"
CASES = ([(c, f) for c in DECODE for f in faults.BY_DRIVER["kv_decode"]]
         + [(READBACK, f) for f in faults.BY_DRIVER["kv_write_read"]])


def _run(cell, monkeypatch, fault: str | None = None) -> dict:
    real_load = harness.load_module

    def load(root, kind, name):
        mod = real_load(root, kind, name)
        if kind != "drivers" or fault is None:
            return mod

        def window(st, seconds, tracer):
            with faults.planted(fault):
                return mod.window(st, seconds, tracer)

        return types.SimpleNamespace(**{**vars(mod), "window": window})

    monkeypatch.setattr(harness, "load_module", load)
    return harness.run(cell, 2**31 + 77, 0.5, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", DECODE + (READBACK,))
def test_sound_run_is_correct(name, tiny_cell, monkeypatch):
    result = _run(tiny_cell(name), monkeypatch)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, tiny_cell, monkeypatch):
    result = _run(tiny_cell(name), monkeypatch, fault)
    assert not result["correct"], (fault, result["attempted"], result["checks"])


@pytest.mark.parametrize("name", DECODE + (READBACK,))
def test_control_is_not_correct(name, tiny_cell):
    """The reference one precision down (a float8 cache) fails a limit that
    the program's own readings keep, on three seeds."""
    cell = tiny_cell(name)
    got = calibrate.readings(cell, [5, 6, 7], 3, 0.5, CPU)
    limits = cell.traffic["limits"]
    assert all(v <= limits[k] for k, vs in got["program"].items() for v in vs), got
    for j in range(3):
        assert any(got["control"][k][j] > limits[k] for k in limits), got
