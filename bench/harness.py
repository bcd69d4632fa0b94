"""One run of one cell: find its files by name, set up, measure, check.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness reads ``bench/configs/<config>.json`` and ``bench/traffic/<mix>.json``,
runs the driver the mix names (``bench/drivers/<driver>.py``), and reads
each per-layer metric the cell reports with ``bench/metrics/<metric>.py``.
A new cell, mix, configuration or metric is new files and a new entry in
``BENCHMARK.json``; no file here changes.

A driver module provides:

* ``setup(cell, seed, device) -> state``: inputs, the program's state, every
  shape warmed up;
* ``window(state, seconds, tracer) -> record``: the measured window;
* ``end_to_end(state, record) -> {metric: value}``;
* ``release(state, record)``: frees the program's state but what the check reads;
* ``check(state, record, control=False) -> {name: (value, limit)}``: the
  comparison with the plain reference (``control``: the reference one
  precision down stands in the program's place);
* ``work(state, record) -> (attempted, failed)``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType

import torch

from bench.common import sync
from bench.counts.work import Geom
from bench.reference.fr import FR
from bench.trace import Tracer, breakdown

BENCH = Path(__file__).resolve().parent
#: top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def fr(self) -> FR:
        return FR.from_dict(self.config["fr"])

    def geom(self) -> Geom:
        c = self.config
        return Geom(n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
                    n_kv=c["num_key_value_heads"], head_dim=c["head_dim"],
                    batch=self.traffic["batch"], page_words=self.fr.page_words,
                    page_bytes=self.fr.page_bytes())


def load_module(root: Path, kind: str, name: str) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, repo: Path, bench: Path = BENCH) -> Cell:
    spec = json.loads((repo / "BENCHMARK.json").read_text())
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = json.loads((bench / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())

    def applies(m: dict, reported: set[str] | None) -> bool:
        # a metric without ``workloads`` is every cell's (an end-to-end one,
        # as ``setup_s``) or, per layer, every cell's that reports its ``moves``
        if "workloads" in m:
            return name in m["workloads"]
        return reported is None or m["moves"] in reported

    e2e = [m for m in spec["end_to_end"] if applies(m, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if applies(m, names)]
    return Cell(name, config, traffic, w["chips"], e2e, per_layer)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, bench: Path = BENCH) -> dict:
    """One run: the result line as a dict, its checks under ``checks``, last."""
    driver = load_module(bench, "drivers", cell.traffic["driver"])
    if device.type == "cuda":
        torch.empty(0, device=device)       # the context first: the stats need it
        torch.cuda.reset_peak_memory_stats(device)
    state = driver.setup(cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(trace, device)
    record = driver.window(state, seconds, tracer)
    tracer.end()
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted, failed = driver.work(state, record)
    e2e = driver.end_to_end(state, record)
    e2e["setup_s"] = setup_s
    view = tracer.view(cell)
    driver.release(state, record)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(state, record)
    correct = all(v <= lim for v, lim in checks.values())

    metrics: dict[str, dict] = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    elif view is not None:
        for m in cell.per_layer:
            value = load_module(bench, "metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and view is not None:
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        result["breakdown"] = breakdown(view)
    result["steps"] = record.get("steps_done", attempted)
    result["card"] = power_limit() if device.type == "cuda" else None
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
