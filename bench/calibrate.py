"""Readings that a cell's correctness limits are set from, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --seconds <s> \
        [--fault-seeds 3 --fault-seconds <s>]

For each seed: the cell's set-up, a window of ``--seconds`` at the cell's own
load, the release, then the check of the program and, on the first
``--control-seeds`` seeds, of the control: the plain reference on a cache
rounded through float8 e4m3 (one precision below the configuration's bf16)
standing in the program's place.  On the first ``--fault-seeds`` seeds, each
attention fault the cell's driver can have (``bench/faults.py``) planted in
the program for a window of its own after a set-up of its own.  Prints one
JSON line a seed, then a summary: each number's lower reading (the largest
over the program's seeds), upper reading (the smallest over the control's)
and each fault's smallest.  The benchmark's own runs run neither the control
nor a fault.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import faults, harness  # noqa: E402
from bench.common import sync  # noqa: E402
from bench.trace import Tracer  # noqa: E402


def _once(driver, cell, seed: int, seconds: float, device: torch.device,
          fault: str | None = None, control: bool = False) -> tuple[int, dict]:
    """Set-up, a window (with ``fault`` planted), release, check: the steps
    and ``{"program": checks}``, with ``"control"`` beside it if asked."""
    state = driver.setup(cell, seed, device)
    with faults.planted(fault):
        rec = driver.window(state, seconds, Tracer(False, device))
        sync(device)
    driver.release(state, rec)
    rows = {"program": driver.check(state, rec)}
    if control:
        rows["control"] = driver.check(state, rec, control=True)
    steps = rec["steps_done"]
    del state, rec
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return steps, rows


def readings(cell, seeds: list[int], n_control: int, seconds: float,
             device: torch.device, out=None, n_fault: int = 0,
             fault_seconds: float | None = None) -> dict:
    """{"program": {number: [readings]}, "control": {...}, "faults": {fault:
    {number: [...]}}}, a reading a seed."""
    kind = cell.traffic["driver"]
    driver = harness.load_module(harness.BENCH, "drivers", kind)
    fault_names = [f for f in faults.ATTENTION if f in faults.BY_DRIVER[kind]] if n_fault else []
    got: dict = {"program": {}, "control": {}, "faults": {f: {} for f in fault_names}}

    def keep(into: dict, checks: dict) -> dict:
        for k, (v, _) in checks.items():
            into.setdefault(k, []).append(v)
        return {k: v for k, (v, _) in checks.items()}

    for j, seed in enumerate(seeds):
        steps, rows = _once(driver, cell, seed, seconds, device, control=j < n_control)
        line = {"seed": seed, "steps": steps,
                **{side: keep(got[side], checks) for side, checks in rows.items()}}
        for f in fault_names if j < n_fault else ():
            _, fr = _once(driver, cell, seed, fault_seconds or seconds, device, fault=f)
            line.setdefault("faults", {})[f] = keep(got["faults"][f], fr["program"])
        if out is not None:
            print(json.dumps(line), file=out, flush=True)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--fault-seconds", type=float, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    got = readings(cell, seeds, args.control_seeds, args.seconds, torch.device("cuda", 0),
                   out=sys.stdout, n_fault=args.fault_seeds, fault_seconds=args.fault_seconds)
    nan = [float("nan")]
    summary = {k: {"lower": max(v), "upper": min(got["control"].get(k, nan)),
                   "limit": cell.traffic["limits"][k],
                   "faults": {f: min(r.get(k, nan)) for f, r in got["faults"].items()}}
               for k, v in got["program"].items()}
    print(json.dumps({"summary": summary, "card": harness.power_limit(),
                      "seconds": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
