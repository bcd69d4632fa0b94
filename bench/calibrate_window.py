"""Readings that a window cell's correctness limits are set from: the
program, the control, and faults of the window planted in the program, in
one process.

    python3 bench/calibrate_window.py --workload <cell> --seeds 6 --control-seeds 3 \\
        --seconds <s> [--fault-seeds 1 --fault-seconds <s>]

The program's and the control's readings are ``bench/calibrate.py``'s.  On
the first ``--fault-seeds`` seeds, each attention fault of
``bench/faults.py`` and each window fault below is planted in the program
for a window of its own after a set-up of its own.  Prints one JSON line a
run, then a summary as ``calibrate.py``'s.  The benchmark's own runs plant
no fault.

The window faults each replace ``gbdi_paged_attn.ring_bounds``, the ring's
bounds that kernel C (both its CUDA wrapper and its plain version) reads in
a window layer:

* ``window_unmasked``: the window's first position dropped, so the layer
  attends over every page its ring holds, as a full layer over its cache;
* ``reused_slot_read``: on a flush step, the slot the flush has just reused
  read as the page it now holds, which the raw tail holds too;
* ``lo_one_early`` / ``lo_one_late``: the window's first position one
  before or one after ``pos - W + 1``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import calibrate, faults, harness  # noqa: E402
from bench.common import sync  # noqa: E402
from bench.trace import Tracer  # noqa: E402


def _reused_slot_read(S, pos, pt, n_valid, cur, lo):
    if pos % pt == pt - 1:
        return min(S, cur + 1), cur + 1, lo
    return n_valid, cur, lo


#: name -> the change made to ``ring_bounds``' (n_valid, cur, lo) in a window layer
WINDOW_FAULTS = {
    "window_unmasked": lambda S, pos, pt, n, cur, lo: (n, cur, 0),
    "reused_slot_read": _reused_slot_read,
    "lo_one_early": lambda S, pos, pt, n, cur, lo: (n, cur, max(0, lo - 1)),
    "lo_one_late": lambda S, pos, pt, n, cur, lo: (n, cur, lo + 1),
}
#: every fault a window cell is read under: the attention faults of the
#: decode cells, then the window's own
FAULTS = faults.ATTENTION + tuple(WINDOW_FAULTS)


@contextlib.contextmanager
def planted(name: str | None):
    """The program with fault ``name`` in place (none for None)."""
    if name is None or name in faults.FAULTS:
        with faults.planted(name):
            yield
        return
    from repro_torch.kernels import gbdi_paged_attn as pa

    real, change = pa.ring_bounds, WINDOW_FAULTS[name]

    def ring_bounds(S, pos, pt, window):
        n_valid, cur, lo = real(S, pos, pt, window)
        return change(S, pos, pt, n_valid, cur, lo) if window else (n_valid, cur, lo)

    pa.ring_bounds = ring_bounds
    try:
        yield
    finally:
        pa.ring_bounds = real


def fault_reading(driver, cell, seed: int, seconds: float, device: torch.device,
                  fault: str) -> dict:
    """A set-up, a window with ``fault`` planted, the release and the check:
    ``{number: value}``."""
    state = driver.setup(cell, seed, device)
    with planted(fault):
        rec = driver.window(state, seconds, Tracer(False, device))
        sync(device)
    driver.release(state, rec)
    checks = driver.check(state, rec)
    del state, rec
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {k: v for k, (v, _) in checks.items()}


def readings(cell, seeds: list[int], n_control: int, seconds: float, device: torch.device,
             out=None, n_fault: int = 0, fault_seconds: float | None = None) -> dict:
    """``calibrate.readings``' program and control, and ``faults``: {fault:
    {number: [a reading a seed]}} over the first ``n_fault`` seeds."""
    got = calibrate.readings(cell, seeds, n_control, seconds, device, out=out)
    driver = harness.load_module(harness.BENCH, "drivers", cell.traffic["driver"])
    got["faults"] = {f: {} for f in FAULTS} if n_fault else {}
    for seed in seeds[:n_fault]:
        line = {"seed": seed, "faults": {}}
        for f in FAULTS:
            row = fault_reading(driver, cell, seed, fault_seconds or seconds, device, f)
            for k, v in row.items():
                got["faults"][f].setdefault(k, []).append(v)
            line["faults"][f] = row
        if out is not None:
            print(json.dumps(line), file=out, flush=True)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_029)
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
