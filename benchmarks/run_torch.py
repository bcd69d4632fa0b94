"""Benchmark driver of the PyTorch port: one section per paper table/figure.

  PYTHONPATH=src python benchmarks/run_torch.py          # on the CUDA card

The counterpart of ``benchmarks/run.py``; it imports only ``repro_torch``
and the ``*_torch`` benchmarks beside it.  It runs the compression, kmeans,
throughput, gradcomp and kvcache sections on the card, then prints
``roofline/<arch>__<shape>,0,...`` lines from the dry-run JSONs when
``experiments/dryrun_torch`` exists (run ``python -m
repro_torch.launch.dryrun --all`` first for the full table).  A section
that raises is reported and the driver exits 1 after the others ran.
"""
from __future__ import annotations

import importlib.util
import sys
import traceback
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
SECTIONS = ("bench_compression_torch", "bench_kmeans_torch", "bench_throughput_torch",
            "bench_gradcomp_torch", "bench_kvcache_torch")


def _load(name: str) -> ModuleType:
    """A benchmark script beside this one, imported from its file."""
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    failures = 0
    for name in SECTIONS:
        try:
            _load(name).main([])
        except Exception:
            failures += 1
            print(f"{name},0,ERROR", file=sys.stderr)
            traceback.print_exc()

    try:
        roofline = _load("roofline_torch")
        if Path(roofline.DRYRUN_DIR).exists():
            cells = [c for c in roofline.load_cells() if c["mesh"] == "pod"]
            for r in roofline.rows(cells):
                print(f"roofline/{r['arch']}__{r['shape']},0,"
                      f"dom={r['dominant']};frac={r['roofline_frac']:.4f};"
                      f"c={r['compute_s']:.4f};m={r['memory_s']:.4f};x={r['collective_s']:.4f}")
    except Exception:
        failures += 1
        traceback.print_exc()

    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
