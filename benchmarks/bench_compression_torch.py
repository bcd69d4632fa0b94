"""Paper §VI main result on the PyTorch port: GBDI and B∆I over every family.

  PYTHONPATH=src python benchmarks/bench_compression_torch.py               # on the CUDA card
  PYTHONPATH=src python benchmarks/bench_compression_torch.py --device cpu

The counterpart of ``benchmarks/bench_compression.py``: per-workload CR for
GBDI and the B∆I baseline over every family the port registers (the paper's
C and Java dump classes, the column-store and ML-tensor families, and any
real ``dump:<name>`` images ingested with ``python -m repro_torch.eval.ingest``:
pass ``--dump-dir`` or set ``REPRO_DUMP_DIR``), verified per cell inside
:mod:`repro_torch.eval`, with the paper's per-kind geomeans.  Validation
targets (paper): Java ~1.55x, C ~1.4x, overall 1.4-1.45x, GBDI > BDI; real
dumps have no paper target.  It imports only ``repro_torch``.
"""
from __future__ import annotations

import argparse

from repro_torch.eval.codecs import default_codecs
from repro_torch.eval.registry import EvalCell
from repro_torch.eval.run import csv_lines, evaluate, geomean
from repro_torch.eval.workloads import default_workloads

MB = 4 << 20


def run(n_bytes: int = MB, seed: int = 0, suite: str = "all", codecs: str = "gbdi,bdi",
        device: str | None = None, dump_dir: str | None = None) -> list[EvalCell]:
    cells = evaluate(default_workloads(dump_dir, device=device), default_codecs(device),
                     suite=suite, codecs=codecs, n_bytes=n_bytes, seed=seed)
    bad = [f"{c.workload}/{c.codec}: {c.error}" for c in cells if not c.verified]
    if bad:
        raise RuntimeError(f"cells failed verification: {bad}")
    return cells


def summarize(cells: list[EvalCell]) -> dict:
    gbdi = [c for c in cells if c.codec == "gbdi"]

    def by_kind(kind: str) -> list[float]:
        return [c.compression_ratio for c in gbdi if c.kind == kind]

    return {
        "cr_c_avg": geomean(by_kind("C")),
        "cr_java_avg": geomean(by_kind("Java")),
        "cr_column_avg": geomean(by_kind("Column")),
        "cr_ml_avg": geomean(by_kind("ML")),
        "cr_dump_avg": geomean(by_kind("Dump")),
        "cr_all_avg": geomean(c.compression_ratio for c in gbdi),
        "cr_bdi_avg": geomean(c.compression_ratio for c in cells if c.codec == "bdi"),
        "paper_c": 1.4, "paper_java": 1.55, "paper_all": 1.45,
    }


def main(argv: list[str] | None = None) -> tuple[list[EvalCell], dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--suite", default="all")
    ap.add_argument("--codec", default="gbdi,bdi")
    ap.add_argument("--bytes", type=int, default=MB, dest="n_bytes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    ap.add_argument("--dump-dir", default=None,
                    help="registers ingested dump:<name> families "
                         "(default: $REPRO_DUMP_DIR or experiments/dumps)")
    args = ap.parse_args(argv)
    cells = run(n_bytes=args.n_bytes, seed=args.seed, suite=args.suite, codecs=args.codec,
                device=args.device, dump_dir=args.dump_dir)
    for line in csv_lines(cells):
        print(line.replace("eval/", "compression/", 1))
    s = summarize(cells)
    print(f"compression/summary,0,"
          f"c={s['cr_c_avg']:.3f};java={s['cr_java_avg']:.3f};"
          f"column={s['cr_column_avg']:.3f};ml={s['cr_ml_avg']:.3f};"
          f"dump={s['cr_dump_avg']:.3f};"
          f"all={s['cr_all_avg']:.3f};bdi={s['cr_bdi_avg']:.3f};"
          f"paper_c={s['paper_c']};paper_java={s['paper_java']};"
          f"device={cells[0].device};power_limit={cells[0].power_limit}")
    return cells, s


if __name__ == "__main__":
    main()
