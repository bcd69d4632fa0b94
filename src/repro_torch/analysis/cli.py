"""``python -m repro_torch.analysis`` — the port's analysis gate.

Port of ``src/repro/analysis/cli.py``.  With no paths it reads the port's
files: ``src/repro_torch``, the ``tests/test_torch_*.py`` tests, the
``*_torch.py`` scripts of ``benchmarks`` and ``examples``, and
``chip_smoke.py``.  Exit codes: 0 clean (all findings baselined), 1
unbaselined findings or stale baseline entries, 2 usage/parse/baseline
errors (and ``--on-card`` without a CUDA device).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Sequence

from repro_torch.analysis.base import all_checks, fast_checks, get_check
from repro_torch.analysis.baseline import Baseline, BaselineError
from repro_torch.analysis.engine import run_analysis
from repro_torch.analysis.project import ParseError, load_project

DEFAULT_BASELINE = "analysis-baseline-torch.json"
#: the default targets: (path under the root, file-name pattern or None for all)
DEFAULT_TARGETS = (
    ("src/repro_torch", None),
    ("tests", "test_torch_*.py"),
    ("benchmarks", "*_torch.py"),
    ("examples", "*_torch.py"),
    ("chip_smoke.py", None),
)


def default_paths(root: Path) -> list[Path]:
    """The port's files under ``root`` (:data:`DEFAULT_TARGETS`)."""
    out: list[Path] = []
    for rel, pattern in DEFAULT_TARGETS:
        p = root / rel
        if pattern is None:
            if p.exists():
                out.append(p)
        elif p.is_dir():
            out.extend(sorted(p.rglob(pattern)))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch/CUDA-aware static analysis for the PyTorch port "
                    "(see docs/ANALYSIS_TORCH.md)",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to analyse (default: src/repro_torch, "
                        "tests/test_torch_*.py, benchmarks/*_torch.py, "
                        "examples/*_torch.py, chip_smoke.py)")
    p.add_argument("--root", default=None,
                   help="repo root for relative paths/baseline identity "
                        "(default: cwd)")
    p.add_argument("--json", dest="json_out", metavar="FILE", default=None,
                   help="also write the full report as JSON ('-' for stdout)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"baseline file (default: <root>/{DEFAULT_BASELINE} "
                        "if it exists)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file; report everything")
    p.add_argument("--checks", default=None, metavar="ID[,ID...]",
                   help="run only these checker ids")
    p.add_argument("--fast", action="store_true",
                   help="file-scoped checkers only (the pre-commit subset)")
    p.add_argument("--list-checks", action="store_true",
                   help="print the checker catalog and exit")
    p.add_argument("--smem-report", dest="smem_report", metavar="FILE",
                   default=None,
                   help="also write the per-kernel shared-memory and occupancy "
                        "report as JSON ('-' for stdout); see analysis/smem_cost.py")
    p.add_argument("--on-card", dest="on_card", action="store_true",
                   help="add the card's columns to --smem-report (library shared "
                        "bytes, the runtime's blocks an SM, registers, spills); "
                        "needs a CUDA device")
    return p


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_checks:
        for c in all_checks():
            print(f"{c.id:24s} [{c.scope:7s}] {c.doc}")
        return 0
    if args.on_card and not args.smem_report:
        print("error: --on-card adds columns to --smem-report; give both", file=sys.stderr)
        return 2

    try:
        if args.checks:
            checkers = [get_check(cid.strip())
                        for cid in args.checks.split(",") if cid.strip()]
        elif args.fast:
            checkers = fast_checks()
        else:
            checkers = all_checks()
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    root = Path(args.root) if args.root else Path.cwd()
    if args.paths:
        paths = [p if Path(p).is_absolute() else root / p for p in args.paths]
    else:
        paths = default_paths(root)
    try:
        project = load_project(paths, root=root)
    except (ParseError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline = None
    if not args.no_baseline:
        bpath = Path(args.baseline) if args.baseline else root / DEFAULT_BASELINE
        if args.baseline or bpath.exists():
            try:
                baseline = Baseline.load(bpath)
            except BaselineError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2

    report = run_analysis(project, checks=checkers, baseline=baseline)

    if args.smem_report:
        from repro_torch.analysis import smem_cost

        costs = smem_cost.cost_report(project)
        if args.on_card:
            try:
                smem_cost.on_card(costs or [])
            except RuntimeError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        payload = json.dumps({
            "available": costs is not None,
            "on_card": bool(args.on_card),
            "kernels": [c.to_json() for c in costs or []],
        }, indent=2) + "\n"
        if args.smem_report == "-":
            sys.stdout.write(payload)
        else:
            Path(args.smem_report).write_text(payload, encoding="utf-8")

    if args.json_out:
        payload = json.dumps(report.to_json(), indent=2) + "\n"
        if args.json_out == "-":
            sys.stdout.write(payload)
        else:
            Path(args.json_out).write_text(payload, encoding="utf-8")

    print(report.render_text())
    return 0 if report.ok and not report.stale else 1
