"""Domain-specific static analysis for the PyTorch / CUDA port.

Port of ``src/repro/analysis/__init__.py``.  The port's core invariant,
three hand-written CUDA kernels bit-identical to their plain PyTorch
versions against the normative ``docs/FORMAT.md``, is enforced at run time
by the parity tests and ``chip_smoke.py``, which fire *after* a bug ships.
This package is the before-review gate: an AST pass, importing nothing it
analyses, that knows the port's hazard families (see
``docs/ANALYSIS_TORCH.md`` for the catalog):

* **Torch/CUDA hot-path hazards** (:mod:`~repro_torch.analysis.torch_checkers`):
  host syncs in kernel launchers, compiled or captured functions and the
  serving tick (context propagated through the module-local call graph,
  :mod:`~repro_torch.analysis.callgraph`); Python branches on tensor
  values; raw ``data_ptr()``s launched unchecked and launch codes dropped;
  unseeded RNG; captured reads of mutated module globals.
* **Format invariants** (:mod:`~repro_torch.analysis.format_checkers`):
  magic mask/cap literals in ``kernels/``/``serving/``/``distributed/``,
  each kernel op's twins (plain, oracle, CUDA entry points, build entry),
  and ``docs/FORMAT.md`` §6 against the port's serializer and encoder.
* **Dataflow and budgets** (:mod:`~repro_torch.analysis.dataflow_checkers`,
  :mod:`~repro_torch.analysis.smem_cost`): side-stream lifetimes and
  non-blocking host copies, module-level memos with no bound, and the
  Hopper shared-memory and occupancy model of kernels A, B and C
  (``--smem-report``, ``--on-card``).

Entry points: ``python -m repro_torch.analysis [paths]`` and
:func:`run_analysis`.  Known-good exceptions live in the reviewed
``analysis-baseline-torch.json``, each with a justification.
"""
from __future__ import annotations

from repro_torch.analysis.base import Checker, all_checks, fast_checks, get_check
from repro_torch.analysis.baseline import Baseline, BaselineEntry, BaselineError
from repro_torch.analysis.engine import Report, run_analysis
from repro_torch.analysis.finding import Finding
from repro_torch.analysis.project import Project, SourceFile

__all__ = [
    "Baseline",
    "BaselineEntry",
    "BaselineError",
    "Checker",
    "Finding",
    "Project",
    "Report",
    "SourceFile",
    "all_checks",
    "fast_checks",
    "get_check",
    "run_analysis",
]
