"""Run checkers over a project and fold in the baseline.

Port of ``src/repro/analysis/engine.py``; the summary line names
``repro_torch.analysis``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

from repro_torch.analysis.base import Checker, all_checks
from repro_torch.analysis.baseline import Baseline, BaselineEntry
from repro_torch.analysis.finding import Finding
from repro_torch.analysis.project import Project


@dataclasses.dataclass
class Report:
    """Outcome of one analysis run.

    ``new`` findings gate (exit 1); ``suppressed`` ones matched a
    justified baseline entry; ``stale`` baseline entries matched nothing
    and should be deleted.
    """

    new: list[Finding]
    suppressed: list[tuple[Finding, BaselineEntry]]
    stale: list[BaselineEntry]
    checks_run: list[str]
    files_scanned: int

    @property
    def ok(self) -> bool:
        return not self.new

    def to_json(self) -> dict[str, Any]:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "checks_run": self.checks_run,
            "new": [f.to_json() for f in self.new],
            "suppressed": [
                {**f.to_json(), "justification": e.justification}
                for f, e in self.suppressed
            ],
            "stale_baseline_entries": [e.to_json() for e in self.stale],
        }

    def render_text(self) -> str:
        lines: list[str] = []
        for f in self.new:
            lines.append(f.render())
        for e in self.stale:
            lines.append(
                f"stale baseline entry: [{e.check}] {e.path} anchored at "
                f"{e.anchor!r} no longer matches anything — delete it")
        n_supp = len(self.suppressed)
        lines.append(
            f"repro_torch.analysis: {len(self.new)} finding(s), {n_supp} baselined, "
            f"{len(self.stale)} stale baseline entr{'y' if len(self.stale) == 1 else 'ies'}, "
            f"{self.files_scanned} file(s), {len(self.checks_run)} check(s)")
        return "\n".join(lines)


def run_analysis(
    project: Project,
    checks: Sequence[Checker] | None = None,
    baseline: Baseline | None = None,
) -> Report:
    """Run ``checks`` (default: all registered) over ``project``."""
    checkers = list(checks) if checks is not None else all_checks()
    findings: list[Finding] = []
    for checker in checkers:
        findings.extend(checker.run(project))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    # disambiguate duplicate anchors: the i-th finding (in line order)
    # with the same (check, path, stripped line) gets occurrence=i, so a
    # baseline entry suppresses exactly one copy of a repeated line
    counts: dict[tuple[str, str, str], int] = {}
    for i, f in enumerate(findings):
        ident = (f.check, f.path, f.anchor)
        occ = counts.get(ident, 0)
        counts[ident] = occ + 1
        if occ != f.occurrence:
            findings[i] = dataclasses.replace(f, occurrence=occ)
    new: list[Finding] = []
    suppressed: list[tuple[Finding, BaselineEntry]] = []
    if baseline is None:
        new = findings
        stale: list[BaselineEntry] = []
    else:
        for f in findings:
            entry = baseline.match(f)
            if entry is None:
                new.append(f)
            else:
                suppressed.append((f, entry))
        # an entry is only stale if its checker actually ran this pass
        # (a --fast/--checks run must not condemn project-scoped entries)
        run_ids = {c.id for c in checkers}
        stale = [e for e in baseline.stale(findings) if e.check in run_ids]
    return Report(
        new=new,
        suppressed=suppressed,
        stale=stale,
        checks_run=[c.id for c in checkers],
        files_scanned=len(project.files),
    )


def findings_of(project: Project, check_ids: Iterable[str]) -> list[Finding]:
    """Convenience for tests: raw findings of selected checkers, no baseline."""
    from repro_torch.analysis.base import get_check

    out: list[Finding] = []
    for cid in check_ids:
        out.extend(get_check(cid).run(project))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    return out
