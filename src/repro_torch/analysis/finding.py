"""The unit of analysis output: one finding at one source location.

Port of ``src/repro/analysis/finding.py``, unchanged: the baseline identity
is ``(check, path, anchor, occurrence)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic emitted by a checker.

    ``anchor`` is the stripped source line the finding points at.  The
    baseline matches on ``(check, path, anchor, occurrence)`` rather
    than the line *number*, so unrelated edits above a suppressed line
    do not invalidate its baseline entry.  ``occurrence`` disambiguates
    duplicate stripped lines in one file (0 = first match in line
    order): without it, one baseline entry would silently suppress
    *every* copy of a repeated line.  :func:`repro_torch.analysis.engine.
    run_analysis` assigns it after sorting.
    """

    check: str        # checker id, e.g. "cuda-host-sync"
    path: str         # repo-relative posix path
    line: int         # 1-indexed
    col: int          # 0-indexed
    message: str
    anchor: str       # stripped source text of the flagged line
    occurrence: int = 0   # index among same-(check, path, anchor) findings

    @property
    def key(self) -> tuple[str, str, str, int]:
        """The baseline-matching identity of this finding."""
        return (self.check, self.path, self.anchor, self.occurrence)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: [{self.check}] {self.message}"
