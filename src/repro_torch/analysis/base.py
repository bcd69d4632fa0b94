"""Checker protocol and registry.

Port of ``src/repro/analysis/base.py``.  A checker is a named callable over
either one file (``scope='file'``) or the whole project
(``scope='project'``).  File-scoped checkers form the *fast* subset: they
need no cross-file state, so a pre-commit hook can run them on just the
changed files.  Registration happens at import time via :func:`register`;
the registry is the single source the CLI and the docs catalog test
enumerate.  It is a list of :class:`Checker` in registration order (the
reference keys a dict by id), looked up by a scan: a few dozen entries,
each added once by a decorator at import.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Literal

from repro_torch.analysis.finding import Finding
from repro_torch.analysis.project import Project, SourceFile

FileCheckFn = Callable[[SourceFile], Iterator[Finding]]
ProjectCheckFn = Callable[[Project], Iterator[Finding]]


@dataclasses.dataclass(frozen=True)
class Checker:
    id: str
    doc: str                                  # one-line catalog description
    scope: Literal["file", "project"]
    fn: FileCheckFn | ProjectCheckFn

    def run(self, project: Project) -> Iterator[Finding]:
        if self.scope == "project":
            yield from self.fn(project)  # type: ignore[arg-type]
        else:
            for f in project.files:
                yield from self.fn(f)  # type: ignore[arg-type]


_CHECKERS: list[Checker] = []


def register(
    id: str, doc: str, scope: Literal["file", "project"] = "file"
) -> Callable[[FileCheckFn | ProjectCheckFn], FileCheckFn | ProjectCheckFn]:
    """Decorator: add a checker function to the registry."""

    def deco(fn: FileCheckFn | ProjectCheckFn) -> FileCheckFn | ProjectCheckFn:
        if any(c.id == id for c in _CHECKERS):
            raise ValueError(f"duplicate checker id {id!r}")
        _CHECKERS.append(Checker(id=id, doc=doc, scope=scope, fn=fn))
        return fn

    return deco


def _ensure_loaded() -> None:
    # importing the checker modules populates the registry
    from repro_torch.analysis import (  # noqa: F401
        dataflow_checkers,
        format_checkers,
        smem_cost,
        torch_checkers,
    )


def all_checks() -> list[Checker]:
    _ensure_loaded()
    return sorted(_CHECKERS, key=lambda c: c.id)


def fast_checks() -> list[Checker]:
    """The per-file subset a pre-commit hook runs on changed files only."""
    return [c for c in all_checks() if c.scope == "file"]


def get_check(id: str) -> Checker:
    for c in all_checks():
        if c.id == id:
            return c
    known = ", ".join(c.id for c in all_checks())
    raise KeyError(f"unknown checker {id!r} (known: {known})")
