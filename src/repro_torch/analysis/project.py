"""Source discovery and per-file parse state for the analysis pass.

Port of ``src/repro/analysis/project.py``, unchanged.

A :class:`Project` is the unit the engine runs over: a set of parsed
Python files plus the repo root they are relative to.  Checkers receive
either one :class:`SourceFile` at a time (per-file checkers — the fast,
pre-commit-friendly majority) or the whole project (cross-file checkers
like backend parity).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Iterator

#: directories never worth descending into
_SKIP_DIRS = {".git", ".venv", "__pycache__", "node_modules", ".mypy_cache",
              ".ruff_cache", ".pytest_cache", "build", "dist"}


@dataclasses.dataclass
class SourceFile:
    """One parsed source file plus the derived views checkers need."""

    path: Path                  # absolute
    rel: str                    # repo-root-relative posix path
    text: str
    tree: ast.Module
    lines: list[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.lines:
            self.lines = self.text.splitlines()

    @property
    def is_test(self) -> bool:
        """Test code gets looser rules (e.g. unseeded RNG is fine)."""
        parts = Path(self.rel).parts
        name = Path(self.rel).name
        return ("tests" in parts or name.startswith("test_")
                or name == "conftest.py")

    def anchor(self, lineno: int) -> str:
        """Stripped source text of a 1-indexed line (baseline identity)."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


@dataclasses.dataclass
class Project:
    root: Path
    files: list[SourceFile]

    def __post_init__(self) -> None:
        self.by_rel = {f.rel: f for f in self.files}

    def glob(self, prefix: str) -> list[SourceFile]:
        """Files whose repo-relative path starts with ``prefix``."""
        return [f for f in self.files if f.rel.startswith(prefix)]


class ParseError(Exception):
    """A target file failed to parse; analysis cannot vouch for it."""


def _iter_py(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_file():
            if p.suffix == ".py":
                yield p
        elif p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in sub.parts):
                    yield sub


def load_file(path: Path, root: Path) -> SourceFile:
    text = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        raise ParseError(f"{path}: {e}") from e
    try:
        rel = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    return SourceFile(path=path, rel=rel, text=text, tree=tree)


def load_project(paths: Iterable[str | Path], root: str | Path | None = None) -> Project:
    """Parse every ``.py`` under ``paths`` into a :class:`Project`.

    ``root`` defaults to the common working directory; repo-relative
    paths (used for scoping and baseline identity) are computed from it.
    """
    rootp = Path(root) if root is not None else Path.cwd()
    seen: set[Path] = set()
    files: list[SourceFile] = []
    for p in _iter_py(Path(p) for p in paths):
        rp = p.resolve()
        if rp in seen:
            continue
        seen.add(rp)
        files.append(load_file(p, rootp))
    return Project(root=rootp, files=files)
