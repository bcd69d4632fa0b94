"""Reviewed suppression list for known-good findings.

Port of ``src/repro/analysis/baseline.py``: the same file format and
matching, so the port reads a reference baseline as it is; the port's own
baseline is ``analysis-baseline-torch.json`` at the repo root.

The baseline is a checked-in JSON file whose entries each require a
human-written ``justification`` — an empty or missing justification is a
hard :class:`BaselineError`, not a finding.  Matching is on
``(check, path, anchor, occurrence)`` where *anchor* is the stripped
source line and *occurrence* its index among identical anchors in the
file, so entries survive unrelated edits that shift line numbers, but go
stale the moment the flagged line itself changes — stale entries are
reported so the file can't silently rot.  ``occurrence`` defaults to 0
when absent from the JSON (pre-occurrence baselines keep working); it
matters only when one file repeats the flagged line verbatim.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Iterable

from repro_torch.analysis.finding import Finding


class BaselineError(Exception):
    """Malformed baseline file (bad JSON, missing fields, no justification)."""


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    check: str
    path: str
    anchor: str
    justification: str
    occurrence: int = 0

    @property
    def key(self) -> tuple[str, str, str, int]:
        return (self.check, self.path, self.anchor, self.occurrence)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Baseline:
    entries: list[BaselineEntry] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._by_key = {e.key: e for e in self.entries}

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        p = Path(path)
        try:
            data = json.loads(p.read_text(encoding="utf-8"))
        except OSError as e:
            raise BaselineError(f"cannot read baseline {p}: {e}") from e
        except json.JSONDecodeError as e:
            raise BaselineError(f"baseline {p} is not valid JSON: {e}") from e
        if not isinstance(data, dict) or not isinstance(data.get("entries"), list):
            raise BaselineError(
                f"baseline {p} must be an object with an 'entries' list")
        entries = []
        for i, raw in enumerate(data["entries"]):
            if not isinstance(raw, dict):
                raise BaselineError(f"baseline {p}: entry {i} is not an object")
            missing = {"check", "path", "anchor", "justification"} - raw.keys()
            if missing:
                raise BaselineError(
                    f"baseline {p}: entry {i} missing field(s) {sorted(missing)}")
            just = raw["justification"]
            if not isinstance(just, str) or not just.strip():
                raise BaselineError(
                    f"baseline {p}: entry {i} ({raw['check']} @ {raw['path']}) "
                    "has an empty justification — every suppression must say why")
            occ = raw.get("occurrence", 0)
            if not isinstance(occ, int) or occ < 0:
                raise BaselineError(
                    f"baseline {p}: entry {i} ({raw['check']} @ {raw['path']}) "
                    "has a non-integer or negative occurrence index")
            entries.append(BaselineEntry(
                check=str(raw["check"]), path=str(raw["path"]),
                anchor=str(raw["anchor"]), justification=just.strip(),
                occurrence=occ))
        dupes = _duplicates(e.key for e in entries)
        if dupes:
            raise BaselineError(f"baseline {p}: duplicate entries {dupes}")
        return cls(entries=entries)

    def match(self, finding: Finding) -> BaselineEntry | None:
        return self._by_key.get(finding.key)

    def stale(self, findings: Iterable[Finding]) -> list[BaselineEntry]:
        """Entries that matched nothing — the flagged code changed or left."""
        seen = {f.key for f in findings}
        return [e for e in self.entries if e.key not in seen]

    def dump(self, path: str | Path) -> None:
        payload = {
            "comment": "Reviewed suppressions for python -m repro_torch.analysis. "
                       "Each entry must carry a justification; matching is on "
                       "(check, path, stripped source line, occurrence index "
                       "among identical lines).",
            "entries": [e.to_json() for e in self.entries],
        }
        Path(path).write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def _duplicates(
    keys: Iterable[tuple[str, str, str, int]],
) -> list[tuple[str, str, str, int]]:
    seen: set[tuple[str, str, str, int]] = set()
    out: list[tuple[str, str, str, int]] = []
    for k in keys:
        if k in seen:
            out.append(k)
        seen.add(k)
    return out
