"""The dump container: named byte segments + word-framing metadata.

Every ingestion path (ELF cores, tensor files, live captures) normalises
into one :class:`DumpImage` so the rest of the eval subsystem never cares
where bytes came from.  On disk a dump is a single ``<name>.npz``:

* ``__meta__`` — JSON (version, name, source, word_bits, endian, per-
  segment vaddr/dtype notes);
* ``seg<i>`` — one uint8 array per segment, in address order.

``.npz`` members are lazily loaded by numpy, so registry scans read only
``__meta__`` and the segment bytes stay on disk until a workload actually
generates a stream.  Word framing follows the paper's view of memory as a
stream of fixed-width words: ``word_stream`` reinterprets the concatenated
segment bytes at any word size/endianness, byteswapping big-endian images
to native order so codecs always see logical values.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import numpy as np

CONTAINER_VERSION = 1
_ENDIANS = ("little", "big")
#: family names must survive being a filename stem and a ``--suite`` token
#: (no path separators, no commas, no leading dot)
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


@dataclasses.dataclass
class Segment:
    """One contiguous run of dump bytes (a PT_LOAD, a tensor leaf, a map)."""

    name: str
    data: np.ndarray            # uint8, contiguous
    vaddr: int = 0              # source virtual address (0 if n/a)
    note: str = ""              # free-form provenance (dtype, perms, path)

    def __post_init__(self):
        self.data = np.ascontiguousarray(self.data).view(np.uint8).reshape(-1)

    @property
    def n_bytes(self) -> int:
        return int(self.data.size)


@dataclasses.dataclass
class DumpImage:
    """A named memory image: ordered segments + how to frame them as words.

    ``word_bits`` is the image's *natural* word size (16 for bf16 tensor
    dumps, else 32) — the registry family defaults to it, but
    :meth:`word_stream` can reframe at the other size.  ``endian`` is the
    byte order of the *source* image; streams are always returned in
    native order.
    """

    name: str
    segments: list[Segment]
    word_bits: int = 32
    endian: str = "little"
    source: str = ""
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(
                f"dump name {self.name!r} invalid: must match "
                "[A-Za-z0-9][A-Za-z0-9._-]* (it becomes a filename stem and "
                "a --suite token; pick a clean name via --name)")
        if self.word_bits not in (16, 32):
            raise ValueError(f"word_bits must be 16 or 32, got {self.word_bits}")
        if self.endian not in _ENDIANS:
            raise ValueError(f"endian must be one of {_ENDIANS}, got {self.endian!r}")
        if not self.segments:
            raise ValueError(f"dump {self.name!r} has no segments")

    @property
    def n_bytes(self) -> int:
        return sum(s.n_bytes for s in self.segments)

    def raw_bytes(self) -> np.ndarray:
        """All segment bytes concatenated in address order (uint8)."""
        return np.concatenate([s.data for s in self.segments])

    def word_stream(self, word_bits: int | None = None) -> np.ndarray:
        """The image as unsigned words (zero-padded to a whole word).

        Big-endian images are byteswapped so the returned array holds the
        source's logical word values in native order — what the paper's
        codec sees when the dumping and evaluating machines agree on
        words, not on bytes.
        """
        wb = self.word_bits if word_bits is None else word_bits
        if wb not in (16, 32):
            raise ValueError(f"word_bits must be 16 or 32, got {wb}")
        buf = self.raw_bytes()
        pad = (-buf.size) % (wb // 8)
        if pad:
            buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
        words = buf.view(np.uint16 if wb == 16 else np.uint32)
        if self.endian == "big":
            words = words.byteswap()
        return words

    # -- persistence --------------------------------------------------------

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {
            "version": CONTAINER_VERSION,
            "name": self.name,
            "source": self.source,
            "word_bits": self.word_bits,
            "endian": self.endian,
            "n_bytes": self.n_bytes,
            "meta": self.meta,
            "segments": [
                {"name": s.name, "vaddr": s.vaddr, "n_bytes": s.n_bytes,
                 "note": s.note}
                for s in self.segments
            ],
        }
        arrays = {f"seg{i}": s.data for i, s in enumerate(self.segments)}
        np.savez_compressed(path, __meta__=np.frombuffer(
            json.dumps(meta).encode(), np.uint8), **arrays)
        return path

    @classmethod
    def load(cls, path: str | Path) -> "DumpImage":
        path = Path(path)
        with np.load(path) as z:
            meta = _read_meta(z, path)
            segs = [
                Segment(name=m["name"], data=z[f"seg{i}"], vaddr=m["vaddr"],
                        note=m.get("note", ""))
                for i, m in enumerate(meta["segments"])
            ]
        return cls(name=meta["name"], segments=segs,
                   word_bits=meta["word_bits"], endian=meta["endian"],
                   source=meta.get("source", ""), meta=meta.get("meta", {}))


def load_meta(path: str | Path) -> dict:
    """Read only the ``__meta__`` member — cheap enough for registry scans
    (npz members are individually lazily decompressed)."""
    with np.load(path) as z:
        return _read_meta(z, path)


def _read_meta(z, path) -> dict:
    if "__meta__" not in z:
        raise ValueError(f"{path}: not a dump container (no __meta__ member)")
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("version") != CONTAINER_VERSION:
        raise ValueError(
            f"{path}: container version {meta.get('version')!r} "
            f"!= {CONTAINER_VERSION}")
    return meta
