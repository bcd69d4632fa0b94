"""Streaming chunker/sampler + ``dump:<name>`` registry families.

A real dump can be arbitrarily large; an eval cell wants ``n_bytes`` of
representative words.  :func:`sample_stream` slices the image into
page-aligned chunks and draws a **deterministic** sample:

* images at or under the budget tile (``np.resize``) — value structure,
  not length, is what CR depends on, matching the synthetic families;
* larger images keep a seeded page subset **in address order**, so the
  inter-page locality GBDI's global bases exploit survives sampling
  (a shuffled sample would overstate base churn);
* the page seed mixes ``zlib.crc32`` of the dump name, never ``hash()``
  — the salted-hash seeding bug class is regression-tested in
  ``tests/test_eval.py``.

:func:`dump_workload` wraps a saved container as a lazily-loaded
:class:`~repro_torch.eval.registry.Workload` named ``dump:<name>`` with kind
``"Dump"``; :func:`scan_dump_dir` registers every container in a
directory, which is how ``repro_torch.eval.run --dump-dir`` (or the
``REPRO_DUMP_DIR`` env var) folds real dumps into every eval mode.
"""
from __future__ import annotations

import functools
import os
import zlib
from pathlib import Path

import numpy as np

from repro_torch.eval.ingest.container import DumpImage, load_meta
from repro_torch.eval.registry import Workload, WorkloadRegistry

PAGE_BYTES = 4096
DUMP_KIND = "Dump"
DUMP_PREFIX = "dump:"
DUMP_DIR_ENV = "REPRO_DUMP_DIR"
DEFAULT_DUMP_DIR = "experiments/dumps"


def default_dump_dir() -> str:
    return os.environ.get(DUMP_DIR_ENV, DEFAULT_DUMP_DIR)


def sample_stream(
    image: DumpImage,
    n_bytes: int,
    seed: int = 0,
    *,
    word_bits: int | None = None,
    page_bytes: int = PAGE_BYTES,
) -> np.ndarray:
    """Deterministic page-aligned word sample of ``n_bytes`` from ``image``.

    Returns unsigned words (``word_bits`` wide, native order); the raw
    bytes of the result are the workload stream.
    """
    if n_bytes <= 0:
        raise ValueError(f"n_bytes must be positive, got {n_bytes}")
    wb = word_bits or image.word_bits
    words = image.word_stream(wb)
    raw = words.view(np.uint8)
    if raw.size > n_bytes:
        wpp = max(1, page_bytes // (wb // 8))
        n_pages = -(-words.size // wpp)
        want = min(n_pages, -(-n_bytes // page_bytes))
        rng = np.random.default_rng(
            (seed ^ zlib.crc32(image.name.encode())) % (1 << 31))
        keep = np.sort(rng.choice(n_pages, size=want, replace=False))
        pad = (-words.size) % wpp
        paged = np.pad(words, (0, pad)).reshape(n_pages, wpp)
        raw = paged[keep].reshape(-1).view(np.uint8)
    out = np.resize(raw, n_bytes)
    pad = (-out.size) % (wb // 8)
    if pad:
        out = np.concatenate([out, np.zeros(pad, np.uint8)])
    return out.view(np.uint16 if wb == 16 else np.uint32)


_STAMP_TAIL_BYTES = 4096


def _freshness_stamp(path: str) -> tuple:
    """Cache key for a container file: (size, mtime_ns, tail crc32).

    ``(size, st_mtime_ns)`` alone is not enough: filesystems with coarse
    timestamp granularity report whole-second mtimes, so a same-second
    same-size rewrite (e.g. ``--force`` re-ingest in a script) would alias
    the stale entry.  The crc of the final 4 KiB closes that hole cheaply
    even for multi-GiB dumps — a zip's central directory (member sizes +
    CRCs) lives at the end of the file, so any payload change reaches it.
    """
    st = os.stat(path)
    with open(path, "rb") as f:
        f.seek(max(0, st.st_size - _STAMP_TAIL_BYTES))
        tail_crc = zlib.crc32(f.read(_STAMP_TAIL_BYTES))
    return (st.st_size, st.st_mtime_ns, tail_crc)


@functools.lru_cache(maxsize=8)
def _load_image_at(path: str, stamp: tuple) -> DumpImage:
    del stamp  # cache key only
    return DumpImage.load(path)


def _load_image(path: str) -> DumpImage:
    # keyed on (size, mtime_ns, tail crc) so rewriting a container
    # (--force re-ingest) serves the fresh bytes, not a stale cache hit —
    # even when the rewrite lands in the same whole-second mtime
    return _load_image_at(path, _freshness_stamp(path))


def dump_workload(path: str | Path, *, page_bytes: int = PAGE_BYTES) -> Workload:
    """A lazily-loading ``dump:<name>`` family for a saved container.

    Only ``__meta__`` is read here; segment bytes stay on disk until the
    first ``generate`` call (then an LRU of decoded images is kept).
    """
    path = str(Path(path))
    meta = load_meta(path)

    def generate(n_bytes: int, seed: int) -> np.ndarray:
        return sample_stream(_load_image(path), n_bytes, seed,
                             page_bytes=page_bytes)

    src = meta.get("meta", {}).get("format", "dump")
    return Workload(
        name=DUMP_PREFIX + meta["name"],
        kind=DUMP_KIND,
        generate=generate,
        word_bits=meta["word_bits"],
        description=f"real dump ({src}, {meta['n_bytes']} B, "
                    f"{meta['endian']}-endian) from {meta.get('source', path)}",
    )


def scan_dump_dir(
    registry: WorkloadRegistry, dump_dir: str | Path, *, strict: bool = False,
) -> list[str]:
    """Register every ``*.npz`` dump container under ``dump_dir``.

    Non-container / corrupt files are skipped with a warning unless
    ``strict`` — a dumps directory may share space with other artifacts.
    Returns the registered family names (sorted scan order, so registry
    contents are stable across runs).
    """
    dump_dir = Path(dump_dir)
    names: list[str] = []
    if not dump_dir.is_dir():
        return names
    for path in sorted(dump_dir.glob("*.npz")):
        try:
            names.append(registry.register(dump_workload(path)).name)
        except Exception as e:
            if strict:
                raise
            import warnings

            warnings.warn(f"skipping {path}: {type(e).__name__}: {e}",
                          stacklevel=2)
    return names
