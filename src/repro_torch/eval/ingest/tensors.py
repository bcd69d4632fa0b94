"""Tensor-file ingestion: raw binary, ``.npy``/``.npz``, pickled pytrees.

Real ML memory images rarely arrive as ELF cores — they are checkpoint
arrays, exported buffers, or pickled parameter trees.  Each loader here
frames arrays **by bit pattern** (the paper's view of memory) into one
:class:`~repro_torch.eval.ingest.container.DumpImage`:

* ``.npy``  — one array, one segment;
* ``.npz``  — one segment per member, in member order;
* ``.pkl``/``.pickle`` — a pickled (possibly nested) dict/list/tuple of
  arrays, e.g. a parameter tree saved with ``pickle.dump``; one
  segment per leaf, named by its tree path.  **Only unpickle files you
  trust** — pickle executes code;
* anything else — raw bytes at a caller-chosen word size.

Word framing is dtype-aware via
:func:`repro_torch.eval.codecs.word_bits_for_dtype`: 2-byte dtypes (bf16/fp16)
become 16-bit word streams, everything else 32-bit.  Mixed-dtype
containers take the word size of the majority of bytes (recorded per
segment in its note, and overridable at ingest time).  A bf16 ``.npy``
written with ``ml_dtypes`` loads here as ``V2`` (2-byte void), which frames
at 16 bits as the reference frames it.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from repro_torch.eval.codecs import word_bits_for_dtype
from repro_torch.eval.ingest.container import DumpImage, Segment

TENSOR_SUFFIXES = (".npy", ".npz", ".pkl", ".pickle")


def _segment(name: str, arr: np.ndarray) -> Segment:
    arr = np.asarray(arr)
    return Segment(name=name, data=arr, note=f"dtype={arr.dtype},shape={arr.shape}")


def _image(name: str, source: str, segs: list[tuple[Segment, int]],
           fmt: str, word_bits: int | None) -> DumpImage:
    if not segs:
        raise ValueError(f"{source}: no arrays to ingest")
    if word_bits is None:
        votes: dict[int, int] = {}
        for seg, wb in segs:
            votes[wb] = votes.get(wb, 0) + seg.n_bytes
        word_bits = max(votes, key=votes.get)
    return DumpImage(
        name=name, segments=[s for s, _ in segs], word_bits=word_bits,
        endian="little", source=source,
        meta={"format": fmt, "n_arrays": len(segs)},
    )


def read_npy(path: str | Path, *, name: str | None = None,
             word_bits: int | None = None) -> DumpImage:
    path = Path(path)
    arr = np.load(path, allow_pickle=False)
    seg = _segment(f"arr@{arr.dtype}", arr)
    return _image(name or path.stem, str(path),
                  [(seg, word_bits_for_dtype(arr.dtype))], "npy", word_bits)


def read_npz(path: str | Path, *, name: str | None = None,
             word_bits: int | None = None) -> DumpImage:
    path = Path(path)
    segs = []
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            arr = z[key]
            segs.append((_segment(f"{key}@{arr.dtype}", arr),
                         word_bits_for_dtype(arr.dtype)))
    return _image(name or path.stem, str(path), segs, "npz", word_bits)


def read_pytree_pickle(path: str | Path, *, name: str | None = None,
                       word_bits: int | None = None) -> DumpImage:
    """Pickled array pytree (dict/list/tuple nesting), e.g. saved model parameters.

    Pickle executes arbitrary code on load — only ingest files you made.
    """
    path = Path(path)
    with open(path, "rb") as f:
        tree = pickle.load(f)
    segs = []
    for key, leaf in _iter_leaves(tree, ""):
        arr = np.asarray(leaf)
        if arr.dtype == object or arr.size == 0:
            continue
        segs.append((_segment(f"{key}@{arr.dtype}", arr),
                     word_bits_for_dtype(arr.dtype)))
    return _image(name or path.stem, str(path), segs, "pytree", word_bits)


def read_raw(path: str | Path, *, name: str | None = None,
             word_bits: int = 32) -> DumpImage:
    """Raw binary: the whole file is one segment of ``word_bits`` words."""
    path = Path(path)
    data = np.frombuffer(path.read_bytes(), np.uint8)
    if data.size == 0:
        raise ValueError(f"{path}: empty file")
    return DumpImage(
        name=name or path.stem,
        segments=[Segment(name="raw", data=data.copy())],
        word_bits=word_bits, endian="little", source=str(path),
        meta={"format": "bin"},
    )


def read_tensor_file(path: str | Path, *, name: str | None = None,
                     word_bits: int | None = None) -> DumpImage:
    """Dispatch on suffix: .npy / .npz / .pkl|.pickle / raw binary."""
    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        return read_npy(path, name=name, word_bits=word_bits)
    if suffix == ".npz":
        return read_npz(path, name=name, word_bits=word_bits)
    if suffix in (".pkl", ".pickle"):
        return read_pytree_pickle(path, name=name, word_bits=word_bits)
    return read_raw(path, name=name, word_bits=word_bits or 32)


def _iter_leaves(tree, prefix: str):
    """Deterministic depth-first walk of dict/list/tuple nests (pickled
    trees must load without the model stack)."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _iter_leaves(tree[k], f"{prefix}{k}/" if prefix else f"{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/") or "leaf", tree
