"""Capture helpers: snapshot live memory into the dump container.

Two sources, same container:

* :func:`capture_process` — a real process image via ``/proc/<pid>/maps``
  + ``/proc/<pid>/mem`` (Linux).  **Guarded and opt-in**: reading another
  process's memory is invasive, so the caller must pass ``allow=True`` or
  set ``REPRO_ALLOW_PROC_CAPTURE=1``, and needs ptrace permission over
  the target (own processes, or root).  Unreadable maps are skipped, not
  fatal — kernels hide ``[vvar]``/device maps even from owners.
* :func:`capture_pytree` — a running model's parameter / optimizer /
  KV-cache tensors (nested dicts, lists and tuples of torch tensors or
  numpy arrays), one segment per leaf named by its tree path, in the
  reference's leaf order (:mod:`repro_torch._tree`).  This is how the ML
  families get a *real-serving* counterpart: snapshot a KV cache or
  train-step params mid-run and evaluate the actual bits the system holds.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from repro_torch._tree import path_str, tree_flatten_with_path
from repro_torch.eval.codecs import word_bits_for_dtype
from repro_torch.eval.ingest.container import DumpImage, Segment

_ALLOW_ENV = "REPRO_ALLOW_PROC_CAPTURE"
DEFAULT_MAX_BYTES = 64 << 20


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and the dtype name its segment carries:
    a bf16 tensor is stored as its uint16 bit pattern and named ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def capture_pytree(tree, name: str, *, word_bits: int | None = None,
                   source: str = "pytree") -> DumpImage:
    """Snapshot a tensor tree (params / grads / KV cache) by bit pattern.

    Leaves are pulled to the host (a device tensor is copied, which waits
    for the work that writes it), so this is a *consistent* snapshot of
    whatever the tensors held at call time.  Word size defaults to the
    dtype majority by bytes — bf16 trees frame as 16-bit words, fp32 trees
    as 32-bit.
    """
    segs: list[Segment] = []
    votes: dict[int, int] = {}
    for path, leaf in tree_flatten_with_path(tree):
        arr, dtype = _host_array(leaf)
        if arr.size == 0:
            continue
        key = path_str(path) or f"leaf{len(segs)}"
        seg = Segment(name=f"{key}@{dtype}", data=arr,
                      note=f"dtype={dtype},shape={tuple(arr.shape)}")
        segs.append(seg)
        votes[word_bits_for_dtype(arr.dtype)] = \
            votes.get(word_bits_for_dtype(arr.dtype), 0) + seg.n_bytes
    if not segs:
        raise ValueError("pytree has no non-empty array leaves")
    if word_bits is None:
        word_bits = max(votes, key=votes.get)
    return DumpImage(name=name, segments=segs, word_bits=word_bits,
                     endian="little", source=source,
                     meta={"format": "pytree", "n_arrays": len(segs)})


def capture_process(
    pid: int,
    *,
    allow: bool = False,
    name: str | None = None,
    max_bytes: int = DEFAULT_MAX_BYTES,
    writable_only: bool = True,
    word_bits: int = 32,
) -> DumpImage:
    """Snapshot a live process's mapped memory (Linux ``/proc`` only).

    ``writable_only=True`` keeps private writable anonymous/heap/stack
    maps — the mutable data a core dump would contain — and skips
    read-only file text.  Segments are read map-by-map; maps the kernel
    refuses (``EIO``/``EPERM`` on ``[vvar]`` etc.) are skipped.  Capture
    stops once ``max_bytes`` of content has been collected.
    """
    if not (allow or os.environ.get(_ALLOW_ENV) == "1"):
        raise PermissionError(
            "process capture is opt-in: pass allow=True or set "
            f"{_ALLOW_ENV}=1 (requires ptrace rights over the target)")
    maps_path = Path(f"/proc/{pid}/maps")
    if not maps_path.exists():
        raise FileNotFoundError(f"{maps_path}: no /proc maps (not Linux, or no such pid)")

    segments: list[Segment] = []
    total = 0
    skipped = 0
    with open(maps_path) as mf, open(f"/proc/{pid}/mem", "rb", buffering=0) as mem:
        for line in mf:
            fields = line.split()
            addrs, perms = fields[0], fields[1]
            pathname = fields[5] if len(fields) > 5 else ""
            if pathname in ("[vvar]", "[vsyscall]", "[vdso]"):
                continue
            if "r" not in perms or (writable_only and "w" not in perms):
                continue
            start, end = (int(x, 16) for x in addrs.split("-"))
            want = min(end - start, max_bytes - total)
            if want <= 0:
                break
            try:
                mem.seek(start)
                data = mem.read(want)
            except (OSError, ValueError, OverflowError):
                skipped += 1
                continue
            if not data:
                skipped += 1
                continue
            segments.append(Segment(
                name=f"map{len(segments)}@0x{start:x}",
                data=np.frombuffer(data, np.uint8).copy(), vaddr=start,
                note=f"perms={perms},path={pathname or '[anon]'}"))
            total += len(data)
            if total >= max_bytes:
                break
    if not segments:
        raise PermissionError(
            f"pid {pid}: no readable maps (need ptrace rights, e.g. own "
            "process or CAP_SYS_PTRACE)")
    return DumpImage(
        name=name or f"pid{pid}", segments=segments, word_bits=word_bits,
        endian="little", source=f"/proc/{pid}/mem",
        meta={"format": "proc", "pid": pid, "skipped_maps": skipped,
              "writable_only": writable_only})
