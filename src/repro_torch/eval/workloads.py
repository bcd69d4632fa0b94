"""Workload families of the port's main path, generated with numpy from a seed.

Copies of the reference generators, so both packages see the same words:

* ``605.mcf_s`` and ``col_int_keys`` — :func:`spec_mcf`, :func:`col_int_keys`,
  :func:`_interleave`, :func:`_stable_seed` and :func:`generate` from
  ``src/repro/data/workloads.py``;
* ``ml_kvcache_bf16`` — channel-structured attention K/V in bf16, from
  ``src/repro/eval/workloads.py``; float32 -> bf16 rounds to nearest even in
  torch, as it does in JAX.

Only the generation is numpy; nothing here touches the card.
"""
from __future__ import annotations

import functools
import zlib
from typing import Callable

import numpy as np
import torch

from repro_torch.eval.registry import Workload, WorkloadRegistry


def _interleave(rng: np.random.Generator, parts: list[np.ndarray]) -> np.ndarray:
    """Concatenate in 64-byte-block units and shuffle blocks, like pages of
    a real heap mixing allocation types."""
    blocks = []
    for arr in parts:
        a = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        pad = (-a.size) % 64
        if pad:
            a = np.concatenate([a, np.zeros(pad, np.uint8)])
        blocks.append(a.reshape(-1, 64))
    all_blocks = np.concatenate(blocks)
    rng.shuffle(all_blocks)
    return all_blocks.reshape(-1).view(np.uint32)


def spec_mcf(rng: np.random.Generator, n_bytes: int) -> np.ndarray:
    """Pointer-chasing graph: node structs = {ptr, ptr, int, int}."""
    n = n_bytes // 16
    heap = np.uint64(0x7F3A_0000_0000)
    ptrs1 = (heap + rng.integers(0, 1 << 26, n).astype(np.uint64) * 16).view(np.uint64)
    ptrs2 = (heap + rng.integers(0, 1 << 26, n).astype(np.uint64) * 16).view(np.uint64)
    ints = rng.integers(0, 4000, (n, 2)).astype(np.int32)
    rec = np.empty((n, 4), np.uint32)
    rec[:, 0] = (ptrs1 & 0xFFFFFFFF).astype(np.uint32)
    rec[:, 1] = (ptrs1 >> 32).astype(np.uint32)
    rec[:, 2:] = ints.view(np.uint32).reshape(n, 2)
    del ptrs2   # drawn for the reference's random stream, not stored
    return _interleave(rng, [rec, np.zeros(n // 4, np.uint32)])


def col_int_keys(rng: np.random.Generator, n_bytes: int) -> np.ndarray:
    """Sorted 64-bit surrogate keys (skewed gaps) + epoch-second timestamps."""
    n = n_bytes // 8
    gaps = np.minimum(rng.zipf(1.7, n // 2), 1 << 12).astype(np.uint64)
    keys = (np.uint64(1) << np.uint64(40)) + np.cumsum(gaps)
    ts = (np.uint64(1_700_000_000) + np.cumsum(rng.poisson(3, n // 2))).astype(np.uint64)
    return _interleave(rng, [keys.view(np.uint32), ts.astype(np.uint32)])


WORKLOADS: dict[str, tuple[str, Callable[[np.random.Generator, int], np.ndarray]]] = {
    "605.mcf_s": ("C", spec_mcf),
    "col_int_keys": ("Column", col_int_keys),
}


def _stable_seed(name: str, seed: int) -> int:
    # not hash(): Python string hashing is salted per process
    return (seed ^ zlib.crc32(name.encode())) % (1 << 31)


def generate(name: str, n_bytes: int = 4 << 20, seed: int = 0) -> np.ndarray:
    _kind, fn = WORKLOADS[name]
    return fn(np.random.default_rng(_stable_seed(name, seed)), n_bytes)


def _fit_bytes(buf: np.ndarray, n_bytes: int) -> np.ndarray:
    """Tile/trim a byte view to n_bytes (structure matters, length doesn't)."""
    raw = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return np.resize(raw, n_bytes)


def _to_bf16_words(x: np.ndarray) -> np.ndarray:
    bf = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return bf.view(torch.int16).numpy().view(np.uint16)


def ml_kvcache_bf16(n_bytes: int, seed: int) -> np.ndarray:
    """Channel-structured attention K/V in bf16 (per-channel means + noise)."""
    n_kv, hd = 4, 32
    rng = np.random.default_rng(seed)
    n_tok = max(1, n_bytes // (2 * n_kv * hd))
    ch = rng.normal(0, 1, (1, n_kv, hd)) * 2            # per-channel means
    kv = (ch + rng.normal(0, 0.1, (n_tok, n_kv, hd))).astype(np.float32)
    return _fit_bytes(_to_bf16_words(kv.reshape(-1)), n_bytes).view(np.uint16)


def default_workloads() -> WorkloadRegistry:
    """The port's registry: the main-path families above."""
    reg = WorkloadRegistry()
    for name, (kind, fn) in WORKLOADS.items():
        reg.register(Workload(
            name=name, kind=kind,
            generate=functools.partial(generate, name), word_bits=32,
            description=(fn.__doc__ or "").strip().splitlines()[0],
        ))
    reg.register(Workload(
        name="ml_kvcache_bf16", kind="ML", generate=ml_kvcache_bf16, word_bits=16,
        description="channel-structured attention K/V, bf16",
    ))
    return reg
