"""The port's workload table: the synthetic dump families plus ``ml_kvcache_bf16``.

PyTorch counterpart of :mod:`repro.eval.workloads`:

* the twelve C, Java and Column families come from
  :mod:`repro_torch.data.workloads` (copies of the reference generators, so
  both packages see the same bytes);
* ``ml_kvcache_bf16`` — channel-structured attention K/V in bf16, from
  ``src/repro/eval/workloads.py``; float32 -> bf16 rounds to nearest even in
  torch, as it does in JAX.

The ML families that need a model (weights, AdamW moments, gradients) and
the ``dump:<name>`` families of real images are not ported yet.  Only the
generation is numpy; nothing here touches the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.data.workloads import WORKLOADS, generate
from repro_torch.eval.registry import Workload, WorkloadRegistry


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
    """The port's registry: every dump family, then ``ml_kvcache_bf16``."""
    reg = WorkloadRegistry()
    for name, (kind, fn) in WORKLOADS.items():
        reg.register(Workload(
            name=name, kind=kind,
            generate=functools.partial(generate, name), word_bits=32,
            description=fn.__doc__.strip().splitlines()[0] if fn.__doc__ else "",
        ))
    reg.register(Workload(
        name="ml_kvcache_bf16", kind="ML", generate=ml_kvcache_bf16, word_bits=16,
        description="channel-structured attention K/V, bf16",
    ))
    return reg


__all__ = ["WORKLOADS", "default_workloads", "generate", "ml_kvcache_bf16"]
