"""Serving entry points over the compressed KV cache.

PyTorch counterpart of :mod:`repro.serving.engine`, with :class:`KVSession`
only; the batched ``Engine`` over a model comes with the model substrate.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core.format import TableLike
from repro_torch.serving import kv_cache
from repro_torch.serving.kv_cache import KVSpec


class KVSession:
    """Serving-shaped session over one compressed KV cache (single layer).

    Owns the cache and the decode position.  ``step`` is the per-token
    serving cost: append this token's K/V (a flush every ``page_tokens``
    tokens), then attend.  With ``spec.resident_decode`` and the ``auto``
    backend the attend reads the flush-maintained decoded region; without
    it ``auto`` attends over the compressed pages with the paged-attention
    kernel.  The cache lives on ``device``: the card unless ``"cpu"`` is
    asked for.
    """

    def __init__(self, spec: KVSpec, batch: int, table: TableLike, *,
                 backend: str = "auto", device: str | torch.device | None = None) -> None:
        self.spec, self.backend = spec, backend
        self.device = resolve_device(device)
        self.cache = kv_cache.init_compressed(spec, batch, table, device=self.device)
        self.pos = 0

    def prefill(self, ks: torch.Tensor, vs: torch.Tensor) -> None:
        """Append a whole (B, T, Kv, hd) context: one encode launch per side
        for every page it completes (see :func:`kv_cache.extend`)."""
        kv_cache.extend(self.spec, self.cache, ks, vs, self.pos)
        self.pos += int(ks.shape[1])

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one token's (B, 1, Kv, hd) K/V at the current position."""
        kv_cache.append(self.spec, self.cache, k, v, self.pos)
        self.pos += 1

    def step(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """One decode step: append this token's K/V, attend with ``q``
        (B, 1, H, hd) over everything appended so far.  Returns (B, 1, H*hd)."""
        self.append(k, v)
        return kv_cache.attention_decode(self.spec, q, self.cache, self.pos - 1,
                                         backend=self.backend)


__all__ = ["KVSession"]
