"""Serving over the GBDI-FR compressed KV cache, on PyTorch.

* :mod:`repro_torch.serving.kv_cache` — paged KV cache whose pages are
  GBDI-FR blobs (:class:`~repro_torch.serving.kv_cache.KVSpec`), with the
  optional resident decoded region and the ``oracle | resident | paged |
  auto`` decode-attention backends.
* :mod:`repro_torch.serving.engine` — :class:`~repro_torch.serving.engine.KVSession`,
  the per-token session (prefill, append, step) over one cache.

Counterpart of :mod:`repro.serving`; the batched ``Engine`` and the
scheduler are not ported yet.
"""
from __future__ import annotations

from repro_torch.serving.engine import KVSession
from repro_torch.serving.kv_cache import KV_FR, KVSpec

__all__ = ["KV_FR", "KVSession", "KVSpec"]
