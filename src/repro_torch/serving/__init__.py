"""Serving on PyTorch: the batched engine, the GBDI-FR compressed KV cache
and the byte-budget continuous-batching scheduler.

* :mod:`repro_torch.serving.engine` — fixed-slot continuous batching
  (:class:`~repro_torch.serving.engine.Engine`) over the model's raw cache,
  per-slot decode positions, masked prefill-into-free-slot admission; and
  :class:`~repro_torch.serving.engine.KVSession`, the per-token session
  (prefill, append, step) over one compressed cache.
* :mod:`repro_torch.serving.kv_cache` — paged KV cache whose pages are
  GBDI-FR blobs (:class:`~repro_torch.serving.kv_cache.KVSpec`), with the
  optional resident decoded region and the ``oracle | resident | paged |
  auto`` decode-attention backends.
* :mod:`repro_torch.serving.scheduler` — admission/eviction policy under a
  KV byte budget with token-level per-request reservations
  (:class:`~repro_torch.serving.scheduler.Scheduler`).

Counterpart of :mod:`repro.serving`.
"""
from __future__ import annotations

from repro_torch.serving.engine import Engine, KVSession, Request
from repro_torch.serving.kv_cache import KV_FR, KVSpec
from repro_torch.serving.scheduler import (
    AdmissionError,
    RequestState,
    Scheduler,
    ServeRequest,
)

__all__ = [
    "AdmissionError",
    "Engine",
    "KVSession",
    "KV_FR",
    "KVSpec",
    "Request",
    "RequestState",
    "Scheduler",
    "ServeRequest",
]
