"""Continuous-batching request scheduler with compressed-KV memory-pressure
admission, on PyTorch.

Counterpart of :mod:`repro.serving.scheduler`; host policy (numpy and the
standard library) over :class:`repro_torch.serving.engine.Engine`, copied
so the port imports nothing of the JAX package.

The serving payoff is resident sequences per byte of device memory:
GBDI-FR pages cut each sequence's KV footprint by the fixed rate, so at an
equal byte budget the compressed cache holds more concurrent sequences.

* **FIFO+priority queue** — requests are served highest priority first,
  FIFO within a priority class (a heap keyed ``(-priority, arrival_seq)``).
* **Byte-budget admission** — a request is admitted only when a free
  engine slot exists AND its KV bytes fit the budget.  The per-sequence
  cost is token-level: each request reserves
  ``KVSpec.compressed_bytes_upto(1, prompt + max_new)`` (or
  ``raw_bytes_upto`` for the raw-cache baseline) times the model's
  attention layer count — its own final context, not the cache ceiling.
* **Eviction to a host-side parking buffer** — when the queue head
  outranks a resident sequence, the lowest-priority decoding sequence
  (cheapest context first) is parked: its tokens already live host-side,
  the engine slot is freed, and on resume the scheduler re-prefills
  ``prompt + generated`` in one dispatch and continues decoding —
  bit-identical to never having been parked.  A sequence that is
  mid-prefill is never an eviction candidate, and eviction only fires for
  strictly higher priority, so eviction chains terminate.
* **Lifecycle states** — QUEUED → PREFILLING → DECODING → (PARKED →
  PREFILLING → …) → DONE, with REJECTED for requests that can never fit
  (prompt bytes alone exceed the budget, prompt longer than the cache):
  those raise :class:`AdmissionError` instead of queueing forever.
* **Counters** — admissions, resumes, evictions, rejections, tokens,
  peak resident sequences/bytes; ``resident_bytes`` is maintained
  incrementally and returns to zero when the system drains.

Driven by ``benchmarks/serving_bench_torch.py`` and
``examples/serve_demo_torch.py``.  Wall-clock stamps (``submit_t``,
``first_token_t``, ``done_t``) are host ``perf_counter`` reads; on the
card they are real because the engine moves every step's tokens to the
host before the scheduler stamps them.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import time
from typing import Any

import numpy as np
import numpy.typing as npt

from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kv_cache import KVSpec


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    PARKED = "parked"
    DONE = "done"
    REJECTED = "rejected"


class AdmissionError(ValueError):
    """A request that can never be admitted under the configured budget —
    raised at submit time so it fails loudly instead of queueing forever."""


@dataclasses.dataclass
class ServeRequest:
    """One request's host-side record: the prompt and every generated
    token live here (this IS the parking buffer), plus lifecycle state and
    latency bookkeeping in scheduler ticks and wall-clock seconds."""

    rid: int
    prompt: npt.NDArray[np.int32]       # (S,)
    max_new: int = 16
    priority: int = 0
    state: RequestState = RequestState.QUEUED
    out: list[int] = dataclasses.field(default_factory=list)
    submit_tick: int = 0
    admit_tick: int | None = None       # first admission (queue latency)
    first_token_tick: int | None = None
    done_tick: int | None = None
    evictions: int = 0
    submit_t: float = 0.0
    first_token_t: float | None = None
    done_t: float | None = None
    # internal: engine linkage while resident
    _slot: int | None = dataclasses.field(default=None, repr=False)
    _engine_req: Request | None = dataclasses.field(default=None, repr=False)
    _base_out: list[int] = dataclasses.field(default_factory=list, repr=False)
    _seq: int = dataclasses.field(default=0, repr=False)
    # KV bytes this request reserves while resident: its own final
    # context (prompt + max_new, clipped to the cache ceiling), fixed at
    # submit so the reservation is identical across park/resume cycles
    _reserved: int = dataclasses.field(default=0, repr=False)

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.out)


class Scheduler:
    """Admission/eviction policy around one :class:`Engine`.

    ``byte_budget`` caps the summed KV bytes of resident sequences; the
    per-sequence cost comes from ``kv_spec`` (defaulting to the model's
    own :meth:`repro_torch.models.api.Model.kv_cache_spec` at the engine's
    ``max_len``) under the chosen ``accounting``:

    * ``'compressed'`` — ``n_kv_layers * spec.compressed_bytes_upto(1,
      prompt + max_new)``: the GBDI-FR page + tail footprint the
      request's own final context actually keeps resident.
    * ``'raw'`` — the same context under ``raw_bytes_upto``: the
      uncompressed baseline; at an equal budget it admits fewer
      concurrent sequences, which is exactly the headline
      ``BENCH_serving_torch.json`` measures.

    ``bytes_per_seq`` (the old static ``max_len`` slot cost) remains the
    worst-case per-sequence bound — benchmarks size budgets with it.
    """

    def __init__(self, engine: Engine, *, byte_budget: int,
                 kv_spec: KVSpec | None = None,
                 accounting: str = "compressed") -> None:
        if accounting not in ("compressed", "raw"):
            raise ValueError(f"unknown accounting {accounting!r}; "
                             "choose from ('compressed', 'raw')")
        self.engine = engine
        self.spec = kv_spec if kv_spec is not None \
            else engine.model.kv_cache_spec(engine.max_len)
        self.n_kv_layers = max(1, engine.model.n_kv_layers)
        self.accounting = accounting
        per_layer = (self.spec.compressed_bytes(1) if accounting == "compressed"
                     else self.spec.raw_bytes(1))
        self.bytes_per_seq = self.n_kv_layers * per_layer
        self.byte_budget = int(byte_budget)
        self.resident_bytes = 0           # incremental; drains back to 0
        self.ticks = 0
        self.requests: dict[int, ServeRequest] = {}
        self._queue: list[tuple[int, int, ServeRequest]] = []
        self._next_seq = 0
        self._next_rid = 0
        self.counters = {
            "submitted": 0, "rejected": 0, "admitted": 0, "resumed": 0,
            "evicted": 0, "finished": 0, "tokens": 0,
            "peak_resident": 0, "peak_resident_bytes": 0,
        }

    # -- byte accounting ----------------------------------------------------

    def prompt_bytes(self, n_tokens: int) -> int:
        """Irreducible bytes to hold just an ``n_tokens`` prompt — the
        reject-at-submit floor (< the full static-slot ``bytes_per_seq``)."""
        upto = (self.spec.compressed_bytes_upto if self.accounting == "compressed"
                else self.spec.raw_bytes_upto)
        return self.n_kv_layers * upto(1, n_tokens)

    def reserve_bytes(self, req: ServeRequest) -> int:
        """Token-level KV reservation for one request: the bytes its own
        final context (``prompt + max_new``, clipped to the cache ceiling)
        will occupy — not the static ``max_len`` slot, so short sequences
        don't pre-pay for headroom they can never use."""
        final_ctx = min(self.engine.max_len, len(req.prompt) + req.max_new)
        return self.prompt_bytes(final_ctx)

    @property
    def resident(self) -> list[ServeRequest]:
        return [r for r in self.requests.values()
                if r.state in (RequestState.PREFILLING, RequestState.DECODING)]

    # -- submission ---------------------------------------------------------

    def submit(self, prompt: Any, *, max_new: int = 16, priority: int = 0) -> ServeRequest:
        """Enqueue one request; raises :class:`AdmissionError` for requests
        that could never run (even with every other sequence evicted)."""
        prompt = np.asarray(prompt, np.int32)
        req = ServeRequest(rid=self._next_rid, prompt=prompt, max_new=max_new,
                           priority=priority, submit_tick=self.ticks,
                           submit_t=time.perf_counter(), _seq=self._next_seq)
        self._next_rid += 1
        self._next_seq += 1
        self.requests[req.rid] = req
        self.counters["submitted"] += 1
        pb = self.prompt_bytes(len(prompt))
        if len(prompt) > self.engine.max_len:
            req.state = RequestState.REJECTED
            self.counters["rejected"] += 1
            raise AdmissionError(
                f"request {req.rid}: prompt of {len(prompt)} tokens exceeds "
                f"the cache ceiling max_len={self.engine.max_len}")
        if pb > self.byte_budget:
            req.state = RequestState.REJECTED
            self.counters["rejected"] += 1
            raise AdmissionError(
                f"request {req.rid}: prompt alone needs {pb} KV bytes "
                f"({self.accounting} accounting) > byte budget "
                f"{self.byte_budget} — it can never be admitted")
        req._reserved = self.reserve_bytes(req)
        if req._reserved > self.byte_budget:
            req.state = RequestState.REJECTED
            self.counters["rejected"] += 1
            raise AdmissionError(
                f"request {req.rid}: its final context of "
                f"{min(self.engine.max_len, len(prompt) + max_new)} tokens "
                f"costs {req._reserved} KV bytes ({self.accounting} "
                f"accounting) > byte budget {self.byte_budget}")
        heapq.heappush(self._queue, (-priority, req._seq, req))
        return req

    # -- parking / eviction -------------------------------------------------

    def park(self, rid: int) -> None:
        """Evict one decoding sequence to the host-side parking buffer:
        its tokens already live in ``req.prompt``/``req.out``, so parking
        is just releasing the engine slot.  Resume re-prefills
        ``prompt + out`` transparently on the next admission."""
        req = self.requests[rid]
        if req.state is not RequestState.DECODING:
            raise ValueError(f"request {rid} is {req.state.name}, only "
                             "DECODING sequences can be parked")
        self._sync(req)
        assert req._slot is not None
        self.engine.release(req._slot)
        req._slot = None
        req._engine_req = None
        req.state = RequestState.PARKED
        req.evictions += 1
        self.resident_bytes -= req._reserved
        self.counters["evicted"] += 1
        # original arrival seq: a parked sequence resumes ahead of later
        # arrivals of its own priority class (FIFO fairness)
        heapq.heappush(self._queue, (-req.priority, req._seq, req))

    def _select_victim(self, min_priority: int) -> ServeRequest | None:
        """Lowest-priority resident strictly below ``min_priority``,
        cheapest re-prefill (shortest context) first.  Sequences that are
        mid-prefill are never candidates: their slot's cache rows are
        being written this very step and parking them would waste the
        whole prefill (and the state they'd resume from is undefined)."""
        victims = [r for r in self.resident
                   if r.state is RequestState.DECODING
                   and r.priority < min_priority]
        if not victims:
            return None
        return min(victims, key=lambda r: (r.priority, r.context_len, r._seq))

    # -- the scheduling loop ------------------------------------------------

    def step(self) -> bool:
        """One scheduler tick: reap finished slots, admit/resume under the
        byte budget (evicting outranked sequences if needed), then decode
        one token for every resident sequence.  Returns True while any
        request is still queued, parked, or resident."""
        self._reap()
        self._admit()
        if self.engine.tick():
            for r in self.resident:
                self._sync(r)
        self._reap()
        self.ticks += 1
        return bool(self._queue) or bool(self.resident)

    def run(self, max_ticks: int = 100_000) -> list[ServeRequest]:
        """Drive :meth:`step` until the system drains; returns finished
        requests.  ``max_ticks`` guards against scheduling livelock — it
        raises rather than spinning silently."""
        while self.step():
            if self.ticks >= max_ticks:
                raise RuntimeError(
                    f"scheduler did not drain within {max_ticks} ticks: "
                    f"{self.state_counts()}")
        return [r for r in self.requests.values()
                if r.state is RequestState.DONE]

    # -- introspection ------------------------------------------------------

    def state_counts(self) -> dict[str, int]:
        counts = {s.name: 0 for s in RequestState}
        for r in self.requests.values():
            counts[r.state.name] += 1
        return counts

    # -- internals ----------------------------------------------------------

    def _sync(self, req: ServeRequest) -> None:
        """Pull the engine's freshly decoded tokens into the host-side
        record (TTFT stamps on the first one)."""
        er = req._engine_req
        assert er is not None
        new = req._base_out + er.out
        if len(new) > len(req.out):
            self.counters["tokens"] += len(new) - len(req.out)
            if req.first_token_tick is None:
                req.first_token_tick = self.ticks
                req.first_token_t = time.perf_counter()
            req.out = new

    def _reap(self) -> None:
        for req in self.resident:
            er = req._engine_req
            if er is not None and er.done:
                self._sync(req)
                assert req._slot is not None
                self.engine.release(req._slot)
                req._slot = None
                req._engine_req = None
                req.state = RequestState.DONE
                req.done_tick = self.ticks
                req.done_t = time.perf_counter()
                self.resident_bytes -= req._reserved
                self.counters["finished"] += 1

    def _admit(self) -> None:
        free = sum(1 for r in self.engine.slot_req if r is None)
        batch: list[ServeRequest] = []
        while self._queue:
            _, _, head = self._queue[0]
            if head.state not in (RequestState.QUEUED, RequestState.PARKED):
                heapq.heappop(self._queue)      # stale heap entry
                continue
            pending = sum(r._reserved for r in batch)
            fits_bytes = (self.resident_bytes + pending + head._reserved
                          <= self.byte_budget)
            if free > 0 and fits_bytes:
                heapq.heappop(self._queue)
                batch.append(head)
                free -= 1
                continue
            victim = self._select_victim(head.priority)
            if victim is None:
                break                           # pressure, nobody outranked
            self.park(victim.rid)
            free += 1
        if batch:
            self._admit_batch(batch)

    def _admit_batch(self, batch: list[ServeRequest]) -> None:
        for req in batch:
            req.state = RequestState.PREFILLING
            if req.admit_tick is None:
                req.admit_tick = self.ticks
        engine_reqs: list[Request] = []
        for req in batch:
            resume = bool(req.out)
            ctx = (np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
                   if resume else req.prompt)
            remaining = req.max_new - len(req.out)
            assert remaining > 0, "finished requests are never re-admitted"
            er = Request(req.rid, ctx, max_new=remaining)
            req._engine_req = er
            req._base_out = list(req.out)
            engine_reqs.append(er)
            self.counters["resumed" if resume else "admitted"] += 1
        n = self.engine.admit(engine_reqs)
        assert n == len(batch), "scheduler admission exceeded engine slots"
        self.resident_bytes += sum(r._reserved for r in batch)
        for req in batch:
            req._slot = self.engine.slot_req.index(req._engine_req)
            req.state = RequestState.DECODING
            self._sync(req)                      # the prefill's first token
        self.counters["peak_resident"] = max(
            self.counters["peak_resident"], len(self.resident))
        self.counters["peak_resident_bytes"] = max(
            self.counters["peak_resident_bytes"], self.resident_bytes)


__all__ = ["AdmissionError", "RequestState", "Scheduler", "ServeRequest"]
