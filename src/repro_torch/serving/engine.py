"""Serving entry points: the batched engine over a model and the session
over one compressed KV cache.

PyTorch counterpart of :mod:`repro.serving.engine`.  :class:`Engine` is
fixed-slot continuous batching over the model's raw stacked cache: each
slot holds one sequence and owns its decode position (``slot_pos``), new
requests prefill into free slots while other slots are mid-decode (the
prefill runs over the full batch and only the admitted rows' cache lines
are adopted, :meth:`repro_torch.models.api.Model.prefill_into`), and every
tick decodes one token for all active slots.  :class:`KVSession` drives
one GBDI-FR compressed cache, the serving variant the decode benchmarks
measure.  Both run where their model or cache lives: the card unless the
CPU is asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import numpy.typing as npt
import torch

from repro_torch._device import resolve_device
from repro_torch.core.format import TableLike
from repro_torch.models.api import Model
from repro_torch.serving import kv_cache
from repro_torch.serving.kv_cache import KVSpec


@dataclasses.dataclass
class Request:
    rid: int
    prompt: npt.NDArray[np.int32]       # (S,)
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Fixed-slot continuous batching over ``model``'s raw cache, on the
    model's device.

    ``params`` is the model's parameter tree, kept for the reference's
    signature: when given it is registered on ``model`` with
    :meth:`Model.set_params` (the model's methods read its own registered
    parameters), so it replaces the weights of every other engine or caller
    that holds the same model; ``None`` serves the parameters the model
    already holds.  The model's methods run eagerly, so unlike the
    reference there is no per-model compiled pair to cache.
    """

    def __init__(self, model: Model, params: Any = None, *,
                 batch_slots: int = 4, max_len: int = 256) -> None:
        if params is not None:
            model.set_params(params)
        self.model = model
        self.device = model.device
        self.B, self.max_len = batch_slots, max_len
        self.cache = model.init_cache(batch_slots, max_len)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)  # per-slot next write pos

    def _next_tokens(self, logits: torch.Tensor) -> npt.NDArray[np.int64]:
        """Greedy next token of every batch row, moved to the host in one copy
        (on the card, the sync that makes a host-clock TTFT real)."""
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def admit(self, reqs: list[Request]) -> int:
        """Prefill a batch of requests into free slots (same-length prompts
        share one prefill; mixed lengths run one masked prefill per
        distinct length).

        Admission works mid-generation: each prefill computes over every
        batch row, but only the admitted rows' cache lines are merged in,
        and per-slot positions mean in-flight rows keep decoding at their
        own offsets, bit-stable.

        Grouping by prompt length is a correctness requirement: padding a
        shorter prompt into a longer batch shifts its RoPE positions and
        parks pad-token KV under the decode positions it is about to use,
        so its continuation diverges from a solo admit.  One prefill per
        distinct length keeps every admit bit-identical to admitting that
        request alone.
        """
        for i in range(self.B):  # done slots are released wholesale
            held = self.slot_req[i]
            if held is not None and held.done:
                self.release(i)
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        take = reqs[: len(free)]
        if not take:
            return 0
        by_len: dict[int, list[Request]] = {}
        for r in take:
            by_len.setdefault(len(r.prompt), []).append(r)
        slot_it = iter(free)
        for S, group in sorted(by_len.items()):
            slots = [next(slot_it) for _ in group]
            toks = np.zeros((self.B, S), np.int32)
            mask = np.zeros(self.B, bool)
            for slot, r in zip(slots, group):
                toks[slot] = r.prompt
                self.slot_req[slot] = r
                mask[slot] = True
            self.cache, logits = self.model.prefill_into(
                {"tokens": toks}, self.cache, torch.from_numpy(mask))
            nxt = self._next_tokens(logits)
            for slot, r in zip(slots, group):
                self.slot_pos[slot] = S
                r.out.append(int(nxt[slot]))
        return len(take)

    def release(self, slot: int) -> Request | None:
        """Free one slot (the scheduler's eviction/parking hook).  The KV
        rows are left in place: they are invisible to decode (masked by the
        per-slot position) and fully overwritten by the next prefill into
        the slot."""
        r = self.slot_req[slot]
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        return r

    def tick(self) -> bool:
        """Decode one token for every active slot. Returns any-active."""
        live = [(i, r) for i, r in enumerate(self.slot_req)
                if r is not None and not r.done]
        if not live:
            return False
        for i, r in live:
            # per-slot cache ceiling: decoding at position p writes KV row
            # p, so the last decodable position is max_len - 1; a slot is
            # done only once slot_pos passes it.  Truncating frees the slot.
            if self.slot_pos[i] >= self.max_len or len(r.out) >= r.max_new:
                r.done = True
        live = [(i, r) for i, r in live if not r.done]
        if not live:
            return False
        last = np.zeros((self.B, 1), np.int32)
        for i, r in enumerate(self.slot_req):
            if r is not None and not r.done and r.out:
                last[i, 0] = r.out[-1]
        # a copy: slot_pos is bumped in place below, and on the CPU
        # torch.as_tensor would share its memory
        pos = torch.tensor(self.slot_pos, device=self.device)
        logits, self.cache = self.model.decode_step({"tokens": last}, self.cache, pos)
        nxt = self._next_tokens(logits)
        for i, r in live:
            self.slot_pos[i] += 1
            r.out.append(int(nxt[i]))
            if len(r.out) >= r.max_new or self.slot_pos[i] >= self.max_len:
                r.done = True
        return any(r is not None and not r.done for r in self.slot_req)


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


__all__ = ["Engine", "KVSession", "Request"]
