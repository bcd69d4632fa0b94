"""Multi-device front-end and double-buffered streams over the GBDI-FR codec.

PyTorch counterpart of ``src/repro/kernels/pipeline.py``.  This module owns
the orchestration around one codec call: device discovery, row padding and
splitting across devices, reassembly, host-to-device streams that overlap
the copy of one batch with the encode of the one before, and a split over
the ranks of a ``torch.distributed`` process group.  The per-batch work is
:func:`repro_torch.kernels.ops.encode_pages` / ``decode_pages``: the CUDA
kernels for a tensor on the card, the plain versions for one on the CPU.
Every path here is bit-identical to one such call on the same pages.

Devices follow the kind of the input tensor.  ``devices=None`` takes
:func:`auto_shards` devices of that kind: the count of cards for a CUDA
tensor (each card is a physical device, so one on a one-card machine) and
one for a CPU tensor.  An int wraps over the devices of that kind, as the
reference does (``devices=2`` on a one-card machine is the card twice,
``devices=4`` on a CPU tensor is the CPU four times).  A list is taken as
given; a device in it that is not present raises, and so does a CPU device
for a tensor on the card: the front-end never moves a CUDA tensor to the
host to take the plain path.

Differences from the reference, by design:

* no trace fall-through: the reference hands a traced caller (``jit``,
  ``shard_map``) straight to the XLA chain; eager PyTorch has no trace, so
  every call takes the paths below;
* ``unsigned=True`` returns int32 words masked to ``word_bits`` (torch has
  no full uint32 arithmetic): the values equal the reference's uint16 view
  for 16-bit words, and the bit patterns its uint32 view for 32-bit words;
* ``mode="spmd"`` runs over an initialised ``torch.distributed`` process
  group in place of ``pod_shard_map``: each rank codes its row slice on its
  own device and the blob rows (or words) are all-gathered.
"""
from __future__ import annotations

from collections.abc import Iterable, Iterator, Sequence
from typing import Any

import numpy as np
import torch

from repro_torch.core.format import WORD16_MASK, TableLike
from repro_torch.core.gbdi_fr import FRConfig, flat_blob, lead_blob
from repro_torch.kernels import ops
from repro_torch.kernels.gbdi_encode import PreparedTable, prepare_table

Devices = Sequence[Any] | int | None


def device_count(kind: str = "cuda") -> int:
    """Devices of ``kind`` this process sees: the cards for ``"cuda"``, one
    host for ``"cpu"``."""
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return 1
    raise ValueError(f"no devices of kind {kind!r}; choose 'cuda' or 'cpu'")


def local_devices(kind: str = "cuda") -> list[torch.device]:
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device(kind, i) for i in range(device_count(kind))]


def auto_shards(kind: str = "cuda") -> int:
    """Shards the auto path uses: every physical device of ``kind`` (the
    reference caps forced host devices at the core count; a card is a
    physical device, and the host is one)."""
    return max(1, device_count(kind))


def _check_present(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"device {dev} is not present ({torch.cuda.device_count()} "
                             "CUDA device(s))")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"the pipeline runs on cuda or cpu devices, not {dev}")
    return dev


def _resolve_devices(devices: Devices, like: torch.device) -> list[torch.device]:
    """The shard devices for a tensor on ``like``."""
    if devices is None:
        return local_devices(like.type)[:auto_shards(like.type)]
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        pool = local_devices(like.type)
        if not pool:
            raise ValueError(f"no {like.type} device present")
        return [pool[d % len(pool)] for d in range(devices)]
    devs = [_check_present(torch.device(d)) for d in devices]
    if not devs:
        raise ValueError("an empty device list")
    if like.type == "cuda" and any(d.type == "cpu" for d in devs):
        raise ValueError("a tensor on the card is not moved to the host: the device list "
                         f"{devs} names the CPU")
    return devs


def _prep(table: TableLike | PreparedTable, cfg: FRConfig, dev: torch.device
          ) -> TableLike | PreparedTable:
    """The table for calls on ``dev``: prepared (memoised) for the card; the
    plain path on the CPU takes the table as it is."""
    return prepare_table(table, cfg, dev) if dev.type == "cuda" else table


def _pad_rows(x: torch.Tensor, shards: int) -> torch.Tensor:
    pad = (-x.shape[0]) % shards
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _put(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``, queued: a host slice bound for the card is pinned
    first so its copy is asynchronous."""
    if x.device == dev:
        return x
    if x.device.type == "cpu" and dev.type == "cuda" and not x.is_pinned():
        x = x.pin_memory()
    return x.to(dev, non_blocking=True)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def encode_pages(
    x_pages: torch.Tensor,
    table: TableLike | PreparedTable,
    cfg: FRConfig,
    *,
    devices: Devices = None,
) -> dict[str, torch.Tensor]:
    """Encode ``(..., page_words)`` int32 pages, split across devices.

    ``devices=None`` picks :func:`auto_shards` devices of the tensor's kind;
    an int or a device list forces that many shards.  With one shard (or
    fewer than two rows a shard) the pages are coded where they lie.
    """
    lead = tuple(x_pages.shape[:-1])
    flat = x_pages.reshape(-1, cfg.page_words).contiguous()
    devs = _resolve_devices(devices, flat.device)
    if len(devs) <= 1 or flat.shape[0] < 2 * len(devs):
        blob = ops.encode_pages(flat, _prep(table, cfg, flat.device), cfg)
    else:
        blob = _encode_split(flat, table, cfg, devs)
    return lead_blob(blob, lead)


def _encode_split(flat: torch.Tensor, table: TableLike | PreparedTable, cfg: FRConfig,
                  devs: Sequence[torch.device]) -> dict[str, torch.Tensor]:
    n_rows = flat.shape[0]
    padded = _pad_rows(flat, len(devs))
    per = padded.shape[0] // len(devs)
    # every slice's copy is queued before the first launch, so slice d+1
    # transfers while slice d encodes
    shards = [_put(padded[d * per:(d + 1) * per], dev) for d, dev in enumerate(devs)]
    blobs = [ops.encode_pages(s, _prep(table, cfg, s.device), cfg) for s in shards]
    return {k: torch.cat([b[k].to(devs[0], non_blocking=True) for b in blobs])[:n_rows]
            for k in blobs[0]}


def encode_pages_sharded(
    x_pages: torch.Tensor,
    table: TableLike | PreparedTable,
    cfg: FRConfig,
    *,
    devices: Devices = None,
    mode: str = "split",
    group: Any = None,
) -> dict[str, torch.Tensor]:
    """Always-sharded encode: every listed device gets a row slice.

    ``mode="split"`` dispatches one call per device (``devices=None``: every
    device of the tensor's kind).  ``mode="spmd"`` splits the rows over the
    ranks of the process group ``group`` (the default group if None): each
    rank encodes its slice where the pages lie and the blob rows are
    all-gathered, so every rank returns the whole blob.
    """
    if mode not in ("split", "spmd"):
        raise ValueError(f"unknown mode {mode!r}; choose 'split' or 'spmd'")
    lead = tuple(x_pages.shape[:-1])
    flat = x_pages.reshape(-1, cfg.page_words).contiguous()
    if mode == "spmd":
        blob = _encode_spmd(flat, table, cfg, group)
    else:
        devs = (local_devices(flat.device.type) if devices is None
                else _resolve_devices(devices, flat.device))
        blob = _encode_split(flat, table, cfg, devs)
    return lead_blob(blob, lead)


def _gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    """All ranks' equal-shaped row slices, concatenated in rank order on
    ``x``'s device (gloo moves host tensors: a card's rows go through host
    memory)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    host = x.contiguous().cpu()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts).to(x.device)


def _rank_slice(flat: torch.Tensor, group: Any) -> torch.Tensor:
    """This rank's row slice of ``flat``, padded to a multiple of the ranks."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    padded = _pad_rows(flat, n)
    per = padded.shape[0] // n
    return padded[rank * per:(rank + 1) * per]


def _encode_spmd(flat: torch.Tensor, table: TableLike | PreparedTable, cfg: FRConfig,
                 group: Any) -> dict[str, torch.Tensor]:
    mine = _rank_slice(flat, group)
    blob = ops.encode_pages(mine, _prep(table, cfg, mine.device), cfg)
    return {k: _gather_rows(v, group)[:flat.shape[0]] for k, v in sorted(blob.items())}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_pages(
    blob: dict[str, torch.Tensor],
    table: TableLike | PreparedTable,
    cfg: FRConfig,
    *,
    devices: Devices = None,
    unsigned: bool = False,
) -> torch.Tensor:
    """Decode blobs with any leading axes to ``(..., page_words)`` int32
    words; the twin of :func:`encode_pages`.  ``unsigned=True`` masks the
    words to ``word_bits`` (module docstring)."""
    lead = tuple(blob["n_out"].shape)
    flat = flat_blob(blob)
    n_rows = flat["n_out"].shape[0]
    like = flat["ptrs"].device
    devs = _resolve_devices(devices, like)
    if len(devs) <= 1 or n_rows < 2 * len(devs):
        words = ops.decode_pages(flat, _prep(table, cfg, like), cfg)
    else:
        words = _decode_split(flat, table, cfg, devs)
    if unsigned and cfg.word_bits == 16:
        words = words & WORD16_MASK
    return words.reshape(lead + (cfg.page_words,))


def _decode_split(flat: dict[str, torch.Tensor], table: TableLike | PreparedTable,
                  cfg: FRConfig, devs: Sequence[torch.device]) -> torch.Tensor:
    n_rows = flat["n_out"].shape[0]
    # zero rows decode as valid all-zero-blob pages; the padding is stripped
    padded = {k: _pad_rows(v, len(devs)) for k, v in flat.items()}
    per = padded["n_out"].shape[0] // len(devs)
    shards = [{k: _put(v[d * per:(d + 1) * per], dev) for k, v in padded.items()}
              for d, dev in enumerate(devs)]
    parts = [ops.decode_pages(s, _prep(table, cfg, s["ptrs"].device), cfg) for s in shards]
    return torch.cat([p.to(devs[0], non_blocking=True) for p in parts])[:n_rows]


def decode_pages_sharded(
    blob: dict[str, torch.Tensor],
    table: TableLike | PreparedTable,
    cfg: FRConfig,
    *,
    devices: Devices = None,
    mode: str = "split",
    group: Any = None,
) -> torch.Tensor:
    """Always-sharded decode; mirrors :func:`encode_pages_sharded`."""
    if mode not in ("split", "spmd"):
        raise ValueError(f"unknown mode {mode!r}; choose 'split' or 'spmd'")
    lead = tuple(blob["n_out"].shape)
    flat = flat_blob(blob)
    if mode == "spmd":
        n_rows = flat["n_out"].shape[0]
        mine = {k: _rank_slice(v, group) for k, v in flat.items()}
        words = ops.decode_pages(mine, _prep(table, cfg, mine["ptrs"].device), cfg)
        words = _gather_rows(words, group)[:n_rows]
    else:
        like = flat["ptrs"].device
        devs = local_devices(like.type) if devices is None else _resolve_devices(devices, like)
        words = _decode_split(flat, table, cfg, devs)
    return words.reshape(lead + (cfg.page_words,))


# ---------------------------------------------------------------------------
# double-buffered host -> device streams
# ---------------------------------------------------------------------------

class _Stager:
    """Two slots of pinned staging and device landing buffers, and a copy
    stream, for host batches bound for one card.  Batch ``i`` goes through
    slot ``i % 2``.  A slot's pinned buffers are written again only after
    its last copy has landed (``copied``); its landing buffers are copied
    into again only after the compute stream has used them (``consumed``).
    The buffers are allocated once a stream, so no batch allocates device
    memory across streams.  A batch already in pinned memory is copied from
    where it lies, one already on the card is used as it is."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.copy_stream = torch.cuda.Stream(dev)
        self.compute = torch.cuda.current_stream(dev)
        self.pinned: list[dict[str, torch.Tensor]] = [{}, {}]
        self.land: list[dict[str, torch.Tensor]] = [{}, {}]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.consumed = [torch.cuda.Event(), torch.cuda.Event()]
        self.used = [False, False]
        self.i = 0

    def _buffer(self, pool: dict[str, torch.Tensor], key: str, src: torch.Tensor,
                **where: Any) -> tuple[torch.Tensor, bool]:
        """A view of ``pool[key]`` shaped like ``src``; True if it was (re)made."""
        buf = pool.get(key)
        fresh = buf is None or buf.numel() < src.numel() or buf.dtype != src.dtype
        if fresh:
            buf = pool[key] = torch.empty(src.numel(), dtype=src.dtype, **where)
        return buf[:src.numel()].view(src.shape), fresh

    def put(self, batch: dict[str, torch.Tensor]) -> tuple[int, dict[str, torch.Tensor]]:
        """Queue ``batch``'s copy on the copy stream; returns its slot and
        the device tensors, valid on the compute stream after :meth:`take`."""
        slot = self.i % 2
        self.i += 1
        out, srcs, fresh, waited = {}, {}, False, not self.used[slot]
        for k, v in batch.items():
            if v.device.type == "cuda":
                out[k] = v
                continue
            if not v.is_pinned():
                if not waited:
                    self.copied[slot].synchronize()    # the slot's pinned buffers are free
                    waited = True
                staged, _ = self._buffer(self.pinned[slot], k, v, pin_memory=True)
                v = staged.copy_(v)
            out[k], made = self._buffer(self.land[slot], k, v, device=self.dev)
            srcs[k] = v
            fresh |= made
        if fresh:
            # a new landing buffer may reuse memory the compute stream still reads
            self.copy_stream.wait_stream(self.compute)
        elif self.used[slot]:
            self.copy_stream.wait_event(self.consumed[slot])
        with torch.cuda.stream(self.copy_stream):
            for k, v in srcs.items():
                out[k].copy_(v, non_blocking=True)
        self.copied[slot].record(self.copy_stream)
        self.used[slot] = True
        return slot, out

    def take(self, slot: int, out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        self.compute.wait_event(self.copied[slot])
        return out

    def release(self, slot: int) -> None:
        """The compute stream's launches that read ``slot`` are queued."""
        self.consumed[slot].record(self.compute)

    def close(self) -> None:
        """No landing buffer is freed while a copy into it may be in flight."""
        for slot in (0, 1):
            if self.used[slot]:
                self.compute.wait_event(self.copied[slot])


def _as_host(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def _stream(batches: Iterable[dict[str, Any]], dev: torch.device, fn: Any) -> Iterator[Any]:
    """``fn(batch on dev)`` for each host batch, in order, with the copy of
    batch i+1 queued before batch i's launch."""
    it = iter(batches)
    if dev.type != "cuda":
        for b in it:
            yield fn({k: _as_host(v).to(dev) for k, v in b.items()})
        return
    stager = _Stager(dev)
    try:
        try:
            pending = stager.put({k: _as_host(v) for k, v in next(it).items()})
        except StopIteration:
            return
        for nxt in it:
            slot, cur = pending
            cur = stager.take(slot, cur)
            pending = stager.put({k: _as_host(v) for k, v in nxt.items()})
            result = fn(cur)
            stager.release(slot)
            yield result
        slot, cur = pending
        result = fn(stager.take(slot, cur))
        stager.release(slot)
        yield result
    finally:
        stager.close()


def encode_stream(
    batches: Iterable[Any],
    table: TableLike | PreparedTable,
    cfg: FRConfig,
    *,
    device: str | torch.device | None = None,
) -> Iterator[dict[str, torch.Tensor]]:
    """Encode a stream of host page batches (numpy or CPU tensors, any
    leading axes), double-buffered.

    On the card each batch is staged in pinned memory and copied on a side
    stream; the compute stream waits on the batch's event, so batch i+1's
    copy is in flight while batch i encodes.  Yields one blob per batch, in
    order, on ``device`` (the card if None), each bit-identical to one
    :func:`repro_torch.kernels.ops.encode_pages` call on that batch.
    """
    from repro_torch._device import resolve_device

    dev = _check_present(resolve_device(device))
    prep = _prep(table, cfg, dev)

    def enc(b: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        x = b["x"]
        lead = tuple(x.shape[:-1])
        blob = ops.encode_pages(x.reshape(-1, cfg.page_words).contiguous(), prep, cfg)
        return lead_blob(blob, lead)

    yield from _stream(({"x": x} for x in batches), dev, enc)


def decode_stream(
    blobs: Iterable[dict[str, Any]],
    table: TableLike | PreparedTable,
    cfg: FRConfig,
    *,
    device: str | torch.device | None = None,
) -> Iterator[torch.Tensor]:
    """Decode a stream of blob batches, double-buffered host -> device like
    :func:`encode_stream` (a batch already on the card is used where it
    lies).  Yields one ``(..., page_words)`` word tensor per blob, in
    order, bit-identical to :func:`repro_torch.kernels.ops.decode_pages`."""
    from repro_torch._device import resolve_device

    dev = _check_present(resolve_device(device))
    prep = _prep(table, cfg, dev)

    def dec(b: dict[str, torch.Tensor]) -> torch.Tensor:
        lead = tuple(b["n_out"].shape)
        return ops.decode_pages(flat_blob(b), prep, cfg).reshape(lead + (cfg.page_words,))

    yield from _stream(blobs, dev, dec)


__all__ = ["auto_shards", "decode_pages", "decode_pages_sharded",
           "decode_stream", "device_count", "encode_pages", "encode_pages_sharded",
           "encode_stream", "local_devices"]
