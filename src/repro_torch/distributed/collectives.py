"""GBDI-FR compressed cross-pod gradient exchange over ``torch.distributed``.

PyTorch counterpart of ``src/repro/distributed/collectives.py``.  The
inter-pod links are the slow tier, so gradients cross them in GBDI-FR
form: each leaf is cast to bf16, its 16-bit words are paged and encoded
under :data:`GRAD_FR` through :func:`repro_torch.kernels.pipeline.encode_pages`
(kernel A on the card), and the blobs travel a ring of ``n_pods - 1`` hops
to rank + 1.  Every rank decodes each blob it receives
(:func:`~repro_torch.kernels.pipeline.decode_pages`, kernel B) and adds it
in float32 in the reference's order: its own leaf first, then the blob
from rank - 1, then rank - 2, ...; the sum is divided by ``n_pods`` and
cast back to the leaf's dtype.

The reference runs the ring inside ``pod_shard_map`` with ``ppermute``;
here the process group takes the place of the pod axis, and a hop is one
``dist.batch_isend_irecv`` of the blob tensors, packed into one int32
buffer.  Under gloo the buffer is staged through pinned host memory, so
the hop crosses the host: the slow tier the reference models.  A world of
one returns the gradients unchanged and encodes nothing.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.format import (
    DEFAULT_NUM_BASES,
    DEFAULT_OUTLIER_CAP,
    DEFAULT_PAGE_WORDS,
    BaseTable,
)
from repro_torch.core.gbdi_fr import FRConfig, bf16_to_words, words_to_bf16
from repro_torch.kernels import pipeline as fr_pipeline

#: gradients are quality-critical: one 8-bit class with a full-page bucket,
#: so bucket overflow cannot occur; outlier-table overflow (> 64 no-fit words
#: a page) still drops words, counted in ``blob['n_dropped']``.  Tables must
#: be fitted under this config (``Trainer._refit_fr``).
GRAD_FR = FRConfig(word_bits=16, page_words=DEFAULT_PAGE_WORDS,
                   num_bases=DEFAULT_NUM_BASES, width_set=(8,),
                   bucket_caps=(DEFAULT_PAGE_WORDS,),
                   outlier_cap=DEFAULT_OUTLIER_CAP)

#: blob fields in wire order
WIRE_FIELDS = ("deltas", "n_dropped", "n_out", "n_spilled", "out_idx", "out_vals", "ptrs")


def _encode_leaf(g: torch.Tensor, table: Any) -> dict[str, torch.Tensor]:
    """All pages of a leaf's bf16 words in one encode call on its device."""
    words = bf16_to_words(g.reshape(-1))
    words = torch.nn.functional.pad(words, (0, (-words.numel()) % GRAD_FR.page_words))
    return fr_pipeline.encode_pages(words.reshape(-1, GRAD_FR.page_words), table, GRAD_FR)


def _decode_leaf(blob: dict[str, torch.Tensor], table: Any, like: torch.Tensor) -> torch.Tensor:
    """A received blob back to a float32 tensor of ``like``'s shape."""
    words = fr_pipeline.decode_pages(blob, table, GRAD_FR).reshape(-1)[:like.numel()]
    return words_to_bf16(words).to(torch.float32).reshape(like.shape)


def _pack(blobs: list[dict[str, torch.Tensor]]) -> torch.Tensor:
    return torch.cat([b[k].reshape(-1) for b in blobs for k in WIRE_FIELDS])


def _unpack(buf: torch.Tensor, like: list[dict[str, torch.Tensor]]) -> list[dict[str, torch.Tensor]]:
    out, at = [], 0
    for b in like:
        blob = {}
        for k in WIRE_FIELDS:
            n = b[k].numel()
            blob[k] = buf[at:at + n].view(b[k].shape)
            at += n
        out.append(blob)
    return out


def _hop(buf: torch.Tensor, group: Any) -> torch.Tensor:
    """Send ``buf`` to rank + 1 and receive rank - 1's, through pinned host
    memory where the backend moves host tensors (gloo)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    via_host = buf.device.type == "cuda" and dist.get_backend(group) == "gloo"
    send = buf
    if via_host:
        send = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        send.copy_(buf)
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=via_host)
    peer = (lambda r: dist.get_global_rank(group, r)) if group is not None else (lambda r: r)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, peer((rank + 1) % n), group),
        dist.P2POp(dist.irecv, recv, peer((rank - 1) % n), group)])
    for r in reqs:
        r.wait()
    return recv.to(buf.device, non_blocking=True) if via_host else recv


def compressed_pod_mean(grads: Any, table: BaseTable | Any, *, group: Any = None,
                        n_pods: int | None = None, stats: dict | None = None) -> Any:
    """The cross-pod mean of ``grads`` over the ranks of ``group`` (the
    default group), gradients crossing in GBDI-FR form.  Exact for
    in-capacity pages (bf16 transport).  ``stats``, if given, receives the
    bytes this rank sent (``wire_bytes``) and the words its encodes dropped
    (``n_dropped``)."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    n = world if n_pods is None else n_pods
    if n != world:
        raise ValueError(f"n_pods={n_pods} but the process group has {world} ranks")
    if n == 1:
        return grads
    leaves = tree_leaves(grads)
    acc = [g.to(torch.float32) for g in leaves]
    blobs = [_encode_leaf(g, table) for g in leaves]
    if stats is not None:
        stats["n_dropped"] = int(sum(int(b["n_dropped"].sum()) for b in blobs))
        stats["wire_bytes"] = 0
    cur = _pack(blobs)
    for _ in range(n - 1):
        cur = _hop(cur, group)
        if stats is not None:
            stats["wire_bytes"] += cur.numel() * cur.element_size()
        for i, (blob, g) in enumerate(zip(_unpack(cur, blobs), leaves)):
            acc[i] = acc[i] + _decode_leaf(blob, table, g)
    out = iter([(a / n).to(g.dtype) for a, g in zip(acc, leaves)])
    return tree_map(lambda _: next(out), grads)


def plain_pod_mean(grads: Any, *, group: Any = None) -> Any:
    """The cross-pod mean by a float32 all-reduce (staged through the host
    for a card's tensors under gloo)."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return grads

    def mean(g: torch.Tensor) -> torch.Tensor:
        t = g.to(torch.float32)
        host = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
        buf = t.cpu() if host else t.clone()
        dist.all_reduce(buf, group=group)
        return (buf.to(g.device) / n).to(g.dtype)

    return tree_map(mean, grads)


def compressed_crosspod_mean(grads: Any, table: BaseTable | Any) -> Any:
    """The train step's hook: :func:`compressed_pod_mean` over the default
    group; unchanged gradients where there is no group or a world of one."""
    return compressed_pod_mean(grads, table)


__all__ = ["GRAD_FR", "WIRE_FIELDS", "compressed_crosspod_mean", "compressed_pod_mean",
           "plain_pod_mean"]
