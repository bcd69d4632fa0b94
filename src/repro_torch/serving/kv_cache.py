"""Paged KV cache with GBDI-FR compressed pages, on PyTorch.

PyTorch counterpart of :mod:`repro.serving.kv_cache`.  Decode re-reads the
whole KV cache for every generated token, so the cache's bytes are the
decode step's memory wall; GBDI-FR pages cut them by the fixed rate.

Layout per attention layer (structure of arrays, static shapes):

  pages:   ptrs (B, n_slots, ptr_lanes)  deltas (B, n_slots, delta_lanes)
           out_vals/out_idx (B, n_slots, cap)  n_out (B, n_slots)
           [profile (B, n_slots) for adaptive configs]
  tail:    k/v raw ring (B, page_tokens, Kv, hd) bf16 — the newest tokens
  table:   the fitted BaseTable
  [k_dec/v_dec (B, n_pages*page_tokens, Kv, hd) bf16 with resident_decode]

``n_slots = n_pages * pages_per_row``; a row wider than a page
(``pages_per_row > 1``) fills several slots per token: slot ``t * ppr + j``
holds heads ``[j * Kv / ppr, (j + 1) * Kv / ppr)`` of token ``t``, the row's
words in order.  Otherwise a page holds ``page_tokens = page_words //
(Kv*hd)`` consecutive tokens' K (or V).

A sliding-window layer (``KVSpec.window = W``; a query at ``pos`` attends
over ``[pos - W + 1, pos]``, as ``models/layers.py``'s mask) keeps its pages
in a ring of ``ceil(W / page_tokens)`` slots: page ``p`` is flushed into
slot ``p % n_pages``, over a page the window no longer reaches
(``gbdi_paged_attn.ring_bounds`` shows why), and counted in
``pages.evicted`` when that slot held one.  Window and full layers of one
model are caches side by side, each with its own spec.

Appends go to the raw tail; when it fills, it is compressed into the next
page slot with the encode kernel, and with ``resident_decode`` that blob
is decoded once into the resident region with the decode kernel.
:func:`attention_decode` attends over the compressed pages and the raw
tail with the paged-attention kernel, which merges the tail in on the card
(``paged``), or over a decoded view (``oracle``, ``resident``).

Unlike the reference, which builds a new cache tree on every call, the
port updates the cache's tensors in place: :func:`append` and
:func:`extend` write into the page slots, the tail ring and the resident
region, and return the same dict.  Positions are Python ints.  K and V are
cached with RoPE already applied, so pages are position-final.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core.format import (
    DEFAULT_NUM_BASES,
    DEFAULT_OUTLIER_CAP,
    DEFAULT_PAGE_WORDS,
    TableLike,
    as_base_table,
)
from repro_torch.core.gbdi_fr import (
    PAGE_FIELDS,
    FRConfig,
    alloc_blob,
    bf16_to_words,
    flat_blob,
    lead_blob,
    page_layout,
    words_to_bf16,
)
from repro_torch.kernels import ops
from repro_torch.kernels.gbdi_paged_attn import (
    MASKED,
    inv_sqrt,
    merge_softmax,
    paged_attention_decode_tail,
)

KV_FR = FRConfig(word_bits=16, page_words=DEFAULT_PAGE_WORDS,
                 num_bases=DEFAULT_NUM_BASES, width_set=(8,),
                 bucket_caps=(DEFAULT_PAGE_WORDS,),
                 outlier_cap=DEFAULT_OUTLIER_CAP)

#: attention_decode backends
BACKENDS = ("oracle", "resident", "paged", "auto")
#: blob fields a page slot keeps (the encode's n_spilled is dropped; its
#: n_dropped goes to the counter ``words.dropped`` while recording)
PAGE_KEYS = PAGE_FIELDS

# the cache: tensors plus the fitted BaseTable
Cache = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Cache geometry.  ``resident_decode=True`` adds a decoded-page region
    (``k_dec``/``v_dec`` bf16) to the cache: every flushed page is decoded
    once, from the blob that landed in its slot, and reused by every later
    read, at the memory price of the decoded copy (counted in
    :meth:`compressed_bytes`).  Invariant: ``k_dec``/``v_dec`` are always
    bit-identical to a from-scratch :func:`_decompress_all` of the slots.

    ``window`` > 0 makes the layer a sliding window of that many tokens
    (0: full attention): its page slots are a ring of ``ceil(window /
    page_tokens)`` (no more than ``max_len`` needs), and positions run up to
    ``max_len`` all the same.  A window layer has no resident region."""

    n_kv: int
    head_dim: int
    max_len: int
    fr: FRConfig = KV_FR
    resident_decode: bool = False
    window: int = 0

    def __post_init__(self) -> None:
        if self.window < 0:
            raise ValueError(f"window must be 0 (full attention) or positive, not {self.window}")
        if self.window and self.resident_decode:
            raise ValueError("resident_decode serves full-attention layers only; "
                             "a window layer attends through its ring of pages")

    @property
    def row_words(self) -> int:
        return self.n_kv * self.head_dim

    @property
    def page_tokens(self) -> int:
        return page_layout(self.fr, self.row_words)[0]

    @property
    def pages_per_row(self) -> int:
        return page_layout(self.fr, self.row_words)[1]

    @property
    def n_positions(self) -> int:
        """Positions the cache takes: ``max_len`` up to a whole page."""
        return math.ceil(self.max_len / self.page_tokens) * self.page_tokens

    @property
    def n_pages(self) -> int:
        """Page slots a row keeps a side: every page, or a window's ring."""
        full = math.ceil(self.max_len / self.page_tokens)
        return min(full, math.ceil(self.window / self.page_tokens)) if self.window else full

    @property
    def word_bytes(self) -> int:
        """Bytes per uncompressed memory word (2 for bf16 rows)."""
        return self.fr.word_bits // 8

    def compressed_bytes(self, batch: int) -> int:
        per_page = self.fr.compressed_bytes_per_page()
        # k and v; a row wider than a page fills pages_per_row slots a page
        pages = 2 * batch * self.n_pages * self.pages_per_row * per_page
        tail = 2 * batch * self.page_tokens * self.row_words * self.word_bytes
        if self.resident_decode:  # the decoded copy is resident too
            pages += 2 * batch * self.n_pages * self.page_tokens \
                * self.row_words * self.word_bytes
        return pages + tail

    def raw_bytes(self, batch: int) -> int:
        tokens = min(self.max_len, self.window) if self.window else self.max_len
        return 2 * batch * tokens * self.row_words * self.word_bytes  # k and v

    def compressed_bytes_upto(self, batch: int, n_tokens: int) -> int:
        """Bytes that hold just the first ``n_tokens`` of a sequence: the
        page slots those tokens flush into plus the raw tail ring (always
        allocated).  The full static-slot cost is :meth:`compressed_bytes`."""
        pages = min(self.n_pages, max(0, n_tokens) // self.page_tokens)
        per_page = self.fr.compressed_bytes_per_page()
        b = 2 * batch * pages * self.pages_per_row * per_page
        b += 2 * batch * self.page_tokens * self.row_words * self.word_bytes
        if self.resident_decode:
            b += 2 * batch * pages * self.page_tokens \
                * self.row_words * self.word_bytes
        return b

    def raw_bytes_upto(self, batch: int, n_tokens: int) -> int:
        """Raw-cache analogue of :meth:`compressed_bytes_upto`."""
        n = min(self.max_len, max(0, n_tokens))
        if self.window:
            n = min(n, self.window)
        return 2 * batch * n * self.row_words * self.word_bytes


def init_compressed(spec: KVSpec, batch: int, table: TableLike,
                    device: str | torch.device | None = None) -> Cache:
    """An empty cache on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    fr = spec.fr
    slots = (batch, spec.n_pages * spec.pages_per_row)

    def tail() -> torch.Tensor:
        return torch.zeros((batch, spec.page_tokens, spec.n_kv, spec.head_dim),
                           dtype=torch.bfloat16, device=dev)

    cache: Cache = {"k_pages": alloc_blob(fr, slots, dev, zeros=True),
                    "v_pages": alloc_blob(fr, slots, dev, zeros=True),
                    "k_tail": tail(), "v_tail": tail(),
                    "table": as_base_table(table, default_width=fr.widest_bits, device=dev)}
    if spec.resident_decode:
        # Seed the region by decoding the zero page slots, NOT with zeros: a
        # zero blob decodes to bases[0]-derived words, and the invariant is
        # bit-identity with a from-scratch decode for unflushed pages too.
        cache["k_dec"] = _decompress_all(spec, cache["k_pages"], cache["table"])
        cache["v_dec"] = _decompress_all(spec, cache["v_pages"], cache["table"])
    return cache


def _compress_rows(spec: KVSpec, rows: torch.Tensor, table: TableLike) -> dict[str, torch.Tensor]:
    """rows (B, n * page_tokens, Kv, hd) -> page blobs (B, n * pages_per_row, ...):
    every page of every batch row in one encode launch."""
    B = rows.shape[0]
    words = bf16_to_words(rows).reshape(-1, spec.fr.page_words).contiguous()
    blob = ops.encode_pages(words, table, spec.fr)
    obs.count("words.encoded", words.numel())
    obs.count("words.dropped", blob["n_dropped"])
    return lead_blob(blob, (B, -1), PAGE_KEYS)


def _decompress_all(spec: KVSpec, pages: dict[str, torch.Tensor], table: TableLike) -> torch.Tensor:
    """page slots (B, n, ...) -> (B, n * page_words / (Kv*hd), Kv, hd) bf16;
    one decode launch."""
    words = ops.decode_pages(flat_blob(pages), table, spec.fr)
    return words_to_bf16(words).reshape(pages["n_out"].shape[0], -1, spec.n_kv, spec.head_dim)


def _store_pages(spec: KVSpec, cache: Cache, side: str, first_page: int, rows: torch.Tensor) -> None:
    """Encode ``rows`` (whole pages from ``first_page`` on, at most
    ``n_pages`` of them) into their slots, page ``p`` into slot ``p %
    n_pages`` (a window's ring wraps; a full layer's pages fit) and, with a
    resident region, decode the blob just written into it (NOT the raw rows:
    dropped outliers must round-trip as a from-scratch decode)."""
    blob = _compress_rows(spec, rows, cache["table"])
    ppr, first = spec.pages_per_row, first_page % spec.n_pages
    head = min(rows.shape[1] // spec.page_tokens, spec.n_pages - first) * ppr
    for key, val in blob.items():
        pages = cache[f"{side}_pages"][key]
        pages[:, first * ppr:first * ppr + head] = val[:, :head]
        if val.shape[1] > head:                     # past the ring's end, from slot 0
            pages[:, :val.shape[1] - head] = val[:, head:]
    if f"{side}_dec" in cache:
        t0 = first_page * spec.page_tokens
        cache[f"{side}_dec"][:, t0:t0 + rows.shape[1]] = _decompress_all(spec, blob, cache["table"])


def _check_positions(spec: KVSpec, start: int, end: int) -> None:
    if not 0 <= start <= end <= spec.n_positions:
        raise ValueError(f"positions [{start}, {end}) outside the cache's "
                         f"{spec.n_positions} token slots")


def _count_evicted(spec: KVSpec, first: int, last: int) -> None:
    """Count the flushes of pages ``[first, last)`` into ring slots that
    already held a page (a page past the ring's first lap): one a flush,
    whatever the batch."""
    if spec.window:
        obs.count("pages.evicted", max(0, last - max(first, spec.n_pages)))


def append(spec: KVSpec, cache: Cache, k: torch.Tensor, v: torch.Tensor, pos: int) -> Cache:
    """Append one token (B, 1, Kv, hd) at absolute position ``pos``; when it
    completes a page, flush the tail into the page's slots.  In place."""
    with obs.span("kv_cache.append"):
        _check_positions(spec, pos, pos + 1)
        pt = spec.page_tokens
        slot = pos % pt
        cache["k_tail"][:, slot] = k[:, 0]
        cache["v_tail"][:, slot] = v[:, 0]
        if slot == pt - 1:
            with obs.span("kv_cache.flush"):
                for side in ("k", "v"):
                    _store_pages(spec, cache, side, pos // pt, cache[f"{side}_tail"])
            _count_evicted(spec, pos // pt, pos // pt + 1)
    return cache


def extend(spec: KVSpec, cache: Cache, ks: torch.Tensor, vs: torch.Tensor, start: int) -> Cache:
    """Append ``T`` tokens (B, T, Kv, hd) at positions ``start .. start+T-1``.

    Leaves the cache bit-identical to ``T`` calls of :func:`append`, but
    encodes every page the tokens complete in one launch per side (and
    decodes them for a resident region in one more).  A page that began
    before ``start`` takes its first tokens from the tail ring.  The ring
    ends as the appends leave it: slot ``s`` holds the newest token with
    position ``p < start + T`` and ``p % page_tokens == s``, rows of earlier
    pages included.  A window layer encodes only the pages its ring keeps,
    the last ``n_pages`` of those completed: the appends would have
    overwritten the others.  In place.
    """
    T = ks.shape[1]
    end = start + T
    _check_positions(spec, start, end)
    if T == 0:
        return cache
    pt = spec.page_tokens
    first, last = start // pt, end // pt           # pages [first, last) complete
    keep = max(first, last - spec.n_pages)         # the first page the ring keeps
    for side, xs in (("k", ks), ("v", vs)):
        tail = cache[f"{side}_tail"]
        if last > keep == first:
            head = tail[:, :start - first * pt]
            rows = torch.cat([head, xs[:, :last * pt - start].to(torch.bfloat16)], dim=1)
            _store_pages(spec, cache, side, first, rows)
        elif last > keep:
            _store_pages(spec, cache, side, keep,
                         xs[:, keep * pt - start:last * pt - start].to(torch.bfloat16))
        n = min(T, pt)
        ring = torch.arange(end - n, end, device=tail.device) % pt
        tail[:, ring] = xs[:, T - n:].to(torch.bfloat16)
    _count_evicted(spec, first, last)
    return cache


def read_full(spec: KVSpec, cache: Cache, pos: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (K, V, valid) by position, ``n_positions`` of them: the decoded pages
    (or a copy of the resident region) with the raw tail overlaid on the
    current page; ``valid`` marks [0, pos], or a window's [pos - W + 1, pos].
    A window layer's ring is laid out by position: page ``p`` from slot
    ``p % n_pages``, which holds it wherever ``valid`` reaches."""
    if "k_dec" in cache:
        K, V = cache["k_dec"].clone(), cache["v_dec"].clone()
    else:
        K = _decompress_all(spec, cache["k_pages"], cache["table"])
        V = _decompress_all(spec, cache["v_pages"], cache["table"])
    pt = spec.page_tokens
    t = torch.arange(spec.n_positions, device=K.device)
    if spec.window:
        src = (t // pt) % spec.n_pages * pt + t % pt
        K, V = K[:, src], V[:, src]
    t0 = (pos // pt) * pt
    K[:, t0:t0 + pt] = cache["k_tail"]
    V[:, t0:t0 + pt] = cache["v_tail"]
    valid = t <= pos
    if spec.window:
        valid &= t > pos - spec.window
    return K, V, valid


def attention_decode(spec: KVSpec, q: torch.Tensor, cache: Cache, pos: int,
                     backend: str = "auto") -> torch.Tensor:
    """q: (B, 1, H, hd) -> (B, 1, H*hd) bf16 over the compressed cache.

    ``'oracle'`` attends over the full decoded view (the semantic reference;
    it decodes every page).  ``'resident'`` is the same math over the
    ``resident_decode`` region, so no page is decoded on this step, and is
    bit-identical to ``'oracle'``.  ``'paged'`` attends over the compressed
    pages and the raw tail with the paged-attention kernel, which merges the
    two by the streaming-softmax identity
    (:func:`~repro_torch.kernels.gbdi_paged_attn.paged_attention_decode_tail`);
    it takes whole rows in a page, or a row over whole page slots of whole
    heads (a full layer only).  ``'auto'`` picks the resident region when
    the cache has one, else ``'paged'``.  A window layer's call runs inside
    the span ``kv_cache.window``, a multipage row's inside
    ``kv_cache.multipage``.
    """
    with obs.span("kv_cache.attention_decode"):
        if spec.window:
            with obs.span("kv_cache.window"):
                return _attention_decode(spec, q, cache, pos, backend)
        if spec.pages_per_row > 1:
            with obs.span("kv_cache.multipage"):
                return _attention_decode(spec, q, cache, pos, backend)
        return _attention_decode(spec, q, cache, pos, backend)


def _attention_decode(spec: KVSpec, q: torch.Tensor, cache: Cache, pos: int,
                      backend: str) -> torch.Tensor:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "resident" and "k_dec" not in cache:
        raise ValueError("backend='resident' requires a cache built with "
                         "spec.resident_decode=True")
    if backend in ("oracle", "resident") or (backend == "auto" and "k_dec" in cache):
        K, V, valid = read_full(spec, cache, pos)
        B, S, Kv, hd = K.shape
        H = q.shape[2]
        qg = q.reshape(B, 1, Kv, H // Kv, hd).float()
        logits = torch.einsum("bskgh,btkh->bkgst", qg, K.float()) * inv_sqrt(hd, K.device)
        logits = torch.where(valid, logits, MASKED)
        probs = torch.softmax(logits, dim=-1).to(V.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs.float(), V.float()).to(V.dtype)
        return out.reshape(B, 1, H * hd)

    B, _, H, hd = q.shape
    Kv = spec.n_kv
    # merge_softmax is read here at each call, so a merge put in its place
    # (the benchmark's tail_dropped fault) runs eagerly on the card as well
    out = paged_attention_decode_tail(
        q.reshape(B, Kv, H // Kv, hd), cache["k_pages"], cache["v_pages"], cache["table"], pos,
        spec.fr, k_tail=cache["k_tail"], v_tail=cache["v_tail"], n_kv=Kv, hd=hd, groups=H // Kv,
        window=spec.window, merge=merge_softmax)
    return out.reshape(B, 1, H * hd)


__all__ = ["BACKENDS", "KV_FR", "Cache", "KVSpec", "append", "attention_decode",
           "extend", "init_compressed", "read_full"]
