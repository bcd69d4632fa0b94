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
(``pages_per_row > 1``) fills several slots per token.  A page holds
``page_tokens = page_words // (Kv*hd)`` consecutive tokens' K (or V).
Appends go to the raw tail; when it fills, it is compressed into the next
page slot with the encode kernel, and with ``resident_decode`` that blob
is decoded once into the resident region with the decode kernel.
:func:`attention_decode` attends over the compressed pages with the
paged-attention kernel and merges the raw tail in (``paged``), or over a
decoded view (``oracle``, ``resident``).

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

from repro_torch._device import resolve_device
from repro_torch.core.format import (
    DEFAULT_NUM_BASES,
    DEFAULT_OUTLIER_CAP,
    DEFAULT_PAGE_WORDS,
    TableLike,
    as_base_table,
)
from repro_torch.core.gbdi_fr import FRConfig, bf16_to_words, words_to_bf16
from repro_torch.kernels import ops
from repro_torch.kernels.gbdi_paged_attn import (
    MASKED,
    MASKED_GUARD,
    inv_sqrt,
    merge_softmax,
    paged_attention_decode,
)

KV_FR = FRConfig(word_bits=16, page_words=DEFAULT_PAGE_WORDS,
                 num_bases=DEFAULT_NUM_BASES, width_set=(8,),
                 bucket_caps=(DEFAULT_PAGE_WORDS,),
                 outlier_cap=DEFAULT_OUTLIER_CAP)

#: attention_decode backends
BACKENDS = ("oracle", "resident", "paged", "auto")
#: blob fields a page slot keeps (the encode's n_spilled/n_dropped are dropped)
PAGE_KEYS = ("ptrs", "deltas", "out_vals", "out_idx", "n_out", "profile")

# the cache: tensors plus the fitted BaseTable
Cache = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Cache geometry.  ``resident_decode=True`` adds a decoded-page region
    (``k_dec``/``v_dec`` bf16) to the cache: every flushed page is decoded
    once, from the blob that landed in its slot, and reused by every later
    read, at the memory price of the decoded copy (counted in
    :meth:`compressed_bytes`).  Invariant: ``k_dec``/``v_dec`` are always
    bit-identical to a from-scratch :func:`_decompress_all` of the slots."""

    n_kv: int
    head_dim: int
    max_len: int
    fr: FRConfig = KV_FR
    resident_decode: bool = False

    @property
    def row_words(self) -> int:
        return self.n_kv * self.head_dim

    @property
    def page_tokens(self) -> int:
        P, row = self.fr.page_words, self.row_words
        if P % row and row % P:
            raise ValueError(f"a {P}-word page and a {row}-word row must divide one another")
        return max(1, P // row)

    @property
    def pages_per_row(self) -> int:
        return max(1, self.row_words // self.fr.page_words)

    @property
    def n_pages(self) -> int:
        return math.ceil(self.max_len / self.page_tokens)

    @property
    def word_bytes(self) -> int:
        """Bytes per uncompressed memory word (2 for bf16 rows)."""
        return self.fr.word_bits // 8

    def compressed_bytes(self, batch: int) -> int:
        per_page = self.fr.compressed_bytes_per_page()
        pages = 2 * batch * self.n_pages * per_page  # k and v
        tail = 2 * batch * self.page_tokens * self.row_words * self.word_bytes
        if self.resident_decode:  # the decoded copy is resident too
            pages += 2 * batch * self.n_pages * self.page_tokens \
                * self.row_words * self.word_bytes
        return pages + tail

    def raw_bytes(self, batch: int) -> int:
        return 2 * batch * self.max_len * self.row_words * self.word_bytes  # k and v

    def compressed_bytes_upto(self, batch: int, n_tokens: int) -> int:
        """Bytes that hold just the first ``n_tokens`` of a sequence: the
        page slots those tokens flush into plus the raw tail ring (always
        allocated).  The full static-slot cost is :meth:`compressed_bytes`."""
        pages = min(self.n_pages, max(0, n_tokens) // self.page_tokens)
        per_page = self.fr.compressed_bytes_per_page()
        b = 2 * batch * pages * per_page
        b += 2 * batch * self.page_tokens * self.row_words * self.word_bytes
        if self.resident_decode:
            b += 2 * batch * pages * self.page_tokens \
                * self.row_words * self.word_bytes
        return b

    def raw_bytes_upto(self, batch: int, n_tokens: int) -> int:
        """Raw-cache analogue of :meth:`compressed_bytes_upto`."""
        n = min(self.max_len, max(0, n_tokens))
        return 2 * batch * n * self.row_words * self.word_bytes


def init_compressed(spec: KVSpec, batch: int, table: TableLike,
                    device: str | torch.device | None = None) -> Cache:
    """An empty cache on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    fr = spec.fr
    n_slots = spec.n_pages * spec.pages_per_row

    def page_zeros() -> dict[str, torch.Tensor]:
        def z(*shape: int) -> torch.Tensor:
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        pages = {"ptrs": z(batch, n_slots, fr.ptr_lanes),
                 "deltas": z(batch, n_slots, fr.delta_lanes),
                 "out_vals": z(batch, n_slots, fr.outlier_cap),
                 "out_idx": z(batch, n_slots, fr.outlier_cap),
                 "n_out": z(batch, n_slots)}
        if fr.num_profiles > 1:   # adaptive cfg: per-page profile ids
            pages["profile"] = z(batch, n_slots)
        return pages

    def tail() -> torch.Tensor:
        return torch.zeros((batch, spec.page_tokens, spec.n_kv, spec.head_dim),
                           dtype=torch.bfloat16, device=dev)

    cache: Cache = {"k_pages": page_zeros(), "v_pages": page_zeros(),
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
    return {k: v.reshape((B, -1) + v.shape[1:]) for k, v in blob.items() if k in PAGE_KEYS}


def _decompress_all(spec: KVSpec, pages: dict[str, torch.Tensor], table: TableLike) -> torch.Tensor:
    """page slots (B, n, ...) -> (B, n * page_words / (Kv*hd), Kv, hd) bf16;
    one decode launch."""
    B, n = pages["n_out"].shape
    flat = {k: v.reshape((B * n,) + v.shape[2:]).contiguous() for k, v in pages.items()}
    words = ops.decode_pages(flat, table, spec.fr)
    return words_to_bf16(words).reshape(B, -1, spec.n_kv, spec.head_dim)


def _store_pages(spec: KVSpec, cache: Cache, side: str, first_page: int, rows: torch.Tensor) -> None:
    """Encode ``rows`` (whole pages from ``first_page`` on) into their slots and,
    with a resident region, decode the blob just written into it (NOT the
    raw rows: dropped outliers must round-trip as a from-scratch decode)."""
    blob = _compress_rows(spec, rows, cache["table"])
    s0 = first_page * spec.pages_per_row
    for key, val in blob.items():
        cache[f"{side}_pages"][key][:, s0:s0 + val.shape[1]] = val
    if f"{side}_dec" in cache:
        t0 = first_page * spec.page_tokens
        cache[f"{side}_dec"][:, t0:t0 + rows.shape[1]] = _decompress_all(spec, blob, cache["table"])


def _check_positions(spec: KVSpec, start: int, end: int) -> None:
    if not 0 <= start <= end <= spec.n_pages * spec.page_tokens:
        raise ValueError(f"positions [{start}, {end}) outside the cache's "
                         f"{spec.n_pages * spec.page_tokens} token slots")


def append(spec: KVSpec, cache: Cache, k: torch.Tensor, v: torch.Tensor, pos: int) -> Cache:
    """Append one token (B, 1, Kv, hd) at absolute position ``pos``; when it
    completes a page, flush the tail into the page's slots.  In place."""
    _check_positions(spec, pos, pos + 1)
    pt = spec.page_tokens
    slot = pos % pt
    cache["k_tail"][:, slot] = k[:, 0]
    cache["v_tail"][:, slot] = v[:, 0]
    if slot == pt - 1:
        for side in ("k", "v"):
            _store_pages(spec, cache, side, pos // pt, cache[f"{side}_tail"])
    return cache


def extend(spec: KVSpec, cache: Cache, ks: torch.Tensor, vs: torch.Tensor, start: int) -> Cache:
    """Append ``T`` tokens (B, T, Kv, hd) at positions ``start .. start+T-1``.

    Leaves the cache bit-identical to ``T`` calls of :func:`append`, but
    encodes every page the tokens complete in one launch per side (and
    decodes them for a resident region in one more).  A page that began
    before ``start`` takes its first tokens from the tail ring.  The ring
    ends as the appends leave it: slot ``s`` holds the newest token with
    position ``p < start + T`` and ``p % page_tokens == s``, rows of earlier
    pages included.  In place.
    """
    T = ks.shape[1]
    end = start + T
    _check_positions(spec, start, end)
    if T == 0:
        return cache
    pt = spec.page_tokens
    first, last = start // pt, end // pt           # pages [first, last) complete
    for side, xs in (("k", ks), ("v", vs)):
        tail = cache[f"{side}_tail"]
        if last > first:
            head = tail[:, :start - first * pt]
            rows = torch.cat([head, xs[:, :last * pt - start].to(torch.bfloat16)], dim=1)
            _store_pages(spec, cache, side, first, rows)
        n = min(T, pt)
        ring = torch.arange(end - n, end, device=tail.device) % pt
        tail[:, ring] = xs[:, T - n:].to(torch.bfloat16)
    return cache


def read_full(spec: KVSpec, cache: Cache, pos: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (K, V, valid) covering [0, pos]: the decoded pages (or a copy of the
    resident region) with the raw tail overlaid on the current page."""
    if "k_dec" in cache:
        K, V = cache["k_dec"].clone(), cache["v_dec"].clone()
    else:
        K = _decompress_all(spec, cache["k_pages"], cache["table"])
        V = _decompress_all(spec, cache["v_pages"], cache["table"])
    pt = spec.page_tokens
    t0 = (pos // pt) * pt
    K[:, t0:t0 + pt] = cache["k_tail"]
    V[:, t0:t0 + pt] = cache["v_tail"]
    valid = torch.arange(K.shape[1], device=K.device) <= pos
    return K, V, valid


def attention_decode(spec: KVSpec, q: torch.Tensor, cache: Cache, pos: int,
                     backend: str = "auto") -> torch.Tensor:
    """q: (B, 1, H, hd) -> (B, 1, H*hd) bf16 over the compressed cache.

    ``'oracle'`` attends over the full decoded view (the semantic reference;
    it decodes every page).  ``'resident'`` is the same math over the
    ``resident_decode`` region, so no page is decoded on this step, and is
    bit-identical to ``'oracle'``.  ``'paged'`` attends over the compressed
    pages with the paged-attention kernel and merges the raw tail with the
    streaming-softmax identity; it needs whole rows in a page.  ``'auto'``
    picks the resident region when the cache has one, else ``'paged'``.
    """
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
    G = H // Kv
    qg = q.reshape(B, Kv, G, hd).float()
    acc, m, l = paged_attention_decode(
        qg, cache["k_pages"], cache["v_pages"], cache["table"], pos, spec.fr,
        n_kv=Kv, hd=hd, groups=G)
    # the raw tail (the current partial page), then the softmax merge
    pt = spec.page_tokens
    Kt, Vt = cache["k_tail"].float(), cache["v_tail"].float()
    tail_valid = (pos // pt) * pt + torch.arange(pt, device=qg.device) <= pos
    lg = torch.einsum("bkgh,btkh->bkgt", qg, Kt) * inv_sqrt(hd, qg.device)
    lg = torch.where(tail_valid, lg, MASKED)
    m2 = lg.max(dim=-1).values
    p2 = torch.where(lg <= MASKED_GUARD, 0.0, torch.exp(lg - m2[..., None]))
    acc2 = torch.einsum("bkgt,btkh->bkgh", p2, Vt)
    accm, _, lm = merge_softmax(acc, m, l, acc2, m2, p2.sum(dim=-1))
    out = accm / lm[..., None]
    return out.reshape(B, 1, H * hd).to(cache["k_tail"].dtype)


__all__ = ["BACKENDS", "KV_FR", "Cache", "KVSpec", "append", "attention_decode",
           "extend", "init_compressed", "read_full"]
