"""Decode attention over GBDI-FR pages: the CUDA kernel's wrapper, its plain
version, its budget, and the softmax-merge identity.

The kernel (``csrc/gbdi_paged_attn.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/gbdi_paged_attn.py`` (``paged_attention_decode``) and
stands for its XLA twin ``src/repro/kernels/xla.py`` (``_paged_attn``) too:
one kernel, the contract of both.  Given ``q (B, Kv, G, hd)`` and the
compressed K and V page slots ``(B, S, ...)`` of a KV cache, it returns the
un-normalised flash-decoding state ``(acc (B, Kv, G, hd), m (B, Kv, G),
l (B, Kv, G))`` in float32 over FULL pages only: tokens at or past
``(pos // pt) * pt`` are masked with ``-1e30``, and the caller attends over
the raw tail and merges with :func:`merge_softmax`.  Unlike the Pallas
kernel it also reads adaptive-profile pages (the page's ``profile`` picks
its layout, as in the decode kernel).

:func:`paged_attention_decode` launches the kernel for tensors on a CUDA
device, counts the launch in the counter ``launches.attn`` of
:mod:`repro_torch.obs` (and in ``launches.attn_sliced`` where the
attention step runs in token slices, :func:`token_slices`) and records its
host work as the span ``paged_attn``; for tensors on the CPU it runs
:func:`paged_attention_decode_plain`, and for any other device it raises.
Both paths first take the call's geometry once (:func:`attn_geometry`:
16-bit words, whole ``Kv * hd`` rows in a page or a row over whole page
slots (:func:`attn_layout`), and :func:`check_smem`, where the reference's
VMEM check stood, which fixes the page slots a pass decodes); on the card a
:class:`LaunchPlan` adds the grid.  :func:`decode_pages` exposes that
batched decode alone, so it can be held bit for bit against the decode
kernel.

A row wider than a page (``Kv * hd = ppr * page_words``, each page whole
heads) spans ``ppr`` slots: slot ``t * ppr + j`` holds heads ``[j * Kv /
ppr, (j + 1) * Kv / ppr)`` of token ``t``, as the KV cache writes it, and a
page holds one token (``pt`` 1).  The kernel then attends each head group
``j`` in blocks of its own (grid axis z), which decode only that group's
slots, so every slot is still decoded once; such launches are counted in
``launches.attn_multipage`` too.

:func:`paged_attention_decode_tail` is the whole of a decode step's
attention: the pages' state, then the raw tail ring (the current partial
page) attended and merged in, normalised, in bf16.  On the card the
kernel's split merge does the tail's part in the same launch pair (counted
in ``launches.attn_tail`` too); on the CPU, :func:`paged_attention_decode`
runs and then :func:`tail_merge`, the eager merge, in the span
``kv_cache.tail_merge``.

With ``window=W > 0`` the page slots are a sliding window's ring (a layer
of a window/full hybrid, :class:`~repro_torch.serving.kv_cache.KVSpec`'s
``window``): page ``p`` lives in slot ``p % S``, and the state covers the
full pages' tokens at positions ``[pos - W + 1, (pos // pt) * pt)`` only
(:func:`ring_bounds`).  The card runs the kernel's ring instantiation
(``attn_kernel<., ., true>``), which the full-attention cells never launch.

Every constant a call needs is made once on the card and reused: the
padded table and the kernels' meta come from the memo of
:func:`~repro_torch.kernels.gbdi_encode.prepare_table`, which kernels A and
B share (both entry points take a :class:`PreparedTable` too), and the
scale from :func:`inv_sqrt`.  So a warm call copies nothing from the host
and does not wait for the stream.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import upload
from repro_torch.core.format import WORD16_MASK, TableLike, as_base_table
from repro_torch.core.gbdi_fr import FRConfig, flat_blob, fr_decode, page_layout, words_to_bf16
from repro_torch.kernels import _build
from repro_torch.kernels.gbdi_encode import (
    MAX_CLASSES,
    SMEM_LIMIT_BYTES,
    PreparedTable,
    blob_ptrs,
    check_prepared,
    k_padded,
    kernel_iparams,
    plain_table,
    prepare_table,
)

#: the mask sentinel, and the score at or below which a probability is 0:
#: with -inf an all-masked run would give exp(-inf - -inf) = NaN
MASKED = -1e30
MASKED_GUARD = -1e29
#: page slots the plain version decodes at a time (per batch row)
PLAIN_CHUNK_SLOTS = 1024
#: the attention block: 512 threads in 16 warps; a thread keeps 32
#: accumulators (8 at 8 channels a lane), so a warp owns up to 32 /
#: channels-per-lane (kv, group) rows
ATTN_WARPS = 16
#: tokens per attention tile, and the most page slots one pass decodes
TILE_TOKENS = 8
MAX_PASS_SLOTS = 8
#: words of a page one warp of the pass decode takes at a time
GROUP_WORDS = 128
#: the channels of one channel chunk (8 a lane); wider heads take several
CHUNK_CHANNELS = 256
#: the waves of blocks the split search considers
MAX_WAVES = 8


def attn_layout(cfg: FRConfig, n_kv: int, hd: int) -> tuple[int, int]:
    """``(pt, ppr)`` of a row of ``n_kv`` heads of ``hd`` words
    (:func:`~repro_torch.core.gbdi_fr.page_layout`, which raises unless the
    row and the page divide one another), raising unless every page holds
    whole heads: a block attends for the heads of the slots it decodes."""
    if n_kv < 1 or hd < 1 or cfg.page_words % hd:
        raise ValueError(f"paged attention needs whole heads in a page: {cfg.page_words} "
                         f"words are not a whole number of {hd}-word heads")
    return page_layout(cfg, n_kv * hd)


def page_tokens(cfg: FRConfig, n_kv: int, hd: int) -> int:
    """Tokens per page slot: ``page_words // (Kv * hd)``, or 1 where a row
    spans several slots (:func:`attn_layout`, which raises for any other
    row)."""
    return attn_layout(cfg, n_kv, hd)[0]


def channels_per_lane(hd: int) -> int:
    """The power of two ``c`` with ``32 * c >= hd`` (mirrors ``cpl_of``)."""
    c = 1
    while 32 * c < hd:
        c *= 2
    return c


def rows_per_warp(hd: int) -> int:
    """Rows a warp may own (mirrors ``rows_per_warp``): 32 accumulators a
    thread over channels-per-lane, but 1 at 8 channels a lane."""
    cpl = min(channels_per_lane(hd), CHUNK_CHANNELS // 32)
    return 1 if cpl >= 8 else 32 // cpl


def chunk_rows(kg: int, hd: int) -> int:
    """(kv, group) rows one block holds (mirrors ``chunk_rows``): 16 warps of
    :func:`rows_per_warp` rows; more rows go to further row chunks, each
    decoding the pages again."""
    return min(kg, ATTN_WARPS * rows_per_warp(hd))


@functools.lru_cache(maxsize=256)
def token_slices(kg: int, hd: int, pass_tokens: int) -> int:
    """Token slices of the attention step (mirrors ``token_slices``): the
    largest power of two ``ts <= 16`` with ``ts`` at most the pass's 8-token
    tiles and ``ceil(R * ts / 16)`` rows a warp at most what a warp may own,
    ``R`` the block's rows (:func:`chunk_rows`); 1 for a head wider than one
    channel chunk.  The 16 warps then form ``ts`` slices of ``16 / ts`` warps,
    slice ``j`` taking the pass's tiles ``j, j + ts, ...``, and the block folds
    the slices' states after its last pass."""
    if hd > CHUNK_CHANNELS:
        return 1
    rows, tiles = chunk_rows(kg, hd), -(-pass_tokens // TILE_TOKENS)
    ts = ATTN_WARPS
    while ts > 1 and (ts > tiles or -(-rows * ts // ATTN_WARPS) > rows_per_warp(hd)):
        ts //= 2
    return ts


def channel_chunks(hd: int) -> int:
    """Channel chunks of a head (mirrors ``chan_chunks``): 1 up to 256
    channels, else one per 256; each chunk scores the whole head and
    accumulates V over its own channels."""
    return 1 if hd <= CHUNK_CHANNELS else -(-hd // CHUNK_CHANNELS)


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(cfg: FRConfig, *, n_kv: int, hd: int, groups: int,
               n_slots: int | None = None) -> int:
    """Dynamic shared memory of one attention block at ``n_slots`` page slots
    per pass (default: :func:`pass_slots`), mirroring ``attn_smem_bytes``: q
    for the block's rows, and m, l, alpha and the tile's p for them in each
    token slice; the code table and a class mask; every profile's caps and
    lane offsets, and each page's; per-class counts of each 128-word group;
    the decoded pass as bf16, or the slices' float32 fold laid over it where
    that is larger; and two staged passes (K and V sides, each field of the
    pass contiguous).  The rows are those of a page's heads: ``n_kv / ppr``
    of them where a row spans ``ppr`` slots (:func:`attn_layout`)."""
    pt, ppr = attn_layout(cfg, n_kv, hd)
    n = pass_slots(cfg, n_kv=n_kv, hd=hd, groups=groups) if n_slots is None else n_slots
    kg = n_kv // ppr * groups
    R = chunk_rows(kg, hd)
    ts = token_slices(kg, hd, n * pt)
    pages = 2 * n
    groups_per_page = cfg.page_words // GROUP_WORDS
    a4 = lambda x: -(-x // 4) * 4  # noqa: E731
    side = (a4(n * cfg.ptr_lanes) + a4(n * cfg.delta_lanes) + 2 * a4(n * cfg.outlier_cap)
            + 2 * a4(n))
    fold = _a16(4 * ts * R * hd) if ts > 1 else 0
    return (_a16(4 * R * hd) + 3 * _a16(4 * ts * R) + _a16(4 * ts * R * TILE_TOKENS)
            + _a16(4 * (k_padded(cfg) + 2)) + 16
            + _a16(8 * cfg.num_profiles * cfg.num_classes) + 2 * _a16(4 * pages * MAX_CLASSES)
            + _a16(4 * cfg.num_classes * pages * groups_per_page)
            + max(_a16(2 * pages * cfg.page_words), fold) + 4 * 2 * 2 * side)


def pass_slots(cfg: FRConfig, *, n_kv: int, hd: int, groups: int) -> int:
    """Page slots per pass: among the N <= 8 whose block fits 227 KB, the one
    whose N * page_tokens tokens fill the 8-token tiles best (the larger on
    a tie); 0 where not even one slot fits."""
    pt = page_tokens(cfg, n_kv, hd)
    fits = [n for n in range(1, MAX_PASS_SLOTS + 1)
            if smem_bytes(cfg, n_kv=n_kv, hd=hd, groups=groups, n_slots=n) <= SMEM_LIMIT_BYTES]
    if not fits:
        return 0
    return max(fits, key=lambda n: (n * pt / (-(-n * pt // TILE_TOKENS) * TILE_TOKENS), n))


def check_smem(cfg: FRConfig, *, n_kv: int, hd: int, groups: int) -> int:
    """The pass size :func:`pass_slots` picks; raises where no pass fits."""
    n = pass_slots(cfg, n_kv=n_kv, hd=hd, groups=groups)
    if n == 0:
        need = smem_bytes(cfg, n_kv=n_kv, hd=hd, groups=groups, n_slots=1)
        raise ValueError(
            f"a paged-attention block needs {need} B of shared memory for one page slot "
            f"per pass (> {SMEM_LIMIT_BYTES} B on Hopper); shrink page_words "
            f"(={cfg.page_words}) or the heads (n_kv={n_kv}, groups={groups}, hd={hd})")
    return n


class AttnGeometry(NamedTuple):
    """What a call derives from ``(cfg, n_kv, hd, groups)`` (:func:`attn_geometry`):
    tokens a page, page slots a pass, head groups times row chunks times
    channel chunks (the grid's third axis), token slices (:func:`token_slices`)
    and the page slots a row spans (:func:`attn_layout`)."""

    cfg: FRConfig
    n_kv: int
    hd: int
    groups: int
    pt: int
    pass_n: int
    chunks: int
    ts: int
    ppr: int


def attn_geometry(cfg: FRConfig, *, n_kv: int, hd: int, groups: int,
                  window: int = 0) -> AttnGeometry:
    """The call's checked geometry: bf16 pages (16-bit words), whole rows in
    a page or a row over whole page slots (:func:`attn_layout`; a window
    layer only the first) and a block that fits (:func:`check_smem`, which
    picks the pass size and alone bounds the head dim), then the chunks and
    token slices over a page's heads.  Both paths take it, so the CPU's
    answer is the card's."""
    if cfg.word_bits != 16:
        raise ValueError(f"the paged-attention kernel reads 16-bit (bf16) KV pages, "
                         f"not word_bits={cfg.word_bits}")
    pt, ppr = attn_layout(cfg, n_kv, hd)
    if window and ppr > 1:
        raise ValueError(f"a window layer's ring needs whole rows in a page; a row of "
                         f"Kv*hd = {n_kv * hd} words spans {ppr} page slots")
    pass_n = check_smem(cfg, n_kv=n_kv, hd=hd, groups=groups)
    kg = n_kv // ppr * groups
    return AttnGeometry(cfg, n_kv, hd, groups, pt, pass_n,
                        ppr * -(-kg // chunk_rows(kg, hd)) * channel_chunks(hd),
                        token_slices(kg, hd, pass_n * pt), ppr)


def inv_sqrt(hd: int, device: torch.device | str) -> torch.Tensor:
    """1/sqrt(hd) formed in float32, as the reference and the kernel form it
    (``1.0f / sqrtf(hd)``, both IEEE-rounded), as a 0-dim float32 tensor.  A
    double ``1 / math.sqrt(hd)`` rounded to float32 differs from it at many
    head dims (96, 112, 384 among them), and so does torch's CPU ``sqrt`` of
    a float32 scalar at hd 267; numpy's float32 ``sqrt`` is IEEE-rounded.

    The tensor is made once per ``(hd, device)`` and the same object is
    returned after that, so a warm decode step makes no blocking copy to the
    card for it.  It is shared: read it, never write to it in place."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _inv_sqrt(int(hd), device)


@functools.lru_cache(maxsize=64)
def _inv_sqrt(hd: int, device: torch.device) -> torch.Tensor:
    scale = np.float32(1) / np.sqrt(np.float32(hd))
    return upload(scale, dtype=torch.float32, device=device)


def merge_softmax(
    acc1: torch.Tensor, m1: torch.Tensor, l1: torch.Tensor,
    acc2: torch.Tensor, m2: torch.Tensor, l2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streaming-softmax merge of two partial attention streams."""
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    acc = acc1 * a1[..., None] + acc2 * a2[..., None]
    return acc, m, l


def softmax_chunk(
    q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, live: torch.Tensor, scale: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk's un-merged ``(acc, m, l)`` in float32: the scores of ``q
    (B, Kv, G, hd)`` against ``K (B, T, Kv, hd)`` times ``scale``, masked to
    ``MASKED`` where ``live (T,)`` is False, their max, ``exp`` guarded so a
    score at or below ``MASKED_GUARD`` weighs 0, then ``p . V`` and the sum
    of ``p``.  The caller merges it (:func:`merge_softmax`)."""
    logits = torch.where(live, torch.einsum("bkgh,btkh->bkgt", q, K) * scale, MASKED)
    m = logits.max(dim=-1).values
    p = torch.where(logits <= MASKED_GUARD, 0.0, torch.exp(logits - m[..., None]))
    return torch.einsum("bkgt,btkh->bkgh", p, V), m, p.sum(dim=-1)


def tail_merge(
    q: torch.Tensor, state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    k_tail: torch.Tensor, v_tail: torch.Tensor, pos: int, *, window: int = 0,
    merge=merge_softmax,
) -> torch.Tensor:
    """The pages' ``state (acc, m, l)`` with the raw tail merged in, eagerly:
    ``q (B, Kv, G, hd)`` float32 attends in float32 over the tail ring
    ``k_tail``/``v_tail (B, pt, Kv, hd)``, whose token ``t`` is position
    ``(pos // pt) * pt + t``, masked outside ``[pos - window + 1, pos]``
    (``[0, pos]`` where ``window`` is 0); ``merge`` folds the two streams,
    and the result, divided by its sum, comes back ``(B, Kv, G, hd)`` in the
    tail's dtype.  Recorded as the span ``kv_cache.tail_merge``."""
    acc, m, l = state
    with obs.span("kv_cache.tail_merge"):
        pt = k_tail.shape[1]
        Kt, Vt = k_tail.float(), v_tail.float()
        tok = (pos // pt) * pt + torch.arange(pt, device=q.device)
        tail_valid = tok <= pos
        if window:
            tail_valid &= tok > pos - window
        tail = softmax_chunk(q, Kt, Vt, tail_valid, inv_sqrt(q.shape[-1], q.device))
        accm, _, lm = merge(acc, m, l, *tail)
        return (accm / lm[..., None]).to(k_tail.dtype)


def ring_bounds(S: int, pos: int, pt: int, window: int) -> tuple[int, int, int]:
    """``(n_valid, cur, lo)`` of a call over ``S`` page slots at ``pos``:
    the slots read, ``[0, n_valid)``; the current page, ``cur = pos // pt``,
    whose tokens the raw tail holds; and the first position that counts.

    Full attention (``window`` 0): slot ``s`` holds page ``s``, ``lo`` is 0.
    A window of ``W`` tokens: the slots are a ring, page ``p`` in slot
    ``p % S``, and slot ``s < min(S, cur)`` holds page ``cur - 1 - ((cur - 1
    - s) mod S)``; ``lo = max(0, pos - W + 1)``.  A flush of page ``c`` into
    slot ``c % S`` overwrites page ``c - S``, whose last position ``(c - S +
    1) * pt - 1`` lies before that flush's ``lo = (c + 1) * pt - W`` when
    ``S * pt >= W``: so a ring of ``ceil(W / pt)`` slots loses no page the
    window still reaches.  A smaller ring is refused once it would wrap."""
    cur = int(pos) // pt
    if not window:
        return max(0, min(S, cur)), cur, 0
    if S * pt < window and cur >= S:
        raise ValueError(f"a ring of {S} page slots of {pt} tokens cannot hold a window of "
                         f"{window} tokens past position {S * pt - 1}")
    return min(S, cur), cur, max(0, int(pos) - window + 1)


def paged_attention_decode_plain(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike | PreparedTable, pos: int, cfg: FRConfig, *, n_kv: int, hd: int, groups: int,
    chunk_slots: int = PLAIN_CHUNK_SLOTS, window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version, on whatever device the pages lie.

    Decodes ``chunk_slots`` page slots per batch row at a time with
    :func:`fr_decode`, attends in float32 with the mask, the max, the
    ``<= -1e29 -> 0`` guard and the sums of the reference, and merges the
    chunks with :func:`merge_softmax`.  Chunks past ``pos // pt`` hold no
    valid token and are not decoded (merging them would change nothing).
    ``window``: the slots are a ring, each token masked by its page's
    position (:func:`ring_bounds`), as the kernel's ring instantiation.  A
    row over ``ppr`` slots: ``S`` counts tokens, and a chunk decodes its
    tokens' ``ppr`` slots each, whose words are the rows in order.
    """
    pt, ppr = attn_layout(cfg, n_kv, hd)
    B, S = _slot_groups(pages_k, ppr)
    dev = q.device
    qf = q.reshape(B, n_kv, groups, hd).float()
    scale = inv_sqrt(hd, dev)
    n_valid, cur, lo = ring_bounds(S, pos, pt, window)
    limit = cur * pt
    acc = torch.zeros(B, n_kv, groups, hd, dtype=torch.float32, device=dev)
    m = torch.full((B, n_kv, groups), MASKED, dtype=torch.float32, device=dev)
    l = torch.zeros(B, n_kv, groups, dtype=torch.float32, device=dev)
    bt = as_base_table(plain_table(table), default_width=cfg.widest_bits, device=dev)

    def decode(pages: dict[str, torch.Tensor], s0: int, s1: int) -> torch.Tensor:
        blob = flat_blob({k: v[:, s0 * ppr:s1 * ppr] for k, v in pages.items()})
        return words_to_bf16(fr_decode(blob, bt, cfg)).float().reshape(B, (s1 - s0) * pt, n_kv, hd)

    for s0 in range(0, n_valid, chunk_slots):
        s1 = min(S, s0 + chunk_slots)
        if window:      # each slot's page, by the ring; slots past n_valid fall before lo
            slot = torch.arange(s0, s1, device=dev)
            page = cur - 1 - torch.remainder(cur - 1 - slot, S)
            tok = (page[:, None] * pt + torch.arange(pt, device=dev)).reshape(-1)
            live = (tok < limit) & (tok >= lo)
        else:
            live = torch.arange(s0 * pt, s1 * pt, device=dev) < limit
        chunk = softmax_chunk(qf, decode(pages_k, s0, s1), decode(pages_v, s0, s1), live, scale)
        acc, m, l = merge_softmax(acc, m, l, *chunk)
    return acc, m, l


def paged_attention_decode_tail_plain(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike | PreparedTable, pos: int, cfg: FRConfig, *, k_tail: torch.Tensor,
    v_tail: torch.Tensor, n_kv: int, hd: int, groups: int, window: int = 0,
) -> torch.Tensor:
    """:func:`paged_attention_decode_tail`'s plain version: the plain pages'
    state (:func:`paged_attention_decode_plain`), then :func:`tail_merge`."""
    qf = q.reshape(q.shape[0], n_kv, groups, hd).float()
    state = paged_attention_decode_plain(qf, pages_k, pages_v, table, pos, cfg, n_kv=n_kv, hd=hd,
                                         groups=groups, window=window)
    return tail_merge(qf, state, k_tail, v_tail, pos, window=window)


def attn_iparams(cfg: FRConfig, *, n_kv: int, hd: int, groups: int, batch: int = 1,
                 n_slots: int = 1, n_valid: int = 1, splits: int = 1, run: int = 1,
                 pass_n: int | None = None) -> list[int]:
    """Scalar parameters in the order the kernel's ``unpack_params`` reads
    them; ``pass_n`` defaults to :func:`pass_slots`.  ``n_slots`` and
    ``n_valid`` count tokens where a row spans several page slots: the
    kernel derives the slots a row spans from ``n_kv * hd`` and the page."""
    n = pass_slots(cfg, n_kv=n_kv, hd=hd, groups=groups) if pass_n is None else pass_n
    pt, ppr = attn_layout(cfg, n_kv, hd)
    return kernel_iparams(cfg, batch * n_slots * ppr) + [
        batch, n_slots, n_valid, splits, run, n_kv, groups, hd, pt, n]


def _splits(n_valid: int, batch: int, *, sms: int, per_sm: int, pass_n: int,
            chunks: int = 1) -> tuple[int, int]:
    """(splits, slots per split) for a grid of (splits, batch, chunks) blocks.

    The run of each split is a whole number of passes, no split is empty, and the splits cover ``n_valid`` exactly.  Among the
    split counts that fill 1..MAX_WAVES whole waves of ``sms * per_sm``
    resident blocks, it takes the one with the least waves x (passes per
    block + 1), the +1 standing for a block's set-up and partial write.
    """
    if n_valid <= 0:
        return 1, 1
    slots = max(1, sms * per_sm)
    rows = max(1, batch * chunks)

    def plan(want: int) -> tuple[int, int]:
        run = -(-n_valid // max(1, min(want, n_valid)))
        run = -(-run // pass_n) * pass_n
        return -(-n_valid // run), run

    def cost(plan_: tuple[int, int]) -> tuple[int, int]:
        splits, run = plan_
        return -(-splits * rows // slots) * (-(-run // pass_n) + 1), splits

    return min((plan(max(1, w * slots // rows)) for w in range(1, MAX_WAVES + 1)), key=cost)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gbdi_paged_attn")
    for fn in (lib.gbdi_paged_attn_blocks_per_sm, lib.gbdi_paged_attn_ring_blocks_per_sm):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    launch = lib.gbdi_paged_attn_launch.argtypes
    for fn in (lib.gbdi_paged_attn_ring_launch, lib.gbdi_paged_attn_tail_launch):
        fn.argtypes = [*launch[:2], ctypes.POINTER(ctypes.c_int), launch[2]]
        fn.restype = ctypes.c_int
    lib.gbdi_paged_attn_decode_launch.argtypes = lib.gbdi_paged_attn_launch.argtypes
    lib.gbdi_paged_attn_decode_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(cfg: FRConfig, n_kv: int, hd: int, groups: int, device: int,
                   ring: bool = False) -> int:
    """Attention blocks one SM holds at once (the runtime's occupancy count),
    of the full or the ring instantiation."""
    ip = attn_iparams(cfg, n_kv=n_kv, hd=hd, groups=groups)
    lib = _lib()
    fn = lib.gbdi_paged_attn_ring_blocks_per_sm if ring else lib.gbdi_paged_attn_blocks_per_sm
    with torch.cuda.device(device):
        n = fn(_build.int_array(ip))
    if n <= 0:
        raise RuntimeError(f"gbdi_paged_attn occupancy query failed (code {n})")
    return n


class LaunchPlan(NamedTuple):
    """One launch: its geometry, the ``(batch, n_slots)`` page slots of
    which the first ``n_valid`` are read, in ``splits`` runs of ``run``
    slots (:func:`_splits`)."""

    geom: AttnGeometry
    batch: int
    n_slots: int
    n_valid: int
    splits: int
    run: int

    def iparams(self) -> list[int]:
        """The kernel's scalar parameters (:func:`attn_iparams`)."""
        g = self.geom
        return attn_iparams(g.cfg, n_kv=g.n_kv, hd=g.hd, groups=g.groups, batch=self.batch,
                            n_slots=self.n_slots, n_valid=self.n_valid, splits=self.splits,
                            run=self.run, pass_n=g.pass_n)


def _launch_plan(geom: AttnGeometry, B: int, S: int, n_valid: int, dev: torch.device,
                 ring: bool = False) -> LaunchPlan:
    """The plan of a call on ``dev`` over ``n_valid`` of ``S`` slots a row:
    the splits that fill the card's SMs, by the occupancy of the full or the
    ring instantiation."""
    g, sms = geom, torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = _blocks_per_sm(g.cfg, g.n_kv, g.hd, g.groups, dev.index or 0, ring)
    splits, run = _splits(n_valid, B, sms=sms, per_sm=per_sm, pass_n=g.pass_n, chunks=g.chunks)
    return LaunchPlan(geom, B, S, n_valid, splits, run)


def _table_ptrs(table: TableLike | PreparedTable, cfg: FRConfig,
                dev: torch.device) -> tuple[PreparedTable, list[int]]:
    """The memoised table (:func:`prepare_table`, shared with kernels A and
    B) and its padded bases', class indices' and meta's pointers."""
    prep = prepare_table(table, cfg, dev)
    check_prepared(prep, cfg)
    return prep, [prep.bases.data_ptr(), prep.cls.data_ptr(), prep.meta.data_ptr()]


def paged_attention_decode(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike | PreparedTable, pos: int, cfg: FRConfig, *, n_kv: int, hd: int,
    groups: int, window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised ``(acc, m, l)`` over the full pages before ``pos`` (with
    ``window``, those of the ring inside the window): the CUDA kernel for
    tensors on a CUDA device, the plain version on the CPU."""
    dev = pages_k["ptrs"].device
    if dev.type == "cuda":
        with obs.span("paged_attn"):
            return _attend_cuda(q, pages_k, pages_v, table, pos, cfg, n_kv=n_kv, hd=hd,
                                groups=groups, window=window)
    attn_geometry(cfg, n_kv=n_kv, hd=hd, groups=groups, window=window)
    if dev.type != "cpu":
        raise ValueError(f"paged_attention_decode runs on cuda (kernel) or cpu (plain), not {dev}")
    return paged_attention_decode_plain(q, pages_k, pages_v, table, pos, cfg,
                                        n_kv=n_kv, hd=hd, groups=groups, window=window)


def paged_attention_decode_tail(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike | PreparedTable, pos: int, cfg: FRConfig, *, k_tail: torch.Tensor,
    v_tail: torch.Tensor, n_kv: int, hd: int, groups: int, window: int = 0,
    merge=merge_softmax,
) -> torch.Tensor:
    """Attention of ``q (B, Kv, G, hd)`` at ``pos`` over the full pages (with
    ``window``, those of the ring inside the window) and the raw tail ring
    ``k_tail``/``v_tail (B, pt, Kv, hd)`` bf16, normalised: ``(B, Kv, G,
    hd)`` bf16.  On a CUDA device one launch of the kernel whose split merge
    also takes the tail, counted in ``launches.attn`` and
    ``launches.attn_tail``, inside the span ``paged_attn``; elsewhere, or
    where ``merge`` is not :func:`merge_softmax` (the one merge the kernel
    holds), :func:`paged_attention_decode` then :func:`tail_merge` with
    ``merge``."""
    if pages_k["ptrs"].device.type == "cuda" and merge is merge_softmax:
        with obs.span("paged_attn"):
            return _attend_cuda(q, pages_k, pages_v, table, pos, cfg, n_kv=n_kv, hd=hd,
                                groups=groups, window=window, tail=(k_tail, v_tail))
    qf = q.reshape(q.shape[0], n_kv, groups, hd).float()
    state = paged_attention_decode(qf, pages_k, pages_v, table, pos, cfg, n_kv=n_kv, hd=hd,
                                   groups=groups, window=window)
    return tail_merge(qf, state, k_tail, v_tail, pos, window=window, merge=merge)


def _attend_cuda(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike | PreparedTable, pos: int, cfg: FRConfig, *, n_kv: int, hd: int,
    groups: int, window: int = 0, tail: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """C's launch on the card: the state ``(acc, m, l)``, or with ``tail =
    (k_tail, v_tail)`` the tail form's bf16 output."""
    geom = attn_geometry(cfg, n_kv=n_kv, hd=hd, groups=groups, window=window)
    dev = pages_k["ptrs"].device
    B, S = _slot_groups(pages_k, geom.ppr)
    blob_k = blob_ptrs(pages_k, cfg, (B, S * geom.ppr), side="k ")
    blob_v = blob_ptrs(pages_v, cfg, (B, S * geom.ppr), side="v ")
    q = q.reshape(B, n_kv, groups, hd)
    if q.device != dev:
        raise ValueError(f"q lies on {q.device}, the pages on {dev}")
    q = q.float().contiguous()
    n_valid, cur, lo = ring_bounds(S, pos, geom.pt, window)
    plan = _launch_plan(geom, B, S, n_valid, dev, ring=bool(window))
    keep, table_ptrs = _table_ptrs(table, cfg, dev)

    def f32(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=dev)

    kg, splits = n_kv * groups, plan.splits
    part_acc, part_m, part_l = f32(B, splits, kg, hd), f32(B, splits, kg), f32(B, splits, kg)
    if tail is None:
        acc, m, l = f32(B, n_kv, groups, hd), f32(B, n_kv, groups), f32(B, n_kv, groups)
        res, outs = (acc, m, l), [acc.data_ptr(), m.data_ptr(), l.data_ptr()]
    else:
        k_tail, v_tail = (_check_tail(t, (B, geom.pt, n_kv, hd), dev).contiguous() for t in tail)
        out = torch.empty(B, n_kv, groups, hd, dtype=torch.bfloat16, device=dev)
        res, outs = out, [k_tail.data_ptr(), v_tail.data_ptr(), out.data_ptr()]
    ptrs = _build.ptr_array([
        q.data_ptr(), *blob_k, *blob_v, *table_ptrs,
        part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), *outs,
    ])
    ip = _build.int_array(plan.iparams())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if tail is not None:
            rc = _lib().gbdi_paged_attn_tail_launch(
                ptrs, ip, _build.int_array([pos, lo, 1 if window else 0]), stream)
        elif window:
            rc = _lib().gbdi_paged_attn_ring_launch(ptrs, ip, _build.int_array([cur, lo]), stream)
        else:
            rc = _lib().gbdi_paged_attn_launch(ptrs, ip, stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_paged_attn launch failed (code {rc})")
    if B:
        obs.count("launches.attn")
        if geom.ts > 1:
            obs.count("launches.attn_sliced")
        if tail is not None:
            obs.count("launches.attn_tail")
        if geom.ppr > 1:
            obs.count("launches.attn_multipage")
    return res


def _slot_groups(pages: dict[str, torch.Tensor], ppr: int) -> tuple[int, int]:
    """``(B, S)`` of a side's slots in groups of a row's ``ppr`` slots,
    raising where a row's slots are not whole."""
    B, S = pages["ptrs"].shape[:2]
    if S % ppr:
        raise ValueError(f"{S} page slots a row do not hold whole rows of {ppr} slots")
    return B, S // ppr


def _check_tail(t: torch.Tensor, shape: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """``t``, raising unless it is a raw tail ring the kernel can read: bf16
    of ``shape`` on ``dev``."""
    if t.dtype != torch.bfloat16 or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"the tail ring must be bf16 {shape} on {dev}, not "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def decode_pages(
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike | PreparedTable, n_valid: int, cfg: FRConfig, *, n_kv: int, hd: int,
    groups: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The words of the page slots of tokens ``[0, n_valid)`` (slots ``[0,
    n_valid)`` where a page holds whole rows; ``ppr`` slots a token where a
    row spans several) of every batch row, K and V, as int32 ``(B, n_valid
    * ppr, page_words)`` in slot order: on a CUDA device, from the kernel's
    own batched pass decode (split and staged exactly as the attention
    splits them, each head group's slots by its own blocks); on the CPU,
    from :func:`fr_decode`.  It exists to hold that decode bit for bit
    against the decode kernel, and counts no launch."""
    geom = attn_geometry(cfg, n_kv=n_kv, hd=hd, groups=groups)
    B, S = _slot_groups(pages_k, geom.ppr)
    n_valid = max(0, min(S, int(n_valid)))
    n_out = n_valid * geom.ppr
    dev = pages_k["ptrs"].device
    if dev.type == "cpu":
        bt = as_base_table(plain_table(table), default_width=cfg.widest_bits, device=dev)

        def plain(pages: dict[str, torch.Tensor]) -> torch.Tensor:
            blob = flat_blob({k: v[:, :n_out] for k, v in pages.items()})
            return fr_decode(blob, bt, cfg).reshape(B, n_out, cfg.page_words)

        return plain(pages_k), plain(pages_v)
    if dev.type != "cuda":
        raise ValueError(f"decode_pages runs on cuda (kernel) or cpu (plain), not {dev}")
    blob_k = blob_ptrs(pages_k, cfg, (B, S * geom.ppr), side="k ")
    blob_v = blob_ptrs(pages_v, cfg, (B, S * geom.ppr), side="v ")
    plan = _launch_plan(geom, B, S, n_valid, dev)
    keep, table_ptrs = _table_ptrs(table, cfg, dev)
    out_k, out_v = (torch.empty(B, n_out, cfg.page_words, dtype=torch.int16, device=dev)
                    for _ in "kv")
    ptrs = _build.ptr_array([*blob_k, *blob_v, *table_ptrs, out_k.data_ptr(), out_v.data_ptr()])
    with torch.cuda.device(dev):
        rc = _lib().gbdi_paged_attn_decode_launch(ptrs, _build.int_array(plan.iparams()),
                                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_paged_attn decode launch failed (code {rc})")
    return tuple(w.to(torch.int32) & WORD16_MASK for w in (out_k, out_v))  # type: ignore[return-value]


__all__ = [
    "MASKED", "AttnGeometry", "LaunchPlan", "attn_geometry", "attn_iparams", "attn_layout",
    "channel_chunks", "check_smem", "chunk_rows", "decode_pages", "inv_sqrt",
    "merge_softmax", "page_tokens", "pass_slots", "paged_attention_decode",
    "paged_attention_decode_plain", "paged_attention_decode_tail",
    "paged_attention_decode_tail_plain", "ring_bounds", "smem_bytes", "softmax_chunk",
    "tail_merge", "token_slices",
]
