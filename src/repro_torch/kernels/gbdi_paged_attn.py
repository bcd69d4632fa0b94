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
device and counts the launch in :data:`launch_count`; for tensors on the
CPU it runs :func:`paged_attention_decode_plain`, and for any other device
it raises.  Both paths first check the geometry (16-bit words,
``page_words`` holding a whole number of ``Kv * hd`` rows) and the
block's shared memory (:func:`check_smem`, where the reference's VMEM check
stood), which also fixes the kernel's pass size: the page slots it decodes
at once (:func:`pass_slots`).  :func:`decode_pages` exposes that batched
decode alone, so it can be held bit for bit against the decode kernel.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.format import TableLike, as_base_table
from repro_torch.core.gbdi_fr import FRConfig, fr_decode, words_to_bf16
from repro_torch.kernels import _build
from repro_torch.kernels.gbdi_encode import (
    MAX_CLASSES,
    SMEM_LIMIT_BYTES,
    check_cuda_input,
    k_padded,
    kernel_iparams,
    kernel_meta,
    pad_table,
)

#: kernel launches made by :func:`paged_attention_decode` (CUDA tensors only)
launch_count = 0
#: the mask sentinel, and the score at or below which a probability is 0:
#: with -inf an all-masked run would give exp(-inf - -inf) = NaN
MASKED = -1e30
MASKED_GUARD = -1e29
#: page slots the plain version decodes at a time (per batch row)
PLAIN_CHUNK_SLOTS = 1024
#: blob fields in the order the kernel takes their pointers (profile last)
BLOB_KEYS = ("ptrs", "deltas", "out_vals", "out_idx", "n_out")
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


def page_tokens(cfg: FRConfig, n_kv: int, hd: int) -> int:
    """Tokens per page; raises unless a page holds whole ``Kv * hd`` rows."""
    row = n_kv * hd
    if row <= 0 or cfg.page_words % row:
        raise ValueError(
            f"paged attention needs page_words ({cfg.page_words}) to hold a whole "
            f"number of Kv*hd = {row} rows")
    return cfg.page_words // row


def channels_per_lane(hd: int) -> int:
    """The power of two ``c`` with ``32 * c >= hd`` (mirrors ``cpl_of``)."""
    c = 1
    while 32 * c < hd:
        c *= 2
    return c


def chunk_rows(kg: int, hd: int) -> int:
    """(kv, group) rows one block holds (mirrors ``chunk_rows``): 16 warps of
    32 / channels-per-lane rows, 1 at 8 channels a lane; more rows go to
    further row chunks, each decoding the pages again."""
    cpl = min(channels_per_lane(hd), CHUNK_CHANNELS // 32)
    return min(kg, ATTN_WARPS * (1 if cpl >= 8 else 32 // cpl))


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
    per pass (default: :func:`pass_slots`), mirroring ``attn_smem_bytes``: q,
    m, l, alpha and the tile's p for the block's rows; the code table and
    a class mask; every profile's caps and lane offsets, and each page's;
    per-class counts of each 128-word group; the decoded pass as bf16; and
    two staged passes (K and V sides, each field of the pass contiguous)."""
    page_tokens(cfg, n_kv, hd)
    n = pass_slots(cfg, n_kv=n_kv, hd=hd, groups=groups) if n_slots is None else n_slots
    R = chunk_rows(n_kv * groups, hd)
    pages = 2 * n
    groups_per_page = cfg.page_words // GROUP_WORDS
    a4 = lambda x: -(-x // 4) * 4  # noqa: E731
    side = (a4(n * cfg.ptr_lanes) + a4(n * cfg.delta_lanes) + 2 * a4(n * cfg.outlier_cap)
            + 2 * a4(n))
    return (_a16(4 * R * hd) + 3 * _a16(4 * R) + _a16(4 * R * TILE_TOKENS)
            + _a16(4 * (k_padded(cfg) + 2)) + 16
            + _a16(8 * cfg.num_profiles * cfg.num_classes) + 2 * _a16(4 * pages * MAX_CLASSES)
            + _a16(4 * cfg.num_classes * pages * groups_per_page)
            + _a16(2 * pages * cfg.page_words) + 4 * 2 * 2 * side)


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


def check_kernel_geometry(cfg: FRConfig, hd: int) -> None:
    """What the kernel takes beyond the shared-memory budget: bf16 pages
    (16-bit words).  Both paths check it, so the CPU's answer is the card's;
    the head dim is bounded by the shared-memory check alone."""
    if cfg.word_bits != 16:
        raise ValueError(f"the paged-attention kernel reads 16-bit (bf16) KV pages, "
                         f"not word_bits={cfg.word_bits}")


def inv_sqrt(hd: int, device: torch.device | str) -> torch.Tensor:
    """1/sqrt(hd) formed in float32, as the reference and the kernel form it
    (``1.0f / sqrtf(hd)``, both IEEE-rounded), as a 0-dim float32 tensor.  A
    double ``1 / math.sqrt(hd)`` rounded to float32 differs from it at many
    head dims (96, 112, 384 among them), and so does torch's CPU ``sqrt`` of
    a float32 scalar at hd 267; numpy's float32 ``sqrt`` is IEEE-rounded."""
    scale = np.float32(1) / np.sqrt(np.float32(hd))
    return torch.tensor(scale, dtype=torch.float32, device=device)


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


def paged_attention_decode_plain(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike, pos: int, cfg: FRConfig, *, n_kv: int, hd: int, groups: int,
    chunk_slots: int = PLAIN_CHUNK_SLOTS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version, on whatever device the pages lie.

    Decodes ``chunk_slots`` page slots per batch row at a time with
    :func:`fr_decode`, attends in float32 with the mask, the max, the
    ``<= -1e29 -> 0`` guard and the sums of the reference, and merges the
    chunks with :func:`merge_softmax`.  Chunks past ``pos // pt`` hold no
    valid token and are not decoded (merging them would change nothing).
    """
    pt = page_tokens(cfg, n_kv, hd)
    B, S = pages_k["ptrs"].shape[:2]
    dev = q.device
    qf = q.reshape(B, n_kv, groups, hd).float()
    scale = inv_sqrt(hd, dev)
    limit = (int(pos) // pt) * pt
    acc = torch.zeros(B, n_kv, groups, hd, dtype=torch.float32, device=dev)
    m = torch.full((B, n_kv, groups), MASKED, dtype=torch.float32, device=dev)
    l = torch.zeros(B, n_kv, groups, dtype=torch.float32, device=dev)
    bt = as_base_table(table, default_width=cfg.widest_bits, device=dev)

    def decode(pages: dict[str, torch.Tensor], s0: int, s1: int) -> torch.Tensor:
        blob = {k: v[:, s0:s1].reshape((B * (s1 - s0),) + v.shape[2:]) for k, v in pages.items()}
        return words_to_bf16(fr_decode(blob, bt, cfg)).float().reshape(B, (s1 - s0) * pt, n_kv, hd)

    for s0 in range(0, min(S, limit // pt), chunk_slots):
        s1 = min(S, s0 + chunk_slots)
        K, V = decode(pages_k, s0, s1), decode(pages_v, s0, s1)
        logits = torch.einsum("bkgh,btkh->bkgt", qf, K) * scale
        tok = torch.arange(s0 * pt, s1 * pt, device=dev)
        logits = torch.where((tok < limit)[None, None, None, :], logits, MASKED)
        mc = logits.max(dim=-1).values
        p = torch.where(logits <= MASKED_GUARD, 0.0, torch.exp(logits - mc[..., None]))
        accc = torch.einsum("bkgt,btkh->bkgh", p, V)
        acc, m, l = merge_softmax(acc, m, l, accc, mc, p.sum(dim=-1))
    return acc, m, l


def attn_iparams(cfg: FRConfig, *, n_kv: int, hd: int, groups: int, batch: int = 1,
                 n_slots: int = 1, n_valid: int = 1, splits: int = 1, run: int = 1,
                 pass_n: int | None = None) -> list[int]:
    """Scalar parameters in the order the kernel's ``unpack_params`` reads
    them; ``pass_n`` defaults to :func:`pass_slots`."""
    n = pass_slots(cfg, n_kv=n_kv, hd=hd, groups=groups) if pass_n is None else pass_n
    return kernel_iparams(cfg, batch * n_slots) + [
        batch, n_slots, n_valid, splits, run, n_kv, groups, hd, page_tokens(cfg, n_kv, hd), n]


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
    lib.gbdi_paged_attn_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.gbdi_paged_attn_blocks_per_sm.restype = ctypes.c_int
    lib.gbdi_paged_attn_decode_launch.argtypes = lib.gbdi_paged_attn_launch.argtypes
    lib.gbdi_paged_attn_decode_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(cfg: FRConfig, n_kv: int, hd: int, groups: int, device: int) -> int:
    """Attention blocks one SM holds at once (the runtime's occupancy count)."""
    ip = attn_iparams(cfg, n_kv=n_kv, hd=hd, groups=groups)
    with torch.cuda.device(device):
        n = _lib().gbdi_paged_attn_blocks_per_sm(_build.int_array(ip))
    if n <= 0:
        raise RuntimeError(f"gbdi_paged_attn occupancy query failed (code {n})")
    return n


def _launch_plan(cfg: FRConfig, B: int, S: int, pos: int, dev: torch.device, *, n_kv: int,
                 hd: int, groups: int, n_valid: int | None = None) -> list[int]:
    """The kernel's iparams for a call on ``dev``: pass size, splits, run."""
    pass_n = check_smem(cfg, n_kv=n_kv, hd=hd, groups=groups)
    pt = page_tokens(cfg, n_kv, hd)
    if n_valid is None:
        n_valid = max(0, min(S, int(pos) // pt))
    chunks = -(-(n_kv * groups) // chunk_rows(n_kv * groups, hd)) * channel_chunks(hd)
    splits, run = _splits(
        n_valid, B, sms=torch.cuda.get_device_properties(dev).multi_processor_count,
        per_sm=_blocks_per_sm(cfg, n_kv, hd, groups, dev.index or 0), pass_n=pass_n,
        chunks=chunks)
    return attn_iparams(cfg, n_kv=n_kv, hd=hd, groups=groups, batch=B, n_slots=S,
                        n_valid=n_valid, splits=splits, run=run, pass_n=pass_n)


def _check_pages(cfg: FRConfig, pages_k: dict[str, torch.Tensor],
                 pages_v: dict[str, torch.Tensor]) -> tuple[int, int]:
    B, S = pages_k["ptrs"].shape[:2]
    shapes = {"ptrs": (B, S, cfg.ptr_lanes), "deltas": (B, S, cfg.delta_lanes),
              "out_vals": (B, S, cfg.outlier_cap), "out_idx": (B, S, cfg.outlier_cap),
              "n_out": (B, S)}
    if cfg.num_profiles > 1:
        shapes["profile"] = (B, S)
    for side, pages in (("k", pages_k), ("v", pages_v)):
        for key, shape in shapes.items():
            check_cuda_input(pages[key], f"{side} {key}", shape)
    return B, S


def _blob_ptrs(cfg: FRConfig, pages: dict[str, torch.Tensor]) -> list[int]:
    return [*(pages[k].data_ptr() for k in BLOB_KEYS),
            pages["profile"].data_ptr() if cfg.num_profiles > 1 else 0]


def _table_ptrs(table: TableLike, cfg: FRConfig, dev: torch.device) -> tuple[list[torch.Tensor], list[int]]:
    bt = as_base_table(table, default_width=cfg.widest_bits, device=dev)
    keep = [*(t.reshape(-1).contiguous() for t in pad_table(bt, cfg)), kernel_meta(cfg, dev)]
    return keep, [t.data_ptr() for t in keep]


def paged_attention_decode(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike, pos: int, cfg: FRConfig, *, n_kv: int, hd: int, groups: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised ``(acc, m, l)`` over the full pages before ``pos``: the
    CUDA kernel for tensors on a CUDA device, the plain version on the CPU."""
    global launch_count
    check_kernel_geometry(cfg, hd)
    check_smem(cfg, n_kv=n_kv, hd=hd, groups=groups)
    dev = pages_k["ptrs"].device
    if dev.type == "cpu":
        return paged_attention_decode_plain(q, pages_k, pages_v, table, pos, cfg,
                                            n_kv=n_kv, hd=hd, groups=groups)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_decode runs on cuda (kernel) or cpu (plain), not {dev}")
    B, S = _check_pages(cfg, pages_k, pages_v)
    q = q.reshape(B, n_kv, groups, hd)
    if q.device != dev:
        raise ValueError(f"q lies on {q.device}, the pages on {dev}")
    q = q.float().contiguous()
    ip = _launch_plan(cfg, B, S, pos, dev, n_kv=n_kv, hd=hd, groups=groups)
    splits, kg = ip[-7], n_kv * groups
    keep, table_ptrs = _table_ptrs(table, cfg, dev)

    def f32(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=dev)

    part_acc, part_m, part_l = f32(B, splits, kg, hd), f32(B, splits, kg), f32(B, splits, kg)
    acc, m, l = f32(B, n_kv, groups, hd), f32(B, n_kv, groups), f32(B, n_kv, groups)
    ptrs = _build.ptr_array([
        q.data_ptr(), *_blob_ptrs(cfg, pages_k), *_blob_ptrs(cfg, pages_v), *table_ptrs,
        part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
    ])
    with torch.cuda.device(dev):
        rc = _lib().gbdi_paged_attn_launch(ptrs, _build.int_array(ip),
                                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_paged_attn launch failed (code {rc})")
    if B:
        launch_count += 1
    return acc, m, l


def decode_pages(
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike, n_valid: int, cfg: FRConfig, *, n_kv: int, hd: int, groups: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The words of page slots ``[0, n_valid)`` of every batch row, K and V,
    as int32 ``(B, n_valid, page_words)``: on a CUDA device, from the
    kernel's own batched pass decode (split and staged exactly as the
    attention splits them); on the CPU, from :func:`fr_decode`.  It exists
    to hold that decode bit for bit against the decode kernel, and counts
    no launch."""
    check_kernel_geometry(cfg, hd)
    check_smem(cfg, n_kv=n_kv, hd=hd, groups=groups)
    B, S = pages_k["ptrs"].shape[:2]
    n_valid = max(0, min(S, int(n_valid)))
    dev = pages_k["ptrs"].device
    if dev.type == "cpu":
        bt = as_base_table(table, default_width=cfg.widest_bits, device=dev)

        def plain(pages: dict[str, torch.Tensor]) -> torch.Tensor:
            blob = {k: v[:, :n_valid].reshape((B * n_valid,) + v.shape[2:]) for k, v in pages.items()}
            return fr_decode(blob, bt, cfg).reshape(B, n_valid, cfg.page_words)

        return plain(pages_k), plain(pages_v)
    if dev.type != "cuda":
        raise ValueError(f"decode_pages runs on cuda (kernel) or cpu (plain), not {dev}")
    _check_pages(cfg, pages_k, pages_v)
    ip = _launch_plan(cfg, B, S, 0, dev, n_kv=n_kv, hd=hd, groups=groups, n_valid=n_valid)
    keep, table_ptrs = _table_ptrs(table, cfg, dev)
    out_k, out_v = (torch.empty(B, n_valid, cfg.page_words, dtype=torch.int16, device=dev)
                    for _ in "kv")
    ptrs = _build.ptr_array([*_blob_ptrs(cfg, pages_k), *_blob_ptrs(cfg, pages_v), *table_ptrs,
                             out_k.data_ptr(), out_v.data_ptr()])
    with torch.cuda.device(dev):
        rc = _lib().gbdi_paged_attn_decode_launch(ptrs, _build.int_array(ip),
                                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_paged_attn decode launch failed (code {rc})")
    return tuple(w.to(torch.int32) & 0xFFFF for w in (out_k, out_v))  # type: ignore[return-value]


__all__ = [
    "MASKED", "attn_iparams", "channel_chunks", "check_kernel_geometry", "check_smem", "chunk_rows",
    "decode_pages", "inv_sqrt", "launch_count", "merge_softmax", "page_tokens", "pass_slots",
    "paged_attention_decode", "paged_attention_decode_plain", "smem_bytes",
]
