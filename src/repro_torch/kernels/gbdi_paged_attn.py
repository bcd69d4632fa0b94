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
it raises.  Both paths first check the geometry (``page_words`` must hold a
whole number of ``Kv * hd`` rows) and the block's shared memory
(:func:`check_smem`, where the reference's VMEM check stood).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.format import TableLike, as_base_table
from repro_torch.core.gbdi_fr import FRConfig, fr_decode, words_to_bf16
from repro_torch.kernels import _build
from repro_torch.kernels import gbdi_decode as _dec
from repro_torch.kernels.gbdi_encode import (
    SMEM_LIMIT_BYTES,
    check_cuda_input,
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
#: blocks per SM the wrapper aims the split count at
BLOCKS_PER_SM = 4
#: blob fields in the order the kernel takes their pointers (profile last)
BLOB_KEYS = ("ptrs", "deltas", "out_vals", "out_idx", "n_out")


def page_tokens(cfg: FRConfig, n_kv: int, hd: int) -> int:
    """Tokens per page; raises unless a page holds whole ``Kv * hd`` rows."""
    row = n_kv * hd
    if row <= 0 or cfg.page_words % row:
        raise ValueError(
            f"paged attention needs page_words ({cfg.page_words}) to hold a whole "
            f"number of Kv*hd = {row} rows")
    return cfg.page_words // row


def smem_bytes(cfg: FRConfig, *, n_kv: int, hd: int, groups: int) -> int:
    """Dynamic shared memory of one attention block (mirrors ``attn_smem_bytes``):
    the decode planes, one decoded K and V page as float32, q, acc, m, l,
    alpha, the kv head and the scores of one page for every (kv, group),
    and two slots' K and V blobs staged by asynchronous copies."""
    pt = page_tokens(cfg, n_kv, hd)
    kg = n_kv * groups
    dec = -(-_dec.smem_bytes(cfg) // 16) * 16
    blob = cfg.ptr_lanes + cfg.delta_lanes + 2 * cfg.outlier_cap + 2
    return dec + 4 * (2 * cfg.page_words + 2 * kg * hd + 4 * kg + kg * pt + 4 * blob)


def check_smem(cfg: FRConfig, *, n_kv: int, hd: int, groups: int) -> None:
    need = smem_bytes(cfg, n_kv=n_kv, hd=hd, groups=groups)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a paged-attention block needs {need} B of shared memory "
            f"(> {SMEM_LIMIT_BYTES} B on Hopper); shrink page_words "
            f"(={cfg.page_words}) or the heads (n_kv={n_kv}, groups={groups}, hd={hd})")


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
    scale = 1.0 / math.sqrt(hd)
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
                 n_slots: int = 1, n_valid: int = 1, splits: int = 1, run: int = 1) -> list[int]:
    """Scalar parameters in the order the kernel's ``unpack`` reads them."""
    return kernel_iparams(cfg, batch * n_slots) + [
        batch, n_slots, n_valid, splits, run, n_kv, groups, hd, page_tokens(cfg, n_kv, hd)]


def _splits(n_valid: int, batch: int, dev: torch.device) -> tuple[int, int]:
    """(splits, slots per split): about BLOCKS_PER_SM blocks per SM, no empty split."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, min(n_valid, -(-BLOCKS_PER_SM * sms // max(batch, 1))))
    run = max(1, -(-n_valid // want))
    return max(1, -(-n_valid // run)), run


def paged_attention_decode(
    q: torch.Tensor,
    pages_k: dict[str, torch.Tensor], pages_v: dict[str, torch.Tensor],
    table: TableLike, pos: int, cfg: FRConfig, *, n_kv: int, hd: int, groups: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Un-normalised ``(acc, m, l)`` over the full pages before ``pos``: the
    CUDA kernel for tensors on a CUDA device, the plain version on the CPU."""
    global launch_count
    pt = page_tokens(cfg, n_kv, hd)
    check_smem(cfg, n_kv=n_kv, hd=hd, groups=groups)
    dev = pages_k["ptrs"].device
    if dev.type == "cpu":
        return paged_attention_decode_plain(q, pages_k, pages_v, table, pos, cfg,
                                            n_kv=n_kv, hd=hd, groups=groups)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_decode runs on cuda (kernel) or cpu (plain), not {dev}")
    B, S = pages_k["ptrs"].shape[:2]
    shapes = {"ptrs": (B, S, cfg.ptr_lanes), "deltas": (B, S, cfg.delta_lanes),
              "out_vals": (B, S, cfg.outlier_cap), "out_idx": (B, S, cfg.outlier_cap),
              "n_out": (B, S)}
    if cfg.num_profiles > 1:
        shapes["profile"] = (B, S)
    for side, pages in (("k", pages_k), ("v", pages_v)):
        for key, shape in shapes.items():
            check_cuda_input(pages[key], f"{side} {key}", shape)
    q = q.reshape(B, n_kv, groups, hd)
    if q.device != dev:
        raise ValueError(f"q lies on {q.device}, the pages on {dev}")
    q = q.float().contiguous()
    n_valid = max(0, min(S, int(pos) // pt))
    splits, run = _splits(n_valid, B, dev)
    kg = n_kv * groups
    bt = as_base_table(table, default_width=cfg.widest_bits, device=dev)
    bases, cls = (t.reshape(-1).contiguous() for t in pad_table(bt, cfg))
    meta = kernel_meta(cfg, dev)

    def f32(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=dev)

    part_acc, part_m, part_l = f32(B, splits, kg, hd), f32(B, splits, kg), f32(B, splits, kg)
    acc, m, l = f32(B, n_kv, groups, hd), f32(B, n_kv, groups), f32(B, n_kv, groups)

    def blob_ptrs(pages: dict[str, torch.Tensor]) -> list[int]:
        return [*(pages[k].data_ptr() for k in BLOB_KEYS),
                pages["profile"].data_ptr() if cfg.num_profiles > 1 else 0]

    lib = _build.load("gbdi_paged_attn")
    ptrs = _build.ptr_array([
        q.data_ptr(), *blob_ptrs(pages_k), *blob_ptrs(pages_v),
        bases.data_ptr(), cls.data_ptr(), meta.data_ptr(),
        part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
    ])
    ip = attn_iparams(cfg, n_kv=n_kv, hd=hd, groups=groups, batch=B, n_slots=S,
                      n_valid=n_valid, splits=splits, run=run)
    with torch.cuda.device(dev):
        rc = lib.gbdi_paged_attn_launch(ptrs, _build.int_array(ip),
                                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_paged_attn launch failed (code {rc})")
    if B:
        launch_count += 1
    return acc, m, l


__all__ = [
    "MASKED", "attn_iparams", "check_smem", "launch_count", "merge_softmax",
    "page_tokens", "paged_attention_decode", "paged_attention_decode_plain", "smem_bytes",
]
