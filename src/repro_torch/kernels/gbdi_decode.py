"""GBDI-FR v2 page decode: the CUDA kernel's wrapper, its plain version, its budget.

The kernel (``csrc/gbdi_decode.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/gbdi_decode.py`` (``gbdi_decode_pallas``).  It is bound by
bytes: one blob read and one page written per page.  A warp stages a page's
blob in shared memory, decodes it 128 words a step with the words in
registers, and writes each word once; see the source note for the design.
The plain version is :func:`repro_torch.core.gbdi_fr.fr_decode`, and the
kernel must match it bit for bit, on any blob of the right shapes.

:func:`gbdi_decode` launches the kernel when the blob lies on a CUDA device
and counts the launch in the counter ``launches.decode`` of
:mod:`repro_torch.obs`; for a blob on the CPU it runs
the plain version, and for any other device it raises.  The table may be a
:class:`~repro_torch.kernels.gbdi_encode.PreparedTable`; any other table is
prepared through the memo of :func:`~repro_torch.kernels.gbdi_encode.prepare_table`.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.format import TableLike
from repro_torch.core.gbdi_fr import FRConfig, fr_decode
from repro_torch.kernels import _build
from repro_torch.kernels.gbdi_encode import (
    MAX_CLASSES,
    SMEM_LIMIT_BYTES,
    PreparedTable,
    blob_ptrs,
    check_prepared,
    check_smem,
    kernel_iparams,
    plain_table,
    prepare_table,
)

#: warps of a decode block at most (``kMaxWarps``): a warp decodes one page at a time
MAX_WARPS = 4

def _align4(n: int) -> int:
    return (n + 3) & ~3


def block_warps(cfg: FRConfig) -> int:
    """Warps of a decode block (``dec_warps``): as many as fit shared
    memory, at most :data:`MAX_WARPS`; 0 where not one warp's page fits."""
    fixed, per_warp = _smem_ints(cfg)
    return min(MAX_WARPS, (SMEM_LIMIT_BYTES // 4 - fixed) // per_warp)


def _smem_ints(cfg: FRConfig) -> tuple[int, int]:
    """(ints of the block's table and profile meta, ints a warp stages)."""
    n_tab = 1 << cfg.ptr_bits if cfg.ptr_bits <= 8 else cfg.num_bases + 2
    fixed = _align4(2 * n_tab + 2 * cfg.num_profiles * cfg.num_classes)
    per_warp = (2 * (cfg.page_words // 32) + 4 * (MAX_CLASSES + 2) + _align4(cfg.ptr_lanes)
                + _align4(cfg.delta_lanes) + 2 * _align4(cfg.outlier_cap))
    return fixed, per_warp


def smem_bytes(cfg: FRConfig) -> int:
    """Dynamic shared memory of one decode block (mirrors ``dec_smem_bytes``):
    the code table as (base, class) pairs (every code of pointers up to 8
    bits, else the bases and two entries), and the profiles' caps and lane
    offsets; then for each warp its outlier bitmap (a bit a page word and
    the slot of each 32 bits' first), its page's class table and a zero
    lane, and its page's staged blob (ptr and delta lanes, outlier indices
    and values).  Where not one warp fits, one warp's need (past the
    limit)."""
    fixed, per_warp = _smem_ints(cfg)
    return 4 * (fixed + max(block_warps(cfg), 1) * per_warp)


def gbdi_decode_plain(blob: dict[str, torch.Tensor], table: TableLike | PreparedTable,
                      cfg: FRConfig) -> torch.Tensor:
    """The kernel's plain PyTorch version (on whatever device the blob lies)."""
    return fr_decode(blob, plain_table(table), cfg)


def gbdi_decode(blob: dict[str, torch.Tensor], table: TableLike | PreparedTable,
                cfg: FRConfig) -> torch.Tensor:
    """Decode a blob to (n_pages, page_words) int32 pages: the CUDA kernel
    for a blob on a CUDA device, the plain version for one on the CPU."""
    dev = blob["ptrs"].device
    if dev.type == "cpu":
        return gbdi_decode_plain(blob, table, cfg)
    if dev.type != "cuda":
        raise ValueError(f"gbdi_decode runs on cuda (kernel) or cpu (plain), not {dev}")
    n = blob["ptrs"].shape[0]
    blob_in = blob_ptrs(blob, cfg, (n,))
    check_smem(cfg, smem_bytes(cfg))
    prep = prepare_table(table, cfg, dev)
    check_prepared(prep, cfg)
    bases, cls, meta = prep.bases, prep.cls, prep.meta
    out = torch.empty((n, cfg.page_words), dtype=torch.int32, device=dev)
    lib = _build.load("gbdi_decode")
    ptrs = _build.ptr_array([*blob_in, bases.data_ptr(), cls.data_ptr(), meta.data_ptr(),
                             out.data_ptr()])
    with torch.cuda.device(dev):
        rc = lib.gbdi_decode_launch(ptrs, _build.int_array(kernel_iparams(cfg, n)),
                                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_decode launch failed (code {rc})")
    if n:
        obs.count("launches.decode")
    return out


__all__ = ["MAX_WARPS", "block_warps", "gbdi_decode", "gbdi_decode_plain", "smem_bytes"]
