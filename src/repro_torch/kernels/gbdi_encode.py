"""GBDI-FR v2 page encode: the CUDA kernel's wrapper, its plain version, its budget.

The kernel (``csrc/gbdi_encode.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/gbdi_encode.py`` (``gbdi_encode_pallas``).  It is bound by
bytes: one page read and one blob written per page; see the source note for
the design.  The plain version is :func:`repro_torch.core.gbdi_fr.fr_encode`,
and the kernel must match it bit for bit.

:func:`gbdi_encode` launches the kernel for a CUDA tensor and counts the
launch in :data:`launch_count`; for a tensor on the CPU it runs the plain
version (there is no kernel there), and for any other device it raises.
The shared-memory budget check (:func:`check_smem`) stands where the
reference's VMEM check stood: a config whose page does not fit one block's
227 KB raises, with no fallback, and so does a page past the
:data:`MAX_PAGE_WORDS` whose words the block's threads hold in registers.
"""
from __future__ import annotations

import torch

from repro_torch.core.format import BaseTable, TableLike, as_base_table, class_indices
from repro_torch.core.gbdi_fr import FRConfig, fr_encode
from repro_torch.kernels import _build

#: dynamic shared memory one Hopper block may use (227 KB)
SMEM_LIMIT_BYTES = 232448
#: ints of per-block scalars the kernels keep in shared memory
MISC_INTS = 16
#: classes a width set can hold: subsets of (1, 2, 4, 8, 16)
MAX_CLASSES = 5
#: the encode block's threads, and the most page words a thread holds
#: (``kThreads``, ``kMaxWords``): pages up to 16,640 words
ENCODE_THREADS = 256
MAX_PAGE_WORDS = ENCODE_THREADS * 65

#: kernel launches made by :func:`gbdi_encode` (CUDA tensors only)
launch_count = 0


def k_padded(cfg: FRConfig) -> int:
    """Base-table padding to a multiple of 8 entries."""
    return max(8, -(-cfg.num_bases // 8) * 8)


def pad_table(table: BaseTable, cfg: FRConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(1, k_pad) padded bases + width-class indices; padded entries carry
    the dead-entry sentinel class, like bases of a foreign width."""
    pad = k_padded(cfg) - cfg.num_bases
    b = table.bases.to(torch.int32)
    bases = torch.cat([b, b[:1].expand(pad)])[None, :]
    cls = class_indices(table.widths, cfg.width_set)
    cls = torch.cat([cls, torch.full((pad,), cfg.num_classes, dtype=torch.int32,
                                     device=cls.device)])[None, :]
    return bases, cls


def smem_bytes(cfg: FRConfig) -> int:
    """Dynamic shared memory of one encode block (mirrors ``enc_smem_bytes``):
    the table as (nb, lim) pairs, per-class entry masks of each 32-entry
    block, chunk masks and prefix, the delta lanes, scalars."""
    k = k_padded(cfg)
    return 4 * (2 * k + MAX_CLASSES * -(-k // 32) + 2 * (cfg.page_words // 32) + 1
                + cfg.delta_lanes + MISC_INTS)


def check_smem(cfg: FRConfig, need: int | None = None) -> None:
    """Raise unless a block fits: ``need`` bytes of shared memory (default:
    the encode block's, whose page must also be at most MAX_PAGE_WORDS)."""
    if need is None:
        need = smem_bytes(cfg)
        if cfg.page_words > MAX_PAGE_WORDS:
            raise ValueError(
                f"a {cfg.page_words}-word page is past the encode kernel's {MAX_PAGE_WORDS} "
                f"words ({MAX_PAGE_WORDS // ENCODE_THREADS} a thread of a block); lower page_words")
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a {cfg.page_words}-word page needs {need} B of shared memory per "
            f"block (> {SMEM_LIMIT_BYTES} B on Hopper); lower page_words")


def kernel_meta(cfg: FRConfig, device: torch.device) -> torch.Tensor:
    """caps[np*nc] | lane offsets[np*nc] | 8*bytes[np], int32 on ``device``."""
    caps = [c for prof in cfg.profiles for c in prof]
    offs = [o for p in range(cfg.num_profiles) for o in cfg.class_lane_offsets_for(p)]
    cost8 = [8 * cfg.compressed_bytes_for_profile(p) for p in range(cfg.num_profiles)]
    return torch.tensor(caps + offs + cost8, dtype=torch.int32, device=device)


def kernel_iparams(cfg: FRConfig, n_pages: int) -> list[int]:
    """Scalar parameters in the order both kernels' ``unpack`` reads them."""
    widths = list(cfg.width_set) + [0] * (MAX_CLASSES - cfg.num_classes)
    return [n_pages, cfg.page_words, cfg.word_bits, cfg.num_bases, k_padded(cfg),
            cfg.num_classes, cfg.num_profiles, cfg.ptr_bits, cfg.ptr_lanes,
            cfg.delta_lanes, cfg.outlier_cap, cfg.drop_penalty_bits, *widths]


def check_cuda_input(t: torch.Tensor, name: str, shape: tuple[int, ...]) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def gbdi_encode_plain(x_pages: torch.Tensor, table: TableLike, cfg: FRConfig) -> dict[str, torch.Tensor]:
    """The kernel's plain PyTorch version (on whatever device ``x_pages`` lies)."""
    return fr_encode(x_pages, table, cfg)


def gbdi_encode(x_pages: torch.Tensor, table: TableLike, cfg: FRConfig) -> dict[str, torch.Tensor]:
    """Encode (n_pages, page_words) int32 pages: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    global launch_count
    dev = x_pages.device
    if dev.type == "cpu":
        return gbdi_encode_plain(x_pages, table, cfg)
    if dev.type != "cuda":
        raise ValueError(f"gbdi_encode runs on cuda (kernel) or cpu (plain), not {dev}")
    n = x_pages.shape[0]
    check_cuda_input(x_pages, "x_pages", (n, cfg.page_words))
    check_smem(cfg)
    bt = as_base_table(table, default_width=cfg.widest_bits, device=dev)
    bases, cls = (t.reshape(-1).contiguous() for t in pad_table(bt, cfg))
    meta = kernel_meta(cfg, dev)

    def out(*shape: int) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.int32, device=dev)

    blob = {
        "ptrs": out(n, cfg.ptr_lanes),
        "deltas": out(n, cfg.delta_lanes),
        "out_vals": out(n, cfg.outlier_cap),
        "out_idx": out(n, cfg.outlier_cap),
        "n_out": out(n),
        "n_spilled": out(n),
        "n_dropped": out(n),
    }
    if cfg.num_profiles > 1:
        blob["profile"] = out(n)
    lib = _build.load("gbdi_encode")
    ptrs = _build.ptr_array([
        x_pages.data_ptr(), bases.data_ptr(), cls.data_ptr(), meta.data_ptr(),
        *(blob[k].data_ptr() for k in ("ptrs", "deltas", "out_vals", "out_idx",
                                       "n_out", "n_spilled", "n_dropped")),
        blob["profile"].data_ptr() if cfg.num_profiles > 1 else 0,
    ])
    # the temporaries above may be freed before the kernel runs: the caching
    # allocator hands their memory out again only in stream order
    with torch.cuda.device(dev):
        rc = lib.gbdi_encode_launch(ptrs, _build.int_array(kernel_iparams(cfg, n)),
                                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_encode launch failed (code {rc})")
    if n:
        launch_count += 1
    return blob


__all__ = [
    "MAX_PAGE_WORDS", "SMEM_LIMIT_BYTES", "check_smem", "gbdi_encode",
    "gbdi_encode_plain", "k_padded", "kernel_iparams", "kernel_meta",
    "launch_count", "pad_table", "smem_bytes",
]
