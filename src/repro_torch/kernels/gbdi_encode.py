"""GBDI-FR v2 page encode: the CUDA kernel's wrapper, its plain version, its budget.

The kernel (``csrc/gbdi_encode.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/gbdi_encode.py`` (``gbdi_encode_pallas``).  It is bound by
bytes: one page read and one blob written per page; see the source note for
the design.  The plain version is :func:`repro_torch.core.gbdi_fr.fr_encode`,
and the kernel must match it bit for bit.

:func:`gbdi_encode` launches the kernel for a CUDA tensor and counts the
launch in the counter ``launches.encode`` of :mod:`repro_torch.obs` (its
host work is the span ``encode``); for a tensor on the CPU it runs the plain
version (there is no kernel there), and for any other device it raises.
The shared-memory budget check (:func:`check_smem`) stands where the
reference's VMEM check stood: a config whose page does not fit one block's
227 KB raises, with no fallback, and so does a page past the
:data:`MAX_PAGE_WORDS` whose words the block's threads hold in registers.

Both codec wrappers take a :class:`PreparedTable`, or build one through
:func:`prepare_table`, which memoises the padded table and the kernels'
meta on the device: the counterpart of the reference's
``kernels/xla.py::prepare_table``.
"""
from __future__ import annotations

import collections
from typing import Any, NamedTuple

import torch

from repro_torch import obs
from repro_torch._device import upload
from repro_torch.core.format import BaseTable, TableLike, as_base_table, class_indices
from repro_torch.core.gbdi_fr import FRConfig, alloc_blob, blob_shapes, fr_encode
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


class PreparedTable(NamedTuple):
    """A table ready for the codec kernels on one device: the padded bases
    and class indices (flat, ``k_padded`` entries) and :func:`kernel_meta`,
    beside the :class:`BaseTable` the plain versions take."""

    table: BaseTable
    bases: torch.Tensor
    cls: torch.Tensor
    meta: torch.Tensor
    cfg: FRConfig
    device: torch.device


#: prepared tables held at most (least recently used first out)
PREP_CAP = 16
_PREP_CACHE: collections.OrderedDict[tuple, tuple[tuple[Any, ...], PreparedTable]] = \
    collections.OrderedDict()


def _identity_key(table: Any) -> tuple[tuple[Any, ...], tuple] | None:
    """(the keyed objects, their key) for a table of tensors, else None.

    A tensor is keyed by its identity together with its version counter, so
    an in-place write (``copy_``, ``add_``, a slice assignment) misses, and
    no device sync is needed a call.  The entry holds the keyed tensors
    alive, so an id cannot be handed to another tensor while it is cached
    (keying on ``id()`` alone would hit on a dead table's successor).  A
    write that bypasses the version counter (through ``.data`` or a numpy
    view of a CPU tensor) is not seen: tables change through torch ops.
    """
    parts = tuple(table) if isinstance(table, BaseTable) else (table,)
    if not all(isinstance(t, torch.Tensor) for t in parts):
        return None
    try:
        key = tuple((id(t), t._version) for t in parts)
    except RuntimeError:          # inference tensors carry no version counter
        return None
    return parts, key


def prepare_table(table: TableLike | PreparedTable, cfg: FRConfig,
                  device: torch.device) -> PreparedTable:
    """The memoised :class:`PreparedTable` of ``table`` under ``cfg`` on
    ``device`` (a prepared table for that config and device is returned as
    it is)."""
    if isinstance(table, PreparedTable):
        if table.cfg == cfg and table.device == device:
            return table
        table = table.table
    ident = _identity_key(table)
    key = None if ident is None else (ident[1], cfg, device)
    if key is not None:
        hit = _PREP_CACHE.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], ident[0])):
            obs.count("table_prep.hit")
            _PREP_CACHE.move_to_end(key)
            return hit[1]
    obs.count("table_prep.miss")
    bt = as_base_table(table, default_width=cfg.widest_bits, device=device)
    bases, cls = (t.reshape(-1).contiguous() for t in pad_table(bt, cfg))
    prep = PreparedTable(bt, bases, cls, kernel_meta(cfg, device), cfg, device)
    if key is not None:
        _PREP_CACHE[key] = (ident[0], prep)
        while len(_PREP_CACHE) > PREP_CAP:
            _PREP_CACHE.popitem(last=False)
    return prep


def table_cache_info() -> dict[str, int]:
    """The memo's hits and misses (counters ``table_prep.hit`` and
    ``table_prep.miss`` of :mod:`repro_torch.obs`) and its size."""
    counters = obs.snapshot(spans=False)["counters"]
    return {"hits": counters["table_prep.hit"], "misses": counters["table_prep.miss"],
            "size": len(_PREP_CACHE)}


def table_cache_clear() -> None:
    _PREP_CACHE.clear()
    obs.reset("table_prep.hit", "table_prep.miss")


def plain_table(table: TableLike | PreparedTable) -> TableLike:
    """What the plain versions take: a prepared table's :class:`BaseTable`."""
    return table.table if isinstance(table, PreparedTable) else table


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
    return upload(caps + offs + cost8, dtype=torch.int32, device=device)


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


def blob_ptrs(blob: dict[str, torch.Tensor], cfg: FRConfig, lead: tuple[int, ...], *,
              counts: bool = False, side: str = "") -> list[int]:
    """Every field of ``blob`` (``lead`` pages; with ``counts``, the encode's
    counts too) checked by :func:`check_cuda_input` against the layout, and
    their pointers in the kernels' order, 0 for the ``profile`` of a
    single-profile config."""
    ptrs = []
    for key, shape in blob_shapes(cfg, counts=counts).items():
        t = blob[key]
        check_cuda_input(t, side + key, lead + shape)
        ptrs.append(t.data_ptr())
    return ptrs if cfg.num_profiles > 1 else ptrs + [0]


def check_prepared(prep: PreparedTable, cfg: FRConfig) -> None:
    """Raise unless a prepared table's tensors are what the kernels read:
    contiguous int32 of ``k_padded(cfg)`` bases and classes and the
    config's meta (``prepare_table`` returns a given :class:`PreparedTable`
    of the right config and device as it is)."""
    k = k_padded(cfg)
    n_meta = cfg.num_profiles * (2 * cfg.num_classes + 1)
    for name, t, n in (("bases", prep.bases, k), ("cls", prep.cls, k), ("meta", prep.meta, n_meta)):
        check_cuda_input(t, f"prepared {name}", (n,))


def gbdi_encode_plain(x_pages: torch.Tensor, table: TableLike | PreparedTable,
                      cfg: FRConfig) -> dict[str, torch.Tensor]:
    """The kernel's plain PyTorch version (on whatever device ``x_pages`` lies)."""
    return fr_encode(x_pages, plain_table(table), cfg)


def gbdi_encode(x_pages: torch.Tensor, table: TableLike | PreparedTable,
                cfg: FRConfig) -> dict[str, torch.Tensor]:
    """Encode (n_pages, page_words) int32 pages: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    dev = x_pages.device
    if dev.type == "cpu":
        return gbdi_encode_plain(x_pages, table, cfg)
    if dev.type != "cuda":
        raise ValueError(f"gbdi_encode runs on cuda (kernel) or cpu (plain), not {dev}")
    with obs.span("encode"):
        return _encode_cuda(x_pages, table, cfg)


def _encode_cuda(x_pages: torch.Tensor, table: TableLike | PreparedTable,
                 cfg: FRConfig) -> dict[str, torch.Tensor]:
    dev = x_pages.device
    n = x_pages.shape[0]
    check_cuda_input(x_pages, "x_pages", (n, cfg.page_words))
    check_smem(cfg)
    prep = prepare_table(table, cfg, dev)
    check_prepared(prep, cfg)
    bases, cls, meta = prep.bases, prep.cls, prep.meta
    blob = alloc_blob(cfg, (n,), dev, counts=True)
    lib = _build.load("gbdi_encode")
    ptrs = _build.ptr_array([
        x_pages.data_ptr(), bases.data_ptr(), cls.data_ptr(), meta.data_ptr(),
        *blob_ptrs(blob, cfg, (n,), counts=True),
    ])
    with torch.cuda.device(dev):
        rc = lib.gbdi_encode_launch(ptrs, _build.int_array(kernel_iparams(cfg, n)),
                                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbdi_encode launch failed (code {rc})")
    if n:
        obs.count("launches.encode")
    return blob


__all__ = [
    "MAX_PAGE_WORDS", "PREP_CAP", "PreparedTable", "SMEM_LIMIT_BYTES", "blob_ptrs",
    "check_prepared", "check_smem", "gbdi_encode", "gbdi_encode_plain", "k_padded",
    "kernel_iparams", "kernel_meta", "pad_table", "plain_table", "prepare_table", "smem_bytes",
    "table_cache_clear", "table_cache_info",
]
