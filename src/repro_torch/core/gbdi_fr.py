"""GBDI-FR v2 fixed-rate page format on tensors: config, packing, plain codec.

PyTorch counterpart of :mod:`repro.core.gbdi_fr`.  :class:`FRConfig` is a
plain copy of the reference dataclass with every derived property, and
:func:`fr_encode` / :func:`fr_decode` are the plain (oracle) codec written
natively batched over a leading page axis.  They are the plain versions the
CUDA kernels in :mod:`repro_torch.kernels` are held against bit for bit, and
they produce blobs bit-identical to the JAX oracle for the same table.

Page layout, spill rules and the adaptive profile probe are those of
``docs/FORMAT.md``; see the reference module docstring for the prose.

Packing goes through int64 with explicit masks: torch's ``>>`` on int32 is
arithmetic and its uint32 support is thin, so a field that sets bit 31 of a
lane must never pass through a signed shift.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core.format import BaseTable, as_base_table, wrap_int32


@dataclasses.dataclass(frozen=True)
class FRConfig:
    """Fixed-rate page geometry; defaults target bf16 tensors."""
    word_bits: int = 16            # 16 for bf16 views, 32 for fp32/int32 views
    page_words: int = 2048
    num_bases: int = 14            # +zero+outlier -> 16 codes -> 4-bit pointers
    width_set: tuple[int, ...] = (4, 8)   # lane-packable, ascending, < word_bits
    bucket_caps: tuple[int, ...] = (192, 1856)  # per-page words per width class
    outlier_cap: int = 64          # full-width slots per page (3.1% of 2048)
    #: adaptive per-page bucket-cap profiles (``None``: the single profile
    #: ``(bucket_caps,)``); when set, ``bucket_caps`` is ``cap_profiles[0]``
    cap_profiles: tuple[tuple[int, ...], ...] | None = None
    # v1 compat: FRConfig(delta_bits=w) == single-width v2 with one
    # full-page bucket (width_set=(w,), bucket_caps=(page_words,)).
    delta_bits: dataclasses.InitVar[int | None] = None

    def __post_init__(self, delta_bits: int | None) -> None:
        if delta_bits is not None:
            object.__setattr__(self, "width_set", (int(delta_bits),))
            object.__setattr__(self, "bucket_caps", (self.page_words,))
        ws = self.width_set
        if self.word_bits not in (16, 32):
            raise ValueError("word_bits must be 16 or 32")
        if not ws or list(ws) != sorted(set(ws)):
            raise ValueError("width_set must be non-empty, ascending, unique")
        for w in ws:
            if 32 % w or w >= self.word_bits:
                raise ValueError("each width must divide 32 and be < word_bits")
        if self.cap_profiles is not None:
            norm = fmt.validate_cap_profiles(self.cap_profiles, ws, self.page_words)
            object.__setattr__(self, "cap_profiles", norm)
            object.__setattr__(self, "bucket_caps", norm[0])
        caps = self.bucket_caps
        if len(caps) != len(ws):
            raise ValueError("bucket_caps must pair width_set one-to-one")
        for w, cap in zip(ws, caps):
            if not 0 <= cap <= self.page_words:
                raise ValueError("bucket_caps must be in [0, page_words]")
            if cap * w % 32:
                raise ValueError(f"bucket cap {cap} x width {w} must fill int32 lanes")
        if self.page_words % 128:
            raise ValueError("page_words must be lane-aligned (multiple of 128)")
        if self.num_bases + 2 > (1 << 16):
            raise ValueError("num_bases does not fit a lane-packable pointer")
        # the probe cost is int32 in the format; bound it statically so a
        # wrap cannot invert the exactness-first profile order
        if (self.num_profiles > 1
                and self.drop_penalty_bits * self.page_words > (1 << 31) - 1):
            raise ValueError(
                "cap_profiles probe cost would overflow int32 "
                f"(drop_penalty_bits={self.drop_penalty_bits} x "
                f"page_words={self.page_words}); shrink the page or the "
                "delta payload")

    @property
    def num_classes(self) -> int:
        return len(self.width_set)

    # -- adaptive bucket-cap profiles ---------------------------------------

    @property
    def profiles(self) -> tuple[tuple[int, ...], ...]:
        """The bucket-cap profile table (``(bucket_caps,)`` if static)."""
        return self.cap_profiles if self.cap_profiles is not None else (self.bucket_caps,)

    @property
    def num_profiles(self) -> int:
        return len(self.profiles)

    def class_lanes_for(self, profile: int) -> tuple[int, ...]:
        return tuple(cap * w // 32
                     for w, cap in zip(self.width_set, self.profiles[profile]))

    def class_lane_offsets_for(self, profile: int) -> tuple[int, ...]:
        offs, off = [], 0
        for lanes in self.class_lanes_for(profile):
            offs.append(off)
            off += lanes
        return tuple(offs)

    def delta_lanes_for(self, profile: int) -> int:
        return sum(self.class_lanes_for(profile))

    def compressed_bytes_for_profile(self, profile: int) -> int:
        """Exact serialized bytes of a page encoded under ``profile``."""
        out_val_bytes = self.outlier_cap * (self.word_bits // 8)
        out_idx_bytes = self.outlier_cap * 2
        header = 1 if self.num_profiles > 1 else 0
        return (header + 4 * (self.ptr_lanes + self.delta_lanes_for(profile))
                + out_val_bytes + out_idx_bytes + 4)

    @property
    def drop_penalty_bits(self) -> int:
        """Probe cost per dropped word: one unit larger than any possible
        serialized-size difference (lexicographic exactness-first order)."""
        return 8 * self.compressed_bytes_per_page() + 1

    def profile_cost_bits(self, profile: int, n_dropped: torch.Tensor) -> torch.Tensor:
        """The probe's int32 cost of a page under ``profile`` (wraps like the
        format's int32 arithmetic)."""
        return wrap_int32(self.drop_penalty_bits * n_dropped.to(torch.int64)
                          + 8 * self.compressed_bytes_for_profile(profile))

    @property
    def widest_bits(self) -> int:
        return self.width_set[-1]

    @property
    def ptr_bits(self) -> int:
        return fmt.ptr_bits(self.num_bases, lane_packed=True)

    @property
    def zero_code(self) -> int:
        return fmt.zero_code(self.num_bases)

    @property
    def outlier_code(self) -> int:
        return fmt.outlier_code(self.num_bases)

    @property
    def ptr_lanes(self) -> int:
        return self.page_words * self.ptr_bits // 32

    @property
    def class_lanes(self) -> tuple[int, ...]:
        return tuple(cap * w // 32 for w, cap in zip(self.width_set, self.bucket_caps))

    @property
    def class_lane_offsets(self) -> tuple[int, ...]:
        offs, off = [], 0
        for lanes in self.class_lanes:
            offs.append(off)
            off += lanes
        return tuple(offs)

    @property
    def delta_lanes(self) -> int:
        """Static delta-buffer lanes: the max over the profile table."""
        return max(self.delta_lanes_for(p) for p in range(self.num_profiles))

    def compressed_bytes_per_page(self) -> int:
        """Static worst-case page bytes (the device-buffer bound)."""
        return max(self.compressed_bytes_for_profile(p)
                   for p in range(self.num_profiles))

    def ratio(self) -> float:
        return (self.page_words * self.word_bits / 8) / self.compressed_bytes_per_page()

    def bits_per_word(self) -> float:
        return self.compressed_bytes_per_page() * 8 / self.page_words


# ---------------------------------------------------------------------------
# the blob layout: every module that allocates, checks, reshapes or hands a
# kernel a blob's fields takes them from here
# ---------------------------------------------------------------------------

#: a blob's int32 fields in the order the kernels take their pointers, each
#: with the FRConfig property that sizes its one trailing axis (None: one
#: int32 a page); ``profile`` exists only where ``cfg.num_profiles > 1``
BLOB_LAYOUT = (("ptrs", "ptr_lanes"), ("deltas", "delta_lanes"),
               ("out_vals", "outlier_cap"), ("out_idx", "outlier_cap"), ("n_out", None),
               ("n_spilled", None), ("n_dropped", None), ("profile", None))
#: the encode's per-page counts, which a stored page does not keep
COUNT_FIELDS = ("n_spilled", "n_dropped")
#: the fields a stored page keeps
PAGE_FIELDS = tuple(k for k, _ in BLOB_LAYOUT if k not in COUNT_FIELDS)
_TRAILING_DIMS = {k: 0 if size is None else 1 for k, size in BLOB_LAYOUT}


def blob_shapes(cfg: FRConfig, *, counts: bool = False) -> dict[str, tuple[int, ...]]:
    """Each field of a page's blob -> its trailing shape under ``cfg``, in
    kernel order; with ``counts``, the encode's counts too (what
    :func:`fr_encode` returns)."""
    return dict(_blob_shapes(cfg, counts))


@functools.lru_cache(maxsize=64)
def _blob_shapes(cfg: FRConfig, counts: bool) -> tuple[tuple[str, tuple[int, ...]], ...]:
    return tuple((k, () if size is None else (getattr(cfg, size),)) for k, size in BLOB_LAYOUT
                 if (counts or k not in COUNT_FIELDS) and (k != "profile" or cfg.num_profiles > 1))


def alloc_blob(cfg: FRConfig, lead: tuple[int, ...], device: torch.device | str, *,
               counts: bool = False, zeros: bool = False) -> dict[str, torch.Tensor]:
    """A blob of ``lead`` pages (any leading dims), int32, uninitialised or
    zeroed."""
    new = torch.zeros if zeros else torch.empty
    return {k: new(tuple(lead) + shape, dtype=torch.int32, device=device)
            for k, shape in blob_shapes(cfg, counts=counts).items()}


def flat_blob(blob: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The blob's fields with their leading dims flattened to one page axis,
    contiguous; keys outside the layout are dropped."""
    out = {}
    for k, v in blob.items():
        if k in _TRAILING_DIMS:
            split = v.dim() - _TRAILING_DIMS[k]
            out[k] = v.reshape((math.prod(v.shape[:split]),) + v.shape[split:]).contiguous()
    return out


def lead_blob(blob: dict[str, torch.Tensor], lead: tuple[int, ...],
              fields: tuple[str, ...] = tuple(_TRAILING_DIMS)) -> dict[str, torch.Tensor]:
    """A flat blob's ``fields`` with the page axis reshaped to ``lead`` (one
    ``-1`` allowed): the inverse of :func:`flat_blob`."""
    return {k: v.reshape(tuple(lead) + v.shape[1:]) for k, v in blob.items() if k in fields}


def page_layout(cfg: FRConfig, row_words: int) -> tuple[int, int]:
    """``(pt, ppr)`` for token rows of ``row_words`` words laid in page slots:
    a page of whole rows holds ``pt = page_words // row_words`` consecutive
    tokens (``ppr`` 1); a row of whole pages fills ``ppr = row_words //
    page_words`` slots a token (``pt`` 1), slot ``t * ppr + j`` holding the
    row's ``j``-th page of words.  Raises unless one divides the other."""
    P = cfg.page_words
    if row_words > 0 and P % row_words == 0:
        return P // row_words, 1
    if row_words > 0 and row_words % P == 0:
        return 1, row_words // P
    raise ValueError(f"a {P}-word page and a {row_words}-word row must divide one another "
                     f"(a whole number of rows a page, or of pages a row)")


# ---------------------------------------------------------------------------
# lane packing (32 % bits == 0)
# ---------------------------------------------------------------------------

def pack_lanes(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack (..., n) unsigned fields < 2**bits into (..., n*bits/32) int32."""
    per = 32 // bits
    y = (x.to(torch.int64) & ((1 << bits) - 1)).reshape(*x.shape[:-1], -1, per)
    sh = torch.arange(per, dtype=torch.int64, device=x.device) * bits
    return wrap_int32((y << sh).sum(dim=-1))


def unpack_lanes(p: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of pack_lanes -> (..., n) int32 fields in [0, 2**bits)."""
    per = 32 // bits
    sh = torch.arange(per, dtype=torch.int64, device=p.device) * bits
    lanes = p.to(torch.int64) & 0xFFFFFFFF
    fields = (lanes[..., None] >> sh) & ((1 << bits) - 1)
    return fields.reshape(*p.shape[:-1], -1)[..., :n].to(torch.int32)


def _scatter_slots(slot: torch.Tensor, vals: torch.Tensor, cap: int) -> torch.Tensor:
    """(N, cap) buffer with ``vals`` written at ``slot`` per row; ``slot ==
    cap`` is a scratch column that is dropped."""
    buf = torch.zeros(slot.shape[0], cap + 1, dtype=vals.dtype, device=vals.device)
    return buf.scatter_(1, slot, vals)[:, :cap]


# ---------------------------------------------------------------------------
# batched encode/decode (the plain versions of the CUDA kernels)
# ---------------------------------------------------------------------------

def _bucket_pages(
    x: torch.Tensor, d: torch.Tensor, cost: torch.Tensor, cls: torch.Tensor,
    known: torch.Tensor, sel: torch.Tensor, active: torch.Tensor,
    out_cand: torch.Tensor, is_zero: torch.Tensor,
    caps: tuple[int, ...], cfg: FRConfig,
) -> dict[str, torch.Tensor]:
    """Spill chain + compaction of (N, P) pages under one bucket-cap profile."""
    N, P = x.shape
    cap_out, wb = cfg.outlier_cap, cfg.word_bits
    BIG = wb + 1
    dev = x.device
    i32 = torch.int32

    subs = []
    n_spilled = torch.zeros(N, dtype=torch.int64, device=dev)
    for i, (w, cap) in enumerate(zip(cfg.width_set, caps)):
        inclass = active & (cls[sel] == i)
        rank = torch.cumsum(inclass.to(torch.int64), dim=1) - 1
        keep = inclass & (rank < cap)
        over = inclass & ~keep
        delta = d.gather(2, sel[..., None])[..., 0]
        payload = torch.where(keep, delta, 0).to(torch.int64) & ((1 << w) - 1)
        slot = torch.where(keep, rank, cap)
        subs.append(pack_lanes(_scatter_slots(slot, payload, cap), w))
        wcost = torch.where((cls > i) & known, cost, BIG)
        alt = torch.argmin(wcost, dim=2)
        alt_ok = wcost.gather(2, alt[..., None])[..., 0] <= wb
        spill = over & alt_ok
        sel = torch.where(spill, alt, sel)
        n_spilled += spill.sum(dim=1)
        newly_out = over & ~alt_ok
        active = active & ~newly_out
        out_cand = out_cand | newly_out

    # outlier compaction: page-order slots; overflow keeps the outlier code
    # with no slot (decodes to 0) and is counted as dropped
    pos = torch.cumsum(out_cand.to(torch.int64), dim=1) - 1
    in_table = out_cand & (pos < cap_out)
    dropped = out_cand & ~in_table
    slot = torch.where(in_table, pos, cap_out)
    out_vals = _scatter_slots(slot, torch.where(in_table, x, 0), cap_out)
    idx = torch.arange(P, dtype=i32, device=dev).expand(N, P)
    out_idx = _scatter_slots(slot, torch.where(in_table, idx, 0), cap_out)

    code = torch.where(is_zero, cfg.zero_code, sel)
    code = torch.where(out_cand, cfg.outlier_code, code)
    deltas = torch.cat(subs, dim=1)
    deltas = torch.nn.functional.pad(deltas, (0, cfg.delta_lanes - deltas.shape[1]))
    return {
        "ptrs": pack_lanes(code, cfg.ptr_bits),
        "deltas": deltas.to(i32),
        "out_vals": out_vals.to(i32),
        "out_idx": out_idx.to(i32),
        "n_out": torch.clamp(out_cand.sum(dim=1), max=cap_out).to(i32),
        "n_spilled": n_spilled.to(i32),
        "n_dropped": dropped.sum(dim=1).to(i32),
    }


def fr_encode(x: torch.Tensor, table: fmt.TableLike, cfg: FRConfig) -> dict[str, torch.Tensor]:
    """Encode (n_pages, page_words) int32 word pages.  The plain oracle:
    runs on whatever device ``x`` lies on; memory is O(n_pages * page_words *
    num_bases), so large streams go through in chunks."""
    bt = as_base_table(table, default_width=cfg.widest_bits, device=x.device)
    x = x.to(torch.int32)
    wb = cfg.word_bits
    cls = fmt.class_indices(bt.widths, cfg.width_set).long()            # (k,)
    # bases with a width outside the config's width set are dead entries
    known = cls < cfg.num_classes
    d, fits = fmt.delta_fit(x, bt, word_bits=wb)                        # (N, P, k)
    cost = torch.where(fits & known, bt.widths, wb + 1)
    sel = torch.argmin(cost, dim=2)
    found = cost.gather(2, sel[..., None])[..., 0] <= wb
    is_zero = x == 0
    active = found & ~is_zero
    out_cand = ~found & ~is_zero

    cands = [
        _bucket_pages(x, d, cost, cls, known, sel, active, out_cand, is_zero,
                      caps, cfg)
        for caps in cfg.profiles
    ]
    if cfg.num_profiles == 1:
        return cands[0]
    # demand probe: the lexicographically cheapest (n_dropped, bytes, id)
    costs = torch.stack([cfg.profile_cost_bits(p, b["n_dropped"])
                         for p, b in enumerate(cands)], dim=1)         # (N, n_prof)
    pid = torch.argmin(costs, dim=1)
    rows = torch.arange(x.shape[0], device=x.device)
    blob = {k: torch.stack([b[k] for b in cands], dim=1)[rows, pid] for k in cands[0]}
    blob["profile"] = pid.to(torch.int32)
    return blob


def fr_decode(blob: dict[str, torch.Tensor], table: fmt.TableLike, cfg: FRConfig) -> torch.Tensor:
    """Decode a blob of (n_pages, ...) fields back to (n_pages, page_words) int32."""
    dev = blob["ptrs"].device
    bt = as_base_table(table, default_width=cfg.widest_bits, device=dev)
    P, wb, k = cfg.page_words, cfg.word_bits, cfg.num_bases
    cls = fmt.class_indices(bt.widths, cfg.width_set)
    code = unpack_lanes(blob["ptrs"], cfg.ptr_bits, P)
    active = code < k
    base_code = code.clamp(0, k - 1).long()
    cls_w = cls[base_code]
    deltas = blob["deltas"]

    def gather_deltas(profile: int) -> torch.Tensor:
        delta = torch.zeros(code.shape, dtype=torch.int32, device=dev)
        for i, (w, cap, off) in enumerate(
            zip(cfg.width_set, cfg.profiles[profile],
                cfg.class_lane_offsets_for(profile))
        ):
            if cap == 0:
                continue
            sub = unpack_lanes(deltas[:, off:off + cap * w // 32], w, cap)
            sub = torch.where(sub >= (1 << (w - 1)), sub - (1 << w), sub)
            inclass = active & (cls_w == i)
            rank = torch.cumsum(inclass.to(torch.int64), dim=1) - 1
            got = sub.gather(1, rank.clamp(0, cap - 1))
            delta = torch.where(inclass, got, delta)
        return delta

    if cfg.num_profiles == 1:
        delta = gather_deltas(0)
    else:   # the page header says which profile laid out the sub-streams
        pid = blob["profile"][:, None]
        delta = torch.zeros(code.shape, dtype=torch.int32, device=dev)
        for p in range(cfg.num_profiles):
            delta = torch.where(pid == p, gather_deltas(p), delta)

    val = wrap_int32(bt.bases.to(torch.int64)[base_code] + delta)
    if wb == 16:
        val = val & fmt.WORD16_MASK
    val = torch.where(code == cfg.zero_code, 0, val)
    val = torch.where(code == cfg.outlier_code, 0, val)
    # outlier scatter-back: live slots (< n_out) whose index lies in the page
    # add their value at that index and mark it as an outlier position
    n = code.shape[0]
    live = torch.arange(cfg.outlier_cap, device=dev)[None, :] < blob["n_out"][:, None]
    idx = blob["out_idx"].long()
    hit = live & (idx >= 0) & (idx < P)
    idx = torch.where(hit, idx, P)
    contrib = torch.zeros(n, P + 1, dtype=torch.int64, device=dev).scatter_add_(
        1, idx, torch.where(hit, blob["out_vals"].to(torch.int64), 0))[:, :P]
    is_out = torch.zeros(n, P + 1, dtype=torch.bool, device=dev).scatter_(
        1, idx, hit)[:, :P]
    return torch.where(is_out, wrap_int32(contrib), val).to(torch.int32)


# ---------------------------------------------------------------------------
# tensor-level wrappers (floats by bit pattern, like the paper's memory words)
# ---------------------------------------------------------------------------

def bf16_to_words(x: torch.Tensor) -> torch.Tensor:
    """bf16 values (or anything cast to bf16) -> their bit patterns as int32
    words in [0, 65535]."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & fmt.WORD16_MASK


def words_to_bf16(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> the bf16 values whose bit patterns their low 16 bits hold."""
    signed16 = ((words + fmt.WORD16_HALF) & fmt.WORD16_MASK) - fmt.WORD16_HALF
    return signed16.to(torch.int16).view(torch.bfloat16)


def tensor_to_pages(x: torch.Tensor, cfg: FRConfig) -> tuple[torch.Tensor, dict[str, Any]]:
    """Bitcast any tensor to (n_pages, page_words) int32 word pages."""
    flat = x.reshape(-1)
    if x.dtype == torch.float32:
        words = flat.view(torch.int32)
    elif x.dtype == torch.bfloat16:
        words = bf16_to_words(flat)
    elif x.dtype == torch.int32:
        words = flat
    elif x.dtype == torch.uint32:
        words = flat.view(torch.int32)
    else:
        raise ValueError(f"unsupported dtype {x.dtype}")
    expect = 16 if x.dtype == torch.bfloat16 else 32
    if expect != cfg.word_bits:
        raise ValueError(f"dtype {x.dtype} needs word_bits={expect}")
    pad = (-words.shape[0]) % cfg.page_words
    words = torch.nn.functional.pad(words, (0, pad))
    meta = {"shape": tuple(x.shape), "dtype": x.dtype, "n": flat.shape[0]}
    return words.reshape(-1, cfg.page_words), meta


def pages_to_tensor(words: torch.Tensor, meta: dict[str, Any], cfg: FRConfig) -> torch.Tensor:
    flat = words.reshape(-1)[: meta["n"]].to(torch.int32)
    if meta["dtype"] == torch.float32:
        out = flat.view(torch.float32)
    elif meta["dtype"] == torch.bfloat16:
        out = words_to_bf16(flat)
    elif meta["dtype"] == torch.uint32:
        out = flat.view(torch.uint32)
    else:
        out = flat.to(meta["dtype"])
    return out.reshape(meta["shape"])


def fit_fr_bases(
    sample_words: torch.Tensor, cfg: FRConfig, iters: int = 8,
    sample_cap: int = 1 << 16,
) -> BaseTable:
    """Fit the FR base table from live tensor words, on their device.

    Zero words are dropped (they are free via the zero code), the sample is
    capped at ``sample_cap`` and tiled up to a power of two with
    ``np.resize``, exactly as the reference shapes it.
    """
    from repro_torch.core.kmeans import fit_bases

    flat = sample_words.reshape(-1).to(torch.int32)
    nz = flat[flat != 0][:sample_cap]
    if nz.numel():
        host = np.resize(nz.cpu().numpy(), 1 << (nz.numel() - 1).bit_length())
        flat = torch.as_tensor(host, dtype=torch.int32, device=flat.device)
    bases, widths = fit_bases(
        flat, num_bases=cfg.num_bases, width_set=cfg.width_set,
        word_bits=cfg.word_bits, iters=iters, modified=True,
    )
    return BaseTable(bases, widths)
