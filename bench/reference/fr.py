"""Frozen plain GBDI-FR v2: config, page encode and decode, and the base-table fit.

A self-contained copy of the format as ``docs/FORMAT.md`` §1–§7 defines it,
written in plain PyTorch on int32 words and batched over a leading page
axis.  It imports nothing of the program, so a later change to the program's
codec cannot move the yardstick it is judged by.  Integer arithmetic that
wraps in the format (int32 add and subtract) is done in int64 and folded back
with :func:`wrap_int32`; packing goes through int64 with explicit masks.

Memory is O(pages x page_words x num_bases): callers pass pages in chunks
(:func:`encode_chunked`, :func:`decode_chunked`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

LANE_WIDTHS = (1, 2, 4, 8, 16)
WORD16_MASK = 0xFFFF
WORD16_HALF = 0x8000
_INT32_MIN = -(1 << 31)
_QUANTILES = (10.0, 25.0, 50.0, 75.0, 90.0)


@dataclasses.dataclass(frozen=True)
class FR:
    """Fixed-rate page geometry (the fields a cell's configuration states)."""

    word_bits: int = 16
    page_words: int = 2048
    num_bases: int = 14
    width_set: tuple[int, ...] = (8,)
    bucket_caps: tuple[int, ...] = (2048,)
    outlier_cap: int = 64
    cap_profiles: tuple[tuple[int, ...], ...] | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "width_set", tuple(int(w) for w in self.width_set))
        if self.cap_profiles is not None:
            profiles = tuple(tuple(int(c) for c in p) for p in self.cap_profiles)
            object.__setattr__(self, "cap_profiles", profiles)
            object.__setattr__(self, "bucket_caps", profiles[0])
        object.__setattr__(self, "bucket_caps", tuple(int(c) for c in self.bucket_caps))
        if self.word_bits not in (16, 32):
            raise ValueError("word_bits must be 16 or 32")
        if len(self.bucket_caps) != len(self.width_set):
            raise ValueError("bucket_caps must pair width_set one-to-one")
        for w, cap in zip(self.width_set, self.bucket_caps):
            if 32 % w or w >= self.word_bits or cap * w % 32 or not 0 <= cap <= self.page_words:
                raise ValueError(f"width {w} with cap {cap} does not fill int32 lanes")
        if self.page_words % 128:
            raise ValueError("page_words must be a multiple of 128")

    @classmethod
    def from_dict(cls, d: dict) -> "FR":
        return cls(word_bits=d["word_bits"], page_words=d["page_words"],
                   num_bases=d["num_bases"], width_set=tuple(d["width_set"]),
                   bucket_caps=tuple(d["bucket_caps"]), outlier_cap=d["outlier_cap"],
                   cap_profiles=(None if d.get("cap_profiles") is None
                                 else tuple(tuple(p) for p in d["cap_profiles"])))

    @property
    def num_classes(self) -> int:
        return len(self.width_set)

    @property
    def profiles(self) -> tuple[tuple[int, ...], ...]:
        return self.cap_profiles if self.cap_profiles is not None else (self.bucket_caps,)

    @property
    def num_profiles(self) -> int:
        return len(self.profiles)

    @property
    def widest_bits(self) -> int:
        return self.width_set[-1]

    @property
    def ptr_bits(self) -> int:
        need = max(1, math.ceil(math.log2(self.num_bases + 2)))
        return next(b for b in LANE_WIDTHS if b >= need)

    @property
    def zero_code(self) -> int:
        return self.num_bases

    @property
    def outlier_code(self) -> int:
        return self.num_bases + 1

    @property
    def ptr_lanes(self) -> int:
        return self.page_words * self.ptr_bits // 32

    def class_lanes_for(self, profile: int) -> tuple[int, ...]:
        return tuple(cap * w // 32 for w, cap in zip(self.width_set, self.profiles[profile]))

    def class_lane_offsets_for(self, profile: int) -> tuple[int, ...]:
        lanes = self.class_lanes_for(profile)
        return tuple(sum(lanes[:i]) for i in range(len(lanes)))

    @property
    def delta_lanes(self) -> int:
        return max(sum(self.class_lanes_for(p)) for p in range(self.num_profiles))

    def serialized_bytes(self, profile: int = 0) -> int:
        """Bytes of one page as the format serialises it (``FORMAT.md`` §5)."""
        header = 1 if self.num_profiles > 1 else 0
        return (header + 4 * (self.ptr_lanes + sum(self.class_lanes_for(profile)))
                + self.outlier_cap * (self.word_bits // 8) + self.outlier_cap * 2 + 4)

    def page_bytes(self) -> int:
        """The worst case over the profiles: every page's slot in a fixed-rate store."""
        return max(self.serialized_bytes(p) for p in range(self.num_profiles))

    @property
    def drop_penalty_bits(self) -> int:
        return 8 * self.page_bytes() + 1


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def wrapped_delta(values: torch.Tensor, bases: torch.Tensor, word_bits: int) -> torch.Tensor:
    d = values.to(torch.int64)[..., None] - bases.to(torch.int64)
    if word_bits == 32:
        return wrap_int32(d)
    span, half = 1 << word_bits, 1 << (word_bits - 1)
    return (((d + half) & (span - 1)) - half).to(torch.int32)


def magnitude(d: torch.Tensor) -> torch.Tensor:
    return torch.maximum(d, torch.bitwise_not(d))


def class_indices(widths: torch.Tensor, width_set: Sequence[int]) -> torch.Tensor:
    idx = torch.full(widths.shape, len(width_set), dtype=torch.int64, device=widths.device)
    for i, w in enumerate(width_set):
        idx = torch.where(widths == w, i, idx)
    return idx


def pack_lanes(x: torch.Tensor, bits: int) -> torch.Tensor:
    per = 32 // bits
    y = (x.to(torch.int64) & ((1 << bits) - 1)).reshape(*x.shape[:-1], -1, per)
    sh = torch.arange(per, dtype=torch.int64, device=x.device) * bits
    return wrap_int32((y << sh).sum(dim=-1))


def unpack_lanes(p: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    per = 32 // bits
    sh = torch.arange(per, dtype=torch.int64, device=p.device) * bits
    fields = ((p.to(torch.int64) & 0xFFFFFFFF)[..., None] >> sh) & ((1 << bits) - 1)
    return fields.reshape(*p.shape[:-1], -1)[..., :n]


def _slots(slot: torch.Tensor, vals: torch.Tensor, cap: int) -> torch.Tensor:
    buf = torch.zeros(slot.shape[0], cap + 1, dtype=vals.dtype, device=vals.device)
    return buf.scatter_(1, slot, vals)[:, :cap]


def _layout(x, d, cost, cls, known, sel, active, out_cand, is_zero, caps, fr: FR) -> dict:
    """The spill chain and compaction of (N, P) pages under one cap profile."""
    N, P = x.shape
    big = fr.word_bits + 1
    subs = []
    n_spilled = torch.zeros(N, dtype=torch.int64, device=x.device)
    for i, (w, cap) in enumerate(zip(fr.width_set, caps)):
        inclass = active & (cls[sel] == i)
        rank = torch.cumsum(inclass.to(torch.int64), dim=1) - 1
        keep = inclass & (rank < cap)
        over = inclass & ~keep
        delta = d.gather(2, sel[..., None])[..., 0]
        payload = torch.where(keep, delta, 0).to(torch.int64) & ((1 << w) - 1)
        subs.append(pack_lanes(_slots(torch.where(keep, rank, cap), payload, cap), w))
        wcost = torch.where((cls > i) & known, cost, big)
        alt = torch.argmin(wcost, dim=2)
        alt_ok = wcost.gather(2, alt[..., None])[..., 0] <= fr.word_bits
        spill = over & alt_ok
        sel = torch.where(spill, alt, sel)
        n_spilled += spill.sum(dim=1)
        newly_out = over & ~alt_ok
        active = active & ~newly_out
        out_cand = out_cand | newly_out
    pos = torch.cumsum(out_cand.to(torch.int64), dim=1) - 1
    in_table = out_cand & (pos < fr.outlier_cap)
    slot = torch.where(in_table, pos, fr.outlier_cap)
    idx = torch.arange(P, dtype=torch.int32, device=x.device).expand(N, P)
    code = torch.where(is_zero, fr.zero_code, sel)
    code = torch.where(out_cand, fr.outlier_code, code)
    deltas = torch.cat(subs, dim=1)
    deltas = torch.nn.functional.pad(deltas, (0, fr.delta_lanes - deltas.shape[1]))
    return {
        "ptrs": pack_lanes(code, fr.ptr_bits),
        "deltas": deltas.to(torch.int32),
        "out_vals": _slots(slot, torch.where(in_table, x, 0), fr.outlier_cap).to(torch.int32),
        "out_idx": _slots(slot, torch.where(in_table, idx, 0), fr.outlier_cap).to(torch.int32),
        "n_out": torch.clamp(out_cand.sum(dim=1), max=fr.outlier_cap).to(torch.int32),
        "n_spilled": n_spilled.to(torch.int32),
        "n_dropped": (out_cand & ~in_table).sum(dim=1).to(torch.int32),
    }


def encode(x: torch.Tensor, bases: torch.Tensor, widths: torch.Tensor, fr: FR) -> dict:
    """(N, page_words) int32 word pages -> the page blobs, field by field."""
    x = x.to(torch.int32)
    wb = fr.word_bits
    cls = class_indices(widths, fr.width_set)
    known = cls < fr.num_classes
    d = wrapped_delta(x, bases, wb)
    halfs = torch.ones_like(widths, dtype=torch.int64) << (widths.long() - 1)
    fits = magnitude(d) < halfs
    cost = torch.where(fits & known, widths, wb + 1)
    sel = torch.argmin(cost, dim=2)
    found = cost.gather(2, sel[..., None])[..., 0] <= wb
    is_zero = x == 0
    active = found & ~is_zero
    out_cand = ~found & ~is_zero
    cands = [_layout(x, d, cost, cls, known, sel, active, out_cand, is_zero, caps, fr)
             for caps in fr.profiles]
    if fr.num_profiles == 1:
        return cands[0]
    costs = torch.stack([
        wrap_int32(fr.drop_penalty_bits * b["n_dropped"].to(torch.int64)
                   + 8 * fr.serialized_bytes(p)) for p, b in enumerate(cands)], dim=1)
    pid = torch.argmin(costs, dim=1)
    rows = torch.arange(x.shape[0], device=x.device)
    blob = {k: torch.stack([b[k] for b in cands], dim=1)[rows, pid] for k in cands[0]}
    blob["profile"] = pid.to(torch.int32)
    return blob


def decode(blob: dict, bases: torch.Tensor, widths: torch.Tensor, fr: FR) -> torch.Tensor:
    """Page blobs (N, ...) -> (N, page_words) int32 words."""
    dev = blob["ptrs"].device
    P, k = fr.page_words, fr.num_bases
    cls = class_indices(widths, fr.width_set)
    code = unpack_lanes(blob["ptrs"], fr.ptr_bits, P)
    active = code < k
    base_code = code.clamp(0, k - 1)
    cls_w = cls[base_code]

    def deltas_for(profile: int) -> torch.Tensor:
        delta = torch.zeros(code.shape, dtype=torch.int64, device=dev)
        for i, (w, cap, off) in enumerate(zip(fr.width_set, fr.profiles[profile],
                                              fr.class_lane_offsets_for(profile))):
            if cap == 0:
                continue
            sub = unpack_lanes(blob["deltas"][:, off:off + cap * w // 32], w, cap)
            sub = torch.where(sub >= (1 << (w - 1)), sub - (1 << w), sub)
            inclass = active & (cls_w == i)
            rank = torch.cumsum(inclass.to(torch.int64), dim=1) - 1
            delta = torch.where(inclass, sub.gather(1, rank.clamp(0, cap - 1)), delta)
        return delta

    if fr.num_profiles == 1:
        delta = deltas_for(0)
    else:
        pid = blob["profile"][:, None]
        delta = torch.zeros(code.shape, dtype=torch.int64, device=dev)
        for p in range(fr.num_profiles):
            delta = torch.where(pid == p, deltas_for(p), delta)
    val = wrap_int32(bases.to(torch.int64)[base_code] + delta).to(torch.int64)
    if fr.word_bits == 16:
        val = val & WORD16_MASK
    val = torch.where((code == fr.zero_code) | (code == fr.outlier_code), 0, val)
    live = torch.arange(fr.outlier_cap, device=dev)[None, :] < blob["n_out"][:, None]
    idx = blob["out_idx"].long()
    hit = live & (idx >= 0) & (idx < P)
    idx = torch.where(hit, idx, P)
    n = code.shape[0]
    contrib = torch.zeros(n, P + 1, dtype=torch.int64, device=dev).scatter_add_(
        1, idx, torch.where(hit, blob["out_vals"].to(torch.int64), 0))[:, :P]
    is_out = torch.zeros(n, P + 1, dtype=torch.bool, device=dev).scatter_(1, idx, hit)[:, :P]
    return wrap_int32(torch.where(is_out, contrib, val))


def encode_chunked(x: torch.Tensor, bases, widths, fr: FR, chunk: int = 1024) -> dict:
    parts = [encode(x[i:i + chunk], bases, widths, fr) for i in range(0, x.shape[0], chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def decode_chunked(blob: dict, bases, widths, fr: FR, chunk: int = 1024) -> torch.Tensor:
    n = blob["ptrs"].shape[0]
    return torch.cat([decode({k: v[i:i + chunk] for k, v in blob.items()}, bases, widths, fr)
                      for i in range(0, n, chunk)])


def bf16_to_words(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & WORD16_MASK


def words_to_bf16(words: torch.Tensor) -> torch.Tensor:
    signed = ((words.to(torch.int32) + WORD16_HALF) & WORD16_MASK) - WORD16_HALF
    return signed.to(torch.int16).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# the base-table fit: the paper's modified k-means over word bit patterns
# ---------------------------------------------------------------------------

def _width_cost(m: torch.Tensor, width_set: Sequence[int], word_bits: int) -> torch.Tensor:
    cost = torch.full(m.shape, word_bits, dtype=torch.int32, device=m.device)
    for w in reversed(list(width_set)):
        cost = torch.where(m < (1 << (w - 1)), w, cost)
    return cost


def _init_bases(sample: torch.Tensor, k: int) -> torch.Tensor:
    s = torch.sort(sample).values
    f32 = dict(dtype=torch.float32, device=sample.device)
    step = torch.arange(k + 1, **f32) / torch.tensor(k + 1, **f32)
    idx = (torch.tensor(s.shape[0] - 1, **f32) * step)[1:].to(torch.int64)
    return wrap_int32(s[idx].to(torch.int64) + torch.arange(k, device=sample.device))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (TwoSum in float64, ties repaired)."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    back = r.double()
    other = torch.nextafter(r, torch.where(s > back, torch.inf, -torch.inf).to(r.dtype))
    tie = (s != back) & ((back + other.double()) * 0.5 == s) & (err != 0)
    return torch.where(tie & ((err > 0) == (other.double() > back)), other, r)


def _nanquantile_cols(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    s = torch.sort(a, dim=0).values
    counts = (~torch.isnan(s)).sum(dim=0).to(torch.float32)
    pos = q[:, None] * (counts[None, :] - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    top = counts[None, :] - 1
    low = torch.clamp(torch.minimum(low, top), min=0).long()
    high = torch.clamp(torch.minimum(high, top), min=0).long()
    return _fma_f32(torch.gather(s, 0, high), high_w, torch.gather(s, 0, low) * (1 - high_w))


def fit_bases(sample: torch.Tensor, *, num_bases: int, width_set: Sequence[int],
              word_bits: int, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster int32 bit patterns (zeros removed) by encoded bit cost; pair
    each base with the width class that minimises its cluster's bits."""
    sample = sample.to(torch.int32)
    dev, k, n = sample.device, num_bases, sample.shape[0]
    ar_k = torch.arange(k, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    q = torch.tensor(_QUANTILES, **f32) / torch.tensor(100.0, **f32)

    def assign(bases):
        d = wrapped_delta(sample, bases, word_bits)
        m = magnitude(d)
        a = torch.argmin(m.to(torch.float32), dim=1)
        return a, d.gather(1, a[:, None])[:, 0], m.gather(1, a[:, None])[:, 0]

    bases = _init_bases(sample, k)
    n_seed = min(k, n)
    for _ in range(iters):
        a, d, m = assign(bases)
        d_upd = d.clamp(-(1 << 15), 1 << 15).to(torch.float32)
        cnt = torch.zeros(k, **f32).index_add_(0, a, torch.ones_like(d_upd))
        mean = torch.zeros(k, **f32).index_add_(0, a, d_upd) / torch.clamp_min(cnt, 1.0)
        mean = torch.where(cnt > 0, mean, torch.zeros_like(mean))
        near = (d.to(torch.int64).abs() < (1 << 24)) | (d == _INT32_MIN)
        dn = torch.where(near, d, torch.zeros_like(d)).to(torch.float32)
        masked = torch.where(a[:, None] == ar_k[None, :], dn[:, None],
                             torch.tensor(float("nan"), device=dev))
        cands = torch.cat([mean[None, :], torch.nan_to_num(_nanquantile_cols(masked, q))], dim=0)
        cands = torch.round(cands).to(torch.int32)
        shifted = wrap_int32(d.to(torch.int64)[:, None] - cands.T[a].to(torch.int64))
        bits = _width_cost(magnitude(shifted), width_set, word_bits).to(torch.float32)
        tot = torch.zeros(k, bits.shape[1], **f32).index_add_(0, a, bits)
        shift = cands.T.gather(1, torch.argmin(tot, dim=1)[:, None])[:, 0].to(torch.float32)
        new = wrap_int32(bases.to(torch.int64) + torch.round(shift).to(torch.int64))
        empty = cnt == 0
        worst = sample[torch.sort(m, descending=True, stable=True).indices[:n_seed]]
        rank = torch.clamp(torch.cumsum(empty.to(torch.int64), 0) - 1, 0, n_seed - 1)
        bases = torch.where(empty, worst[rank], new)
    a, _, m = assign(bases)
    n_tot = torch.bincount(a, minlength=k).to(torch.float32)
    per_width = []
    for w in width_set:
        n_fit = torch.bincount(a, weights=(m < (1 << (w - 1))).to(torch.float32),
                               minlength=k).to(torch.float32)
        per_width.append(n_fit * w + (n_tot - n_fit) * word_bits)
    best = torch.argmin(torch.stack(per_width, dim=0), dim=0)
    widths = torch.tensor(list(width_set), dtype=torch.int32, device=dev)[best]
    return bases.to(torch.int32), widths


def fit_table(words: torch.Tensor, fr: FR, *, iters: int, sample_cap: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The FR table from live words: zeros dropped, the first ``sample_cap``
    kept and tiled up to a power of two, then :func:`fit_bases`."""
    flat = words.reshape(-1).to(torch.int32)
    nz = flat[flat != 0][:sample_cap]
    if nz.numel():
        host = np.resize(nz.cpu().numpy(), 1 << (nz.numel() - 1).bit_length())
        flat = torch.as_tensor(host, dtype=torch.int32, device=flat.device)
    return fit_bases(flat, num_bases=fr.num_bases, width_set=fr.width_set,
                     word_bits=fr.word_bits, iters=iters)
