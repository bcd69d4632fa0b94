"""Shared GBDI format core on tensors: code space, base table, assignment.

PyTorch counterpart of :mod:`repro.core.format`.  The code space (``num_bases``
base pointers plus the zero and outlier codes), the :class:`BaseTable`
(fitted bases paired with per-base delta-width classes) and the per-word
assignment are the same definitions, written as plain functions on int32
tensors batched over any leading axes.

Integer arithmetic that wraps in JAX (int32 subtraction and addition) is done
here in int64 and folded back with :func:`wrap_int32`, so results do not
depend on how a backend treats signed overflow.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence, Union

import torch

from repro_torch._device import upload
from repro_torch.core.kmeans import delta_magnitude, wrap_int32, wrapped_delta

#: field widths that tile an int32 lane exactly (lane-packable)
LANE_WIDTHS = (1, 2, 4, 8, 16)
#: width of the per-page profile id stored when a config ships more than
#: one bucket-cap profile (one byte in the serialized page header)
PROFILE_ID_BITS = 8

#: format defaults shared by the FRConfig presets
DEFAULT_PAGE_WORDS = 2048
DEFAULT_NUM_BASES = 14
DEFAULT_OUTLIER_CAP = 64


def word_mask(bits: int) -> int:
    """All-ones mask of a ``bits``-wide memory word, e.g. 0xFFFF for 16."""
    return (1 << bits) - 1


def half_span(bits: int) -> int:
    """Sign bias of a ``bits``-wide word: ``1 << (bits - 1)``."""
    return 1 << (bits - 1)


#: the bf16/int16 memory-word constants spelled most often
WORD16_MASK = word_mask(16)
WORD16_HALF = half_span(16)


# ---------------------------------------------------------------------------
# code space
# ---------------------------------------------------------------------------

def ptr_bits(num_bases: int, *, lane_packed: bool = False) -> int:
    """Pointer width for ``num_bases`` + 2 reserved codes (see repro)."""
    need = max(1, math.ceil(math.log2(num_bases + 2)))
    if not lane_packed:
        return need
    for b in LANE_WIDTHS:
        if b >= need:
            return b
    raise ValueError(f"num_bases={num_bases} does not fit a lane-packable pointer")


def zero_code(num_bases: int) -> int:
    return num_bases


def outlier_code(num_bases: int) -> int:
    return num_bases + 1


# ---------------------------------------------------------------------------
# base table
# ---------------------------------------------------------------------------

class BaseTable(NamedTuple):
    """Fitted global state: ``bases`` (k,) int32 signed word views and
    ``widths`` (k,) int32, each a member of the owning config's width set."""

    bases: torch.Tensor
    widths: torch.Tensor

    @property
    def num_bases(self) -> int:
        return int(self.bases.shape[0])

    def to(self, device: str | torch.device) -> "BaseTable":
        return BaseTable(self.bases.to(device), self.widths.to(device))


#: a real :class:`BaseTable`, a bare bases tensor, or a (bases, widths) pair
TableLike = Union["BaseTable", torch.Tensor, Sequence[Any]]


def as_base_table(table: TableLike, *, default_width: int,
                  device: str | torch.device | None = None) -> BaseTable:
    """Coerce a bare bases tensor to a :class:`BaseTable` (v1 compat): every
    base is paired with ``default_width``."""
    if isinstance(table, BaseTable):
        return table if device is None else table.to(device)
    if isinstance(table, (tuple, list)) and len(table) == 2:
        return BaseTable(torch.as_tensor(table[0], dtype=torch.int32, device=device),
                         torch.as_tensor(table[1], dtype=torch.int32, device=device))
    bases = torch.as_tensor(table, dtype=torch.int32, device=device)
    return BaseTable(bases, torch.full_like(bases, default_width))


def class_indices(widths: torch.Tensor, width_set: Sequence[int]) -> torch.Tensor:
    """Map per-base widths to indices into ``width_set`` (narrow -> wide);
    a width outside the set maps to the dead-entry sentinel ``len(width_set)``."""
    idx = torch.full(widths.shape, len(width_set), dtype=torch.int32,
                     device=widths.device)
    for i, w in enumerate(width_set):
        idx = torch.where(widths == w, upload(i, dtype=torch.int32, device=widths.device), idx)
    return idx


# ---------------------------------------------------------------------------
# assignment
# ---------------------------------------------------------------------------

def validate_cap_profiles(
    profiles: Sequence[Sequence[int]],
    width_set: Sequence[int],
    page_words: int,
) -> tuple[tuple[int, ...], ...]:
    """Validate a bucket-cap profile table against a width set; returns the
    normalized tuple-of-tuples (same rules and messages as repro)."""
    norm = tuple(tuple(int(c) for c in p) for p in profiles)
    if not norm:
        raise ValueError("cap_profiles must hold at least one profile")
    if len(norm) > (1 << PROFILE_ID_BITS):
        raise ValueError(f"at most {1 << PROFILE_ID_BITS} cap profiles "
                         f"(ids are {PROFILE_ID_BITS}-bit), got {len(norm)}")
    for p, caps in enumerate(norm):
        if len(caps) != len(width_set):
            raise ValueError(f"profile {p} must pair width_set one-to-one")
        for w, cap in zip(width_set, caps):
            if not 0 <= cap <= page_words:
                raise ValueError(f"profile {p}: cap {cap} outside [0, {page_words}]")
            if cap * w % 32:
                raise ValueError(f"profile {p}: cap {cap} x width {w} "
                                 "must fill int32 lanes")
    return norm


def class_demand(code: torch.Tensor, cls: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(..., num_classes) int32 count of non-zero, non-outlier words whose
    base sits in each width class, for codes of shape (..., P)."""
    k = cls.shape[0]
    active = code < k
    word_cls = cls[code.clamp(0, k - 1).long()]
    return torch.stack([
        (active & (word_cls == i)).sum(dim=-1, dtype=torch.int32)
        for i in range(num_classes)
    ], dim=-1)


def delta_fit(
    values: torch.Tensor, table: BaseTable, *, word_bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n, k) wrapping deltas and the per-base fit mask ``|d| < 2**(w-1)``."""
    d = wrapped_delta(values, table.bases, word_bits)
    m = delta_magnitude(d)
    halfs = torch.ones_like(table.widths, dtype=torch.int64) << (table.widths.long() - 1)
    return d, m < halfs


def assign(values: torch.Tensor, bases: torch.Tensor, base_widths: torch.Tensor,
           *, word_bits: int) -> dict[str, torch.Tensor]:
    """Per-word GBDI assignment (code, delta, payload width), narrowest
    fitting base first, ties to the lowest base index."""
    k = bases.shape[0]
    d, fits = delta_fit(values, BaseTable(bases, base_widths), word_bits=word_bits)
    cost = torch.where(fits, base_widths, word_bits + 1)
    best = torch.argmin(cost, dim=-1, keepdim=True)
    best_cost = cost.gather(-1, best)[..., 0]
    best_delta = d.gather(-1, best)[..., 0]
    is_outlier = best_cost > word_bits
    is_zero = values == 0
    code = torch.where(is_outlier, k + 1, best[..., 0]).to(torch.int32)
    code = torch.where(is_zero, k, code).to(torch.int32)
    payload_width = torch.where(is_outlier, word_bits, best_cost)
    payload_width = torch.where(is_zero, 0, payload_width).to(torch.int32)
    delta = torch.where(is_outlier | is_zero, 0, best_delta).to(torch.int32)
    return {"code": code, "delta": delta, "payload_width": payload_width}


__all__ = [
    "DEFAULT_NUM_BASES",
    "DEFAULT_OUTLIER_CAP",
    "DEFAULT_PAGE_WORDS",
    "LANE_WIDTHS",
    "PROFILE_ID_BITS",
    "WORD16_HALF",
    "WORD16_MASK",
    "BaseTable",
    "TableLike",
    "as_base_table",
    "assign",
    "class_demand",
    "class_indices",
    "delta_fit",
    "half_span",
    "outlier_code",
    "ptr_bits",
    "validate_cap_profiles",
    "word_mask",
    "wrap_int32",
    "zero_code",
]
