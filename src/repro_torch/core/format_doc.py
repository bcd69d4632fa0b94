"""Generator for the ``docs/FORMAT.md`` worked example.

PyTorch counterpart of :mod:`repro.core.format_doc`.  ``python -m
repro_torch.core.format_doc`` prints the worked-example block that stands
in ``docs/FORMAT.md`` between the BEGIN/END markers, from a live
:func:`repro_torch.core.gbdi_fr.fr_encode` of the same page, byte for byte
what the reference prints.  The encode runs on the host: the page is one
128-word frame, and the block is text.

:func:`serialize_page` is the normative byte layout of one encoded page
(the blob dict's arrays laid end-to-end); it accepts numpy arrays or
tensors on any device, so a port blob can be serialized (and checked
against golden CRCs) without JAX.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import numpy.typing as npt
import torch

from repro_torch.core.format import BaseTable
from repro_torch.core.gbdi_fr import FRConfig, fr_encode, unpack_lanes


def example_config() -> FRConfig:
    """Doc-sized config: smallest legal page (128 words), two bases, both
    width classes, tiny buckets so the spill chain and a drop both fire.

    Two bucket-cap profiles so the adaptive header byte shows up: the
    worked page keeps the wide-heavy profile 0 (profile 1 would drop 11
    words - exactness wins), while an all-zero page serializes one lane
    smaller under narrow-heavy profile 1 (both drop nothing, size wins).
    """
    return FRConfig(word_bits=16, page_words=128, num_bases=2,
                    width_set=(4, 8), cap_profiles=((8, 24), (32, 8)),
                    outlier_cap=4)


def example_table() -> BaseTable:
    return BaseTable(torch.tensor([1000, 1040], dtype=torch.int32),
                     torch.tensor([4, 8], dtype=torch.int32))


def example_page() -> npt.NDArray[np.int32]:
    """128 int32 word patterns; only the first 64 are live (a '64-word'
    worked page inside the smallest legal 128-word frame).

    Constructed to fire every format rule: 10 class-0 words against an
    8-slot bucket (2 spill), class-1 words, zeros, and 5 outliers against
    a 4-slot table (1 drop).
    """
    x = np.zeros(128, np.int32)
    x[0:10] = 1000 + np.array([0, 1, -1, 2, -2, 3, -3, 4, -4, 5])
    x[10:20] = 1040 + np.array([10, -20, 30, -40, 50, -60, 70, -80, 90, -100])
    x[20:25] = [0x7ABC, 0x7DEF, 0x6123, 0x5456, 0x4789]   # 5 outliers, cap 4
    x[32:40] = 1040 + np.array([99, 98, 97, 96, -99, -98, -97, -96])
    x[48] = 1000 + 7
    x[49] = 1040 - 128
    return x


def _encode_page(x: npt.NDArray[np.int32], cfg: FRConfig) -> dict[str, npt.NDArray[Any]]:
    """One page's blob, as numpy arrays without the page axis."""
    blob = fr_encode(torch.from_numpy(x[None, :].astype(np.int32)), example_table(), cfg)
    return {k: v.numpy()[0] for k, v in blob.items()}


def encode_example() -> tuple[FRConfig, dict[str, npt.NDArray[Any]]]:
    cfg = example_config()
    return cfg, _encode_page(example_page(), cfg)


def _np(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def serialize_page(blob: dict[str, Any], cfg: FRConfig) -> bytes:
    """``profile`` as one uint8 (only when the config ships >1 cap profile)
    | ``ptrs`` int32 lanes | the selected profile's ``delta_lanes_for``
    lanes of ``deltas`` | ``out_vals`` at word_bits each | ``out_idx`` as
    uint16 | ``n_out`` as uint32 — all little-endian; exactly
    ``cfg.compressed_bytes_for_profile(profile)`` bytes."""
    val_dt = "<u2" if cfg.word_bits == 16 else "<u4"
    mask = (1 << cfg.word_bits) - 1
    profile = int(_np(blob["profile"])) if cfg.num_profiles > 1 else 0
    header = bytes([profile]) if cfg.num_profiles > 1 else b""
    deltas = _np(blob["deltas"]).astype(np.int32)[: cfg.delta_lanes_for(profile)]
    out = header + b"".join([
        _np(blob["ptrs"]).astype(np.int32).astype("<i4").tobytes(),
        deltas.astype("<i4").tobytes(),
        (_np(blob["out_vals"]).astype(np.int64) & mask).astype(val_dt).tobytes(),
        _np(blob["out_idx"]).astype(np.uint16).astype("<u2").tobytes(),
        _np(blob["n_out"]).astype(np.uint32).astype("<u4").tobytes(),
    ])
    if len(out) != cfg.compressed_bytes_for_profile(profile):
        raise ValueError(f"serialized {len(out)} bytes, expected "
                         f"{cfg.compressed_bytes_for_profile(profile)}")
    return out


def _rows(arr: Any, per: int, fmt: Callable[[Any], str]) -> list[str]:
    arr = np.asarray(arr).reshape(-1)
    return [
        f"  [{i:>3}..{min(i + per, arr.size) - 1:>3}] "
        + " ".join(fmt(v) for v in arr[i:i + per])
        for i in range(0, arr.size, per)
    ]


def worked_example() -> str:
    cfg, blob = encode_example()
    x = example_page()
    pid = int(np.asarray(blob["profile"])) if cfg.num_profiles > 1 else 0
    lanes = cfg.delta_lanes_for(pid)
    offs = cfg.class_lane_offsets_for(pid)
    zero_blob = _encode_page(np.zeros(cfg.page_words, np.int32), cfg)
    zero_pid = int(zero_blob["profile"])
    lines = [
        "config : word_bits=16 page_words=128 num_bases=2 width_set=(4, 8)",
        "         cap_profiles=((8, 24), (32, 8)) outlier_cap=4",
        f"derived: ptr_bits={cfg.ptr_bits} ptr_lanes={cfg.ptr_lanes} "
        f"delta_lanes(buffer)={cfg.delta_lanes}",
        "         per profile: "
        + "  ".join(
            f"p{p}: class_lanes={cfg.class_lanes_for(p)} "
            f"bytes={cfg.compressed_bytes_for_profile(p)}"
            for p in range(cfg.num_profiles)),
        "table  : bases=[1000, 1040] widths=[4, 8]  "
        "(codes: 0, 1; zero=2, outlier=3)",
        "",
        "input words (int32 view of 16-bit patterns; [64..127] all zero):",
        *_rows(x[:64], 16, lambda v: f"{int(v):>6}"),
        "",
        "per-word codes (unpacked from ptrs; 2 bits each):",
        *_rows(np.asarray(_unpacked_codes(blob, cfg))[:64], 32,
               lambda v: str(int(v))),
        f"counters: profile={pid} n_out={int(blob['n_out'])} "
        f"n_spilled={int(blob['n_spilled'])} n_dropped={int(blob['n_dropped'])}",
        f"  (probe: profile 0 drops 1 and wins on exactness; profile 1 "
        f"would drop 11.  An all-zero page drops nothing either way and "
        f"picks the smaller profile {zero_pid}: "
        f"{cfg.compressed_bytes_for_profile(zero_pid)} bytes.)",
        "",
        f"ptrs   ({cfg.ptr_lanes} int32 lanes):",
        *_rows(blob["ptrs"], 8, lambda v: f"0x{int(np.uint32(v)):08x}"),
        f"deltas (profile {pid}: {lanes} of {cfg.delta_lanes} buffer lanes "
        f"stored; class0 lanes [0..{offs[1] - 1}], class1 "
        f"[{offs[1]}..{lanes - 1}]):",
        *_rows(np.asarray(blob["deltas"])[:lanes], 8,
               lambda v: f"0x{int(np.uint32(v)):08x}"),
        f"out_vals = {[int(v) for v in blob['out_vals']]}   "
        f"out_idx = {[int(v) for v in blob['out_idx']]}",
        "",
        f"serialized page ({cfg.compressed_bytes_for_profile(pid)} bytes: "
        "profile | ptrs | deltas | out_vals | out_idx | n_out):",
        *_hexdump(serialize_page(blob, cfg)),
    ]
    return "\n".join(lines)


def _unpacked_codes(blob: dict[str, Any], cfg: FRConfig) -> npt.NDArray[Any]:
    ptrs = torch.as_tensor(_np(blob["ptrs"]))
    return unpack_lanes(ptrs, cfg.ptr_bits, cfg.page_words).numpy()


def _hexdump(data: bytes) -> list[str]:
    return [
        f"  {i:04x}  " + " ".join(f"{b:02x}" for b in data[i:i + 16])
        for i in range(0, len(data), 16)
    ]


__all__ = ["encode_example", "example_config", "example_page", "example_table",
           "serialize_page", "worked_example"]


if __name__ == "__main__":
    print(worked_example())
