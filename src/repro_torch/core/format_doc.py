"""Normative byte layout of one encoded GBDI-FR page.

Copy of :func:`repro.core.format_doc.serialize_page`, so a port blob can be
serialized (and checked against golden CRCs) without JAX.  Accepts numpy
arrays or tensors on any device.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.gbdi_fr import FRConfig


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


__all__ = ["serialize_page"]
