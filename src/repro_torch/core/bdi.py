"""B∆I (Base-Delta-Immediate, ASPLOS'12) — the paper's comparison baseline, on tensors.

PyTorch counterpart of :mod:`repro.core.bdi`.  Per 64 B block, independently:
zeros, a repeated 8-byte value, or base-``b`` + delta-``d`` with an implicit
zero base for each of the six ``(b, d)`` patterns; the smallest wins (ties to
the earlier of zeros, repeated, then the patterns in order).  No inter-block
state — the contrast with GBDI.  The blob keeps the same ``tags``,
``sizes_bits``, ``patterns`` and block IR (``blocks``, uint8) as the
reference, on the device the bytes were given on.

Words of ``b`` bytes are read as little-endian views of the block bytes:
8-byte words as signed int64, narrower words widened unsigned to int64.
``words - base`` on 8-byte words wraps mod 2**64, as numpy's int64 does;
the reconstruction ``base + delta`` wraps back to the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import numpy.typing as npt
import torch

from repro_torch._device import resolve_device

_TAG_BITS = 4
# (base_bytes, delta_bytes) pairs from the B∆I paper
_PATTERNS = [(8, 1), (8, 2), (8, 4), (4, 1), (4, 2), (2, 1)]
_SIGNED_VIEW = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass(frozen=True)
class BDIConfig:
    block_bytes: int = 64


def _view_words(blocks: torch.Tensor, size: int) -> torch.Tensor:
    """(n_blocks, block_bytes) uint8 -> (n_blocks, block_bytes/size) int64:
    the signed view for 8-byte words, the unsigned value for narrower ones."""
    if size == 1:
        return blocks.to(torch.int64)
    words = blocks.contiguous().view(_SIGNED_VIEW[size]).to(torch.int64)
    return words if size == 8 else words & ((1 << (8 * size)) - 1)


def _to_bytes(words: torch.Tensor, size: int) -> torch.Tensor:
    """Inverse of :func:`_view_words` on int64 words (low ``size`` bytes)."""
    if size == 1:
        return (words & 0xFF).to(torch.uint8)
    if size < 8:
        half = 1 << (8 * size - 1)
        words = ((words + half) & ((1 << (8 * size)) - 1)) - half   # signed, in range
    return words.to(_SIGNED_VIEW[size]).contiguous().view(torch.uint8)


def as_bytes(data: npt.NDArray[Any] | bytes | torch.Tensor,
             device: str | torch.device | None = None) -> torch.Tensor:
    """The raw bytes of ``data`` as a uint8 tensor: a tensor's own bytes on
    its device (moved to ``device`` if one is named), a numpy buffer or
    ``bytes`` uploaded (to the card by default)."""
    if isinstance(data, torch.Tensor):
        buf = data.contiguous().reshape(-1).view(torch.uint8)
        return buf if device is None else buf.to(device)
    if isinstance(data, (bytes, bytearray)):
        host = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        host = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return torch.from_numpy(host.copy()).to(resolve_device(device))


def compress(data: npt.NDArray[Any] | bytes | torch.Tensor, config: BDIConfig = BDIConfig(),
             device: str | torch.device | None = None) -> dict[str, Any]:
    """Per-block chosen pattern, sizes (bits) and the IR for decode.

    The bytes are padded to 4 (the reference frames them as 32-bit words
    first) and then to whole blocks.
    """
    buf = as_bytes(data, device)
    n4 = buf.numel() + (-buf.numel()) % 4
    bb = config.block_bytes
    pad = n4 + (-n4) % bb - buf.numel()
    if pad:
        buf = torch.nn.functional.pad(buf, (0, pad))
    blocks = buf.reshape(-1, bb)
    n_blocks = blocks.shape[0]
    dev = blocks.device

    sizes = torch.full((n_blocks,), _TAG_BITS + bb * 8, dtype=torch.int64, device=dev)
    tags = torch.zeros(n_blocks, dtype=torch.int64, device=dev)   # 0 = uncompressed

    w8 = _view_words(blocks, 8)
    is_zero = (blocks == 0).all(dim=1)
    is_rep = (w8 == w8[:, :1]).all(dim=1)

    for i, (b, d) in enumerate(_PATTERNS):
        words = _view_words(blocks, b)
        half = 1 << (8 * d - 1)
        diff = words - words[:, :1]               # wraps mod 2**64 for 8-byte words
        fit_base = (diff >= -half) & (diff < half)
        fit_zero = (words >= -half) & (words < half)
        fits = (fit_base | fit_zero).all(dim=1)
        nw = words.shape[1]
        size = _TAG_BITS + 8 * b + nw * 8 * d + nw  # base + deltas + base-select bitmask
        better = fits & (size < sizes)
        sizes = torch.where(better, size, sizes)
        tags = torch.where(better, 3 + i, tags)
    rep_size = _TAG_BITS + 64
    better = is_rep & (rep_size < sizes)
    sizes, tags = torch.where(better, rep_size, sizes), torch.where(better, 2, tags)
    zero_size = _TAG_BITS
    better = is_zero & (zero_size < sizes)
    sizes, tags = torch.where(better, zero_size, sizes), torch.where(better, 1, tags)

    return {
        "config": config,
        "n_bytes": int(buf.numel()),
        "blocks": blocks,          # kept for roundtrip IR (not counted in size)
        "tags": tags,
        "sizes_bits": sizes,
        "patterns": list(_PATTERNS),
    }


def decompress(blob: dict[str, Any]) -> torch.Tensor:
    """Reconstruct the padded bytes (uint8) from the IR by re-deriving each
    block's encoding."""
    blocks, tags = blob["blocks"], blob["tags"]
    out = torch.zeros_like(blocks)
    keep = (tags == 2) | (tags == 0)     # a repeated w8 reproduces the block exactly
    out[keep] = blocks[keep]
    for i, (b, d) in enumerate(blob["patterns"]):
        sel = tags == 3 + i
        if not bool(sel.any()):
            continue
        words = _view_words(blocks[sel], b)
        base = words[:, :1]
        half = 1 << (8 * d - 1)
        use_zero = (words >= -half) & (words < half)
        delta = torch.where(use_zero, words, words - base)   # both fit by choice
        rec = torch.where(use_zero, delta, base + delta)
        out[sel] = _to_bytes(rec, b).reshape(-1, blocks.shape[1])
    return out.reshape(-1)


def compressed_size_bits(blob: dict[str, Any]) -> int:
    return int(blob["sizes_bits"].sum())


def compression_ratio(blob: dict[str, Any]) -> float:
    return blob["n_bytes"] * 8 / max(1, compressed_size_bits(blob))


__all__ = ["BDIConfig", "as_bytes", "compress", "compressed_size_bits", "compression_ratio",
           "decompress"]
