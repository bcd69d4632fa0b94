"""Bit-granular pack/unpack on tensors for the host (paper-faithful) GBDI codec.

PyTorch counterpart of :mod:`repro.core.bitpack`.  Field ``i`` occupies
``widths[i]`` bits, LSB-first, at bit offset ``sum(widths[:i])`` of a
little-endian bit stream; the bytes equal ``np.packbits(bits,
bitorder="little")`` of the reference, zero-padded last byte included.

No field is wider than 32 bits, so a field shifted to its bit offset within
its first byte (at most 39 bits) fits an int64 and spans at most five
bytes.  :func:`pack_bits` adds each field's five byte slices into the byte
stream with ``index_add_``: fields own disjoint bits, so the sums never
carry and equal a bitwise OR in any order (deterministic on the card too).
:func:`unpack_bits` gathers the same five bytes per field.  Both run on the
device of their input, in chunks of ``_CHUNK`` fields.
"""
from __future__ import annotations

import torch

#: fields per chunk: bounds the (chunk, 5) int64 scratch
_CHUNK = 1 << 22
#: the widest field; with 7 bits of in-byte offset it spans five bytes
MAX_WIDTH = 32
_SPAN = 5


def _offsets(widths: torch.Tensor) -> tuple[torch.Tensor, int]:
    if widths.numel() and int(widths.min()) < 0:
        raise ValueError("widths must be >= 0")
    if widths.numel() and int(widths.max()) > MAX_WIDTH:
        raise ValueError(f"fields wider than {MAX_WIDTH} bits are not supported")
    ends = torch.cumsum(widths, 0)
    total = int(ends[-1]) if widths.numel() else 0
    return ends - widths, total


def pack_bits(values: torch.Tensor, widths: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pack ``values[i]`` into ``widths[i]`` bits each (LSB-first).

    Returns ``(bytestream uint8, total_bits)`` on the values' device.  Bits
    of a value above its width are ignored; a width of 0 emits nothing.
    """
    values = values.reshape(-1).to(torch.int64)
    widths = widths.reshape(-1).to(device=values.device, dtype=torch.int64)
    if values.shape != widths.shape:
        raise ValueError("values/widths must be equal-length 1-D tensors")
    offs, total = _offsets(widths)
    n_bytes = (total + 7) // 8
    out = torch.zeros(n_bytes + _SPAN, dtype=torch.int64, device=values.device)
    js = torch.arange(_SPAN, device=values.device)
    for lo in range(0, values.numel(), _CHUNK):
        v, w, off = values[lo:lo + _CHUNK], widths[lo:lo + _CHUNK], offs[lo:lo + _CHUNK]
        field = (v & ((1 << w) - 1)) << (off & 7)                 # <= 39 bits
        parts = (field[:, None] >> (8 * js)) & 0xFF               # (c, 5) bytes
        idx = (off >> 3)[:, None] + js
        out.index_add_(0, idx.reshape(-1), parts.reshape(-1))
    return out[:n_bytes].to(torch.uint8), total


def unpack_bits(data: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int64 values, one per width, on the
    data's device."""
    data = data.reshape(-1).to(torch.int64)
    widths = widths.reshape(-1).to(device=data.device, dtype=torch.int64)
    offs, total = _offsets(widths)
    need = (total + 7) // 8
    buf = torch.zeros(max(need, data.numel()) + _SPAN, dtype=torch.int64, device=data.device)
    buf[:min(need, data.numel())] = data[:need]
    out = torch.empty(widths.numel(), dtype=torch.int64, device=data.device)
    js = torch.arange(_SPAN, device=data.device)
    for lo in range(0, widths.numel(), _CHUNK):
        w, off = widths[lo:lo + _CHUNK], offs[lo:lo + _CHUNK]
        raw = (buf[(off >> 3)[:, None] + js] << (8 * js)).sum(dim=1)
        out[lo:lo + _CHUNK] = (raw >> (off & 7)) & ((1 << w) - 1)
    return out


__all__ = ["MAX_WIDTH", "pack_bits", "unpack_bits"]
