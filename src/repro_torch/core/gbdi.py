"""Word-stream views of raw buffers (the dtype <-> word helpers of the GBDI core).

Copies of :func:`repro.core.gbdi.to_words`, :func:`words_to_signed` and
:func:`signed_to_words`: numpy only, so the port frames a memory dump or a
tensor as the same memory words the reference does.  The bit-granular host
codec of :mod:`repro.core.gbdi` is not part of this package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import numpy.typing as npt


def to_words(arr: npt.NDArray[Any] | bytes, word_bits: int = 32) -> npt.NDArray[Any]:
    """View any buffer/array as a stream of unsigned words (zero-padded)."""
    if isinstance(arr, (bytes, bytearray)):
        buf = np.frombuffer(bytes(arr), dtype=np.uint8)
    else:
        buf = np.ascontiguousarray(arr)
        buf = buf.view(np.uint8).reshape(-1)
    word_bytes = word_bits // 8
    pad = (-buf.size) % word_bytes
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return buf.view(np.uint16 if word_bits == 16 else np.uint32)


def words_to_signed(words: npt.NDArray[Any], word_bits: int) -> npt.NDArray[Any]:
    """Unsigned word patterns -> the int32 view the codec works on (16-bit
    words zero-extended, 32-bit words reinterpreted)."""
    if word_bits == 32:
        return words.astype(np.uint32).view(np.int32)
    return words.astype(np.int32)


def signed_to_words(signed: npt.NDArray[Any], word_bits: int) -> npt.NDArray[Any]:
    if word_bits == 32:
        return signed.astype(np.int32).view(np.uint32)
    return (signed.astype(np.int64) & 0xFFFF).astype(np.uint16)


__all__ = ["signed_to_words", "to_words", "words_to_signed"]
