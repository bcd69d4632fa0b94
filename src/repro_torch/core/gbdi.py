"""GBDI — Global Bases Delta Immediate, the paper-faithful host codec, on tensors.

PyTorch counterpart of :mod:`repro.core.gbdi` (see its docstring for the
format): a stream of ``word_bits``-wide words, a fitted table of
``num_bases`` global bases each paired with a delta width, and per word a
``ptr_bits`` base pointer plus a two's-complement delta of its base's width
(the zero word has no payload, an outlier carries the raw word).  The bit
streams are packed by :mod:`repro_torch.core.bitpack` and equal the
reference's byte for byte for the same model.

The word stream is the int32 view the codec works on (:func:`words_to_signed`:
32-bit words reinterpreted, 16-bit words zero-extended).  :func:`fit` and
:func:`encode` take a raw buffer (numpy or bytes, uploaded to the device) or
such a stream as a tensor (used where it lies); :func:`decode` returns the
stream as an int32 tensor on the blob's device.  ``ptr_stream`` and
``payload_stream`` are uint8 tensors; the totals and ``n_words`` are ints.

The word views :func:`to_words`, :func:`words_to_signed` and
:func:`signed_to_words` are numpy, copied from the reference, so the port
frames a memory dump or a tensor as the same memory words.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import numpy.typing as npt
import torch

from repro_torch._device import resolve_device
from repro_torch.core import bitpack
from repro_torch.core import format as fmt
from repro_torch.core.format import BaseTable, assign, word_mask, wrap_int32
from repro_torch.core.kmeans import fit_bases_host

#: words per assignment chunk: bounds the (chunk, num_bases) int64 scratch
ASSIGN_CHUNK = 1 << 20


@dataclasses.dataclass(frozen=True)
class GBDIConfig:
    word_bits: int = 32
    block_words: int = 16
    num_bases: int = 30           # +2 reserved codes -> 32 codes, 5-bit pointers
    width_set: tuple[int, ...] = (4, 8, 16, 24)
    kmeans_iters: int = 12
    sample_words: int = 1 << 16
    modified_kmeans: bool = True  # paper: modified beats vanilla
    seed: int = 0

    def __post_init__(self) -> None:
        if self.word_bits not in (16, 32):
            raise ValueError("word_bits must be 16 or 32")
        if any(w >= self.word_bits for w in self.width_set):
            raise ValueError("delta widths must be narrower than the word")

    @property
    def ptr_bits(self) -> int:
        return fmt.ptr_bits(self.num_bases)

    @property
    def zero_code(self) -> int:
        return fmt.zero_code(self.num_bases)

    @property
    def outlier_code(self) -> int:
        return fmt.outlier_code(self.num_bases)

    @property
    def table_bits(self) -> int:
        # base values + 2-bit width-class index per base
        return self.num_bases * (self.word_bits + max(2, math.ceil(math.log2(len(self.width_set)))))


@dataclasses.dataclass(frozen=True)
class GBDIModel:
    """Fitted global state: the base table and paired widths, (k,) int32
    tensors on the model's device."""
    config: GBDIConfig
    bases: torch.Tensor    # (k,) signed view of the word bit pattern
    widths: torch.Tensor   # (k,) each from config.width_set

    @property
    def table(self) -> BaseTable:
        return BaseTable(self.bases, self.widths)

    @property
    def device(self) -> torch.device:
        return self.bases.device

    def to(self, device: str | torch.device) -> "GBDIModel":
        return GBDIModel(self.config, self.bases.to(device), self.widths.to(device))


# ---------------------------------------------------------------------------
# dtype <-> word-stream helpers
# ---------------------------------------------------------------------------

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


def word_stream(data: npt.NDArray[Any] | bytes | torch.Tensor, word_bits: int,
                device: str | torch.device | None = None) -> torch.Tensor:
    """The (n_words,) int32 word stream of ``data``: a tensor is taken as
    that stream already (moved to ``device`` if one is named); a raw buffer
    is framed by :func:`to_words` and uploaded (to the card by default)."""
    if isinstance(data, torch.Tensor):
        words = data.reshape(-1).to(torch.int32)
        return words if device is None else words.to(device)
    signed = words_to_signed(to_words(data, word_bits), word_bits)
    return torch.from_numpy(np.ascontiguousarray(signed, np.int32)).to(resolve_device(device))


# ---------------------------------------------------------------------------
# fit / encode / decode (bit-granular, lossless)
# ---------------------------------------------------------------------------

def block_sizes_bits(values: torch.Tensor, bases: torch.Tensor, base_widths: torch.Tensor, *,
                     word_bits: int, block_words: int, ptr_bits: int) -> torch.Tensor:
    """Exact encoded bits per block (the size model used everywhere)."""
    pw = _assign(values, BaseTable(bases, base_widths), word_bits)["payload_width"]
    per_word = ptr_bits + pw.to(torch.int64)
    n_blocks = values.shape[0] // block_words
    return per_word[: n_blocks * block_words].reshape(n_blocks, block_words).sum(dim=1)


def _assign(words: torch.Tensor, table: BaseTable, word_bits: int) -> dict[str, torch.Tensor]:
    """:func:`repro_torch.core.format.assign` in chunks of ``ASSIGN_CHUNK`` words."""
    parts = [assign(words[lo:lo + ASSIGN_CHUNK], table.bases, table.widths, word_bits=word_bits)
             for lo in range(0, max(1, words.numel()), ASSIGN_CHUNK)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def fit(data: npt.NDArray[Any] | bytes | torch.Tensor, config: GBDIConfig = GBDIConfig(),
        device: str | torch.device | None = None) -> GBDIModel:
    """Offline "background data analysis": fit the global base table on the
    stream's device (the card unless ``device`` says otherwise)."""
    words = word_stream(data, config.word_bits, device)
    bases, widths = fit_bases_host(
        words,
        num_bases=config.num_bases,
        width_set=config.width_set,
        word_bits=config.word_bits,
        iters=config.kmeans_iters,
        sample_words=config.sample_words,
        modified=config.modified_kmeans,
        seed=config.seed,
    )
    dev = words.device
    return GBDIModel(config=config, bases=torch.as_tensor(bases, device=dev),
                     widths=torch.as_tensor(widths, device=dev))


def encode(data: npt.NDArray[Any] | bytes | torch.Tensor, model: GBDIModel) -> dict[str, Any]:
    """Compress to the bit-granular GBDI format on the model's device.  Lossless."""
    cfg = model.config
    words = word_stream(data, cfg.word_bits, model.device)
    a = _assign(words, model.table, cfg.word_bits)
    code, pw = a["code"], a["payload_width"].to(torch.int64)
    ptr_stream, ptr_bits_total = bitpack.pack_bits(
        code, torch.full_like(pw, cfg.ptr_bits))
    # payload: two's-complement delta in pw bits; outliers carry the raw word
    raw = words.to(torch.int64) & word_mask(cfg.word_bits)
    payload_vals = torch.where(code == cfg.outlier_code, raw, a["delta"].to(torch.int64))
    payload_stream, payload_bits_total = bitpack.pack_bits(payload_vals, pw)
    return {
        "ptr_stream": ptr_stream,
        "payload_stream": payload_stream,
        "n_words": int(words.numel()),
        "ptr_bits_total": int(ptr_bits_total),
        "payload_bits_total": int(payload_bits_total),
        "bases": model.bases,
        "widths": model.widths,
        "config": cfg,
    }


def decode(blob: dict[str, Any]) -> torch.Tensor:
    """Reconstruct the exact word stream: (n_words,) int32 (the
    :func:`words_to_signed` view) on the blob's device."""
    cfg: GBDIConfig = blob["config"]
    n = blob["n_words"]
    dev = blob["ptr_stream"].device
    codes = bitpack.unpack_bits(
        blob["ptr_stream"], torch.full((n,), cfg.ptr_bits, dtype=torch.int64, device=dev))
    k = cfg.num_bases
    is_base = codes < k
    is_outlier = codes == cfg.outlier_code
    safe = codes.clamp(0, k - 1)
    widths_tbl = blob["widths"].to(device=dev, dtype=torch.int64)
    pw = torch.where(is_base, widths_tbl[safe], 0)
    pw = torch.where(is_outlier, cfg.word_bits, pw)
    payload = bitpack.unpack_bits(blob["payload_stream"], pw)
    # sign-extend deltas
    half = torch.where(pw > 0, 1 << (pw - 1).clamp_min(0), 1)
    delta = torch.where(payload >= half, payload - (1 << pw.clamp_min(1)), payload)
    bases = blob["bases"].to(device=dev, dtype=torch.int64)
    mask = word_mask(cfg.word_bits)
    vals = torch.where(is_base, (bases[safe] + delta) & mask, 0)
    vals = torch.where(is_outlier, payload & mask, vals)
    return wrap_int32(vals) if cfg.word_bits == 32 else vals.to(torch.int32)


def compressed_size_bits(blob: dict[str, Any]) -> int:
    cfg: GBDIConfig = blob["config"]
    return blob["ptr_bits_total"] + blob["payload_bits_total"] + cfg.table_bits


def compression_ratio(blob: dict[str, Any]) -> float:
    cfg: GBDIConfig = blob["config"]
    return blob["n_words"] * cfg.word_bits / max(1, compressed_size_bits(blob))


def roundtrip_ok(data: npt.NDArray[Any] | bytes | torch.Tensor, model: GBDIModel) -> bool:
    words = word_stream(data, model.config.word_bits, model.device)
    return bool(torch.equal(decode(encode(words, model)), words))


__all__ = [
    "ASSIGN_CHUNK",
    "BaseTable",
    "GBDIConfig",
    "GBDIModel",
    "assign",
    "block_sizes_bits",
    "compressed_size_bits",
    "compression_ratio",
    "decode",
    "encode",
    "fit",
    "roundtrip_ok",
    "signed_to_words",
    "to_words",
    "word_stream",
    "words_to_signed",
]
