"""``fit/encode/decode/size_bits`` adapter over the port's GBDI-FR path.

PyTorch counterpart of :class:`repro.eval.codecs.FRCodec`.  The word stream
lives on the codec's device from end to end: :meth:`FRCodec.stream` uploads
a buffer once as int32 words (16-bit words zero-extended, 32-bit words
reinterpreted), :meth:`FRCodec.encode` takes that device tensor and
:meth:`FRCodec.decode` returns one.  On a CUDA device encode and decode run
the hand-written kernels; on the CPU (``device="cpu"``, asked for by name)
they run the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.format import BaseTable
from repro_torch.core.gbdi import to_words, words_to_signed
from repro_torch.core.gbdi_fr import FRConfig, fit_fr_bases
from repro_torch.eval.registry import CodecRegistry
from repro_torch.kernels import ops


def default_config(word_bits: int) -> FRConfig:
    """The eval defaults of the reference codec, per word size."""
    if word_bits == 16:
        return FRConfig(word_bits=16, page_words=2048, num_bases=14,
                        width_set=(4, 8), bucket_caps=(192, 1856),
                        outlier_cap=64)
    return FRConfig(word_bits=32, page_words=2048, num_bases=14,
                    width_set=(8, 16), bucket_caps=(192, 1856),
                    outlier_cap=128)


@dataclasses.dataclass
class FRCodec:
    """GBDI-FR v2 fixed-rate pages; capacity-bounded lossless (dropped
    outliers decode to 0 and are counted in ``blob['n_dropped']``)."""

    word_bits: int = 16
    device: str | None = None      # None: the CUDA card; "cpu" must be asked for
    name: str = "fr"
    lossless: bool = False
    cfg: FRConfig | None = None

    def __post_init__(self) -> None:
        self._device = resolve_device(self.device)

    @property
    def torch_device(self) -> torch.device:
        return self._device

    def _config(self) -> FRConfig:
        return self.cfg if self.cfg is not None else default_config(self.word_bits)

    def stream(self, data: np.ndarray) -> torch.Tensor:
        """Upload a raw buffer as the (n_words,) int32 word stream."""
        cfg = self._config()
        signed = words_to_signed(to_words(data, cfg.word_bits), cfg.word_bits)
        return torch.from_numpy(np.ascontiguousarray(signed, np.int32)).to(self._device)

    def fit(self, words: torch.Tensor) -> BaseTable:
        # fit_fr_bases drops zeros and caps/tiles the sample
        return fit_fr_bases(words.to(self._device), self._config())

    def encode(self, words: torch.Tensor, table: BaseTable) -> dict[str, Any]:
        cfg = self._config()
        words = words.to(self._device)
        n = words.shape[0]
        # an aligned stream is paged as a view; only a ragged tail is padded
        # (the pad copies the whole stream)
        if n % cfg.page_words:
            words = torch.nn.functional.pad(words, (0, (-n) % cfg.page_words))
        blob: dict[str, Any] = dict(ops.encode_pages(
            words.reshape(-1, cfg.page_words), table, cfg))
        blob.update(_table=table, _cfg=cfg, _n_words=n)
        return blob

    def decode(self, blob: dict[str, Any]) -> torch.Tensor:
        """The (n_words,) int32 word stream, on the codec's device."""
        inner = {k: v for k, v in blob.items() if not k.startswith("_")}
        pages = ops.decode_pages(inner, blob["_table"], blob["_cfg"])
        return pages.reshape(-1)[: blob["_n_words"]]

    def size_bits(self, blob: dict[str, Any]) -> int:
        cfg: FRConfig = blob["_cfg"]
        n_pages = -(-blob["_n_words"] // cfg.page_words)
        # base values + width-class index per base (0 bits if single-class)
        idx_bits = (len(cfg.width_set) - 1).bit_length()
        table_bits = cfg.num_bases * (cfg.word_bits + idx_bits)
        if cfg.num_profiles == 1:
            return n_pages * cfg.compressed_bytes_per_page() * 8 + table_bits
        # adaptive profiles serialize at their own per-page size
        prof = blob["profile"].reshape(-1)[:n_pages].cpu().numpy()
        bytes_per = np.array([cfg.compressed_bytes_for_profile(p)
                              for p in range(cfg.num_profiles)], np.int64)
        return int(bytes_per[prof].sum()) * 8 + table_bits

    def dropped_words(self, blob: dict[str, Any]) -> int:
        return int(blob["n_dropped"].sum())

    def spilled_words(self, blob: dict[str, Any]) -> int:
        return int(blob["n_spilled"].sum())

    def profile_histogram(self, blob: dict[str, Any]) -> list[int]:
        """Per-profile page counts of the data pages."""
        cfg: FRConfig = blob["_cfg"]
        n_pages = -(-blob["_n_words"] // cfg.page_words)
        if cfg.num_profiles == 1:
            return [n_pages]
        prof = blob["profile"].reshape(-1)[:n_pages].cpu().numpy()
        return np.bincount(prof, minlength=cfg.num_profiles).tolist()


def default_codecs(device: str | None = None) -> CodecRegistry:
    reg = CodecRegistry()
    reg.register("fr", lambda wb: FRCodec(word_bits=wb, device=device))
    return reg


__all__ = ["FRCodec", "default_codecs", "default_config"]
