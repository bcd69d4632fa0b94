"""``fit/encode/decode/size_bits`` adapters over the port's codec paths.

PyTorch counterpart of :mod:`repro.eval.codecs`: the paper's GBDI host codec
(:class:`GBDICodec`, :mod:`repro_torch.core.gbdi`), the B∆I baseline
(:class:`BDICodec`, :mod:`repro_torch.core.bdi`) and the fixed-rate GBDI-FR
pages (:class:`FRCodec`).  The word stream lives on the codec's device from
end to end: ``stream(data)`` uploads a buffer once as int32 words (16-bit
words zero-extended, 32-bit words reinterpreted), ``fit`` and ``encode``
take that device tensor and ``decode`` returns the same stream, cut to its
word count.  On a CUDA device FR's encode and decode run the hand-written
kernels; GBDI's assignment and bit packing and B∆I run as plain PyTorch on
the card (the reference runs them outside any Pallas kernel too).  On the
CPU (``device="cpu"``, asked for by name) everything runs the plain
versions.  The lossless codecs drop no word (``dropped_words`` is 0).

Names, as the reference registers them: ``fr`` runs the codec through
:mod:`repro_torch.kernels.ops` by the device (the plain version on the CPU,
as the reference's jnp oracle; the kernels on the card); ``fr_xla`` is FR
through the multi-device front-end :mod:`repro_torch.kernels.pipeline` (the
role of the reference's compiled XLA path, with its ``devices`` and
``stream_batches`` knobs); ``fr_kernel`` asks for the kernels by name (on the
CPU their wrappers run the plain versions).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import bdi, gbdi
from repro_torch.core.format import BaseTable
from repro_torch.core.gbdi_fr import FRConfig, fit_fr_bases
from repro_torch.eval.registry import CodecRegistry
from repro_torch.kernels import ops, pipeline


def word_bits_for_dtype(dtype: Any) -> int:
    """Natural codec word size for a tensor dtype, by bit pattern: 2-byte
    dtypes (bf16/fp16/int16) frame as 16-bit words, everything else as the
    paper's 32-bit memory words.  Accepts numpy dtypes and torch dtypes."""
    if isinstance(dtype, torch.dtype):
        return 16 if dtype.itemsize == 2 else 32
    return 16 if np.dtype(dtype).itemsize == 2 else 32


@dataclasses.dataclass
class _DeviceCodec:
    """What every adapter shares: its device and the upload of a buffer."""

    word_bits: int = 32
    device: str | None = None      # None: the CUDA card; "cpu" must be asked for

    def __post_init__(self) -> None:
        self._device = resolve_device(self.device)

    @property
    def torch_device(self) -> torch.device:
        return self._device

    def stream(self, data: np.ndarray) -> torch.Tensor:
        """Upload a raw buffer as the (n_words,) int32 word stream."""
        return gbdi.word_stream(data, self.word_bits, self._device)

    def dropped_words(self, blob: dict[str, Any]) -> int:
        return 0


@dataclasses.dataclass
class GBDICodec(_DeviceCodec):
    """Paper-faithful host codec: variable-length bit stream, lossless."""

    name: str = "gbdi"
    lossless: bool = True

    def _config(self) -> gbdi.GBDIConfig:
        widths = (4, 8) if self.word_bits == 16 else (4, 8, 16, 24)
        return gbdi.GBDIConfig(word_bits=self.word_bits, width_set=widths)

    def fit(self, words: torch.Tensor) -> gbdi.GBDIModel:
        return gbdi.fit(words, self._config(), self._device)

    def encode(self, words: torch.Tensor, model: gbdi.GBDIModel) -> dict[str, Any]:
        return gbdi.encode(words, model.to(self._device))

    def decode(self, blob: dict[str, Any]) -> torch.Tensor:
        return gbdi.decode(blob)

    def size_bits(self, blob: dict[str, Any]) -> int:
        return gbdi.compressed_size_bits(blob)


@dataclasses.dataclass
class BDICodec(_DeviceCodec):
    """Per-block B∆I baseline (byte blocks; ``word_bits`` only names the view)."""

    name: str = "bdi"
    lossless: bool = True

    def fit(self, words: torch.Tensor) -> None:
        return None  # no global state — that is the contrast with GBDI

    def encode(self, words: torch.Tensor, model: None) -> dict[str, Any]:
        """Compress the stream's memory bytes: each word's low
        ``word_bits`` bits, little-endian, as :func:`gbdi.to_words` framed them."""
        words = words.to(self._device)
        if self.word_bits == 16:
            raw = (((words.to(torch.int64) + (1 << 15)) & 0xFFFF) - (1 << 15)).to(torch.int16)
        else:
            raw = words.to(torch.int32)
        blob = bdi.compress(raw, device=self._device)
        blob["_word_bits"] = self.word_bits
        blob["_n_words"] = int(words.numel())
        return blob

    def decode(self, blob: dict[str, Any]) -> torch.Tensor:
        """The (n_words,) int32 word stream, on the codec's device."""
        out = bdi.decompress(blob)
        if blob["_word_bits"] == 16:
            words = out.view(torch.int16).to(torch.int32) & 0xFFFF
        else:
            words = out.view(torch.int32)
        return words[: blob["_n_words"]]

    def size_bits(self, blob: dict[str, Any]) -> int:
        return bdi.compressed_size_bits(blob)


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
class FRCodec(_DeviceCodec):
    """GBDI-FR v2 fixed-rate pages; capacity-bounded lossless (dropped
    outliers decode to 0 and are counted in ``blob['n_dropped']``).

    ``backend`` is ``"auto"`` or ``"kernel"`` (:func:`ops.resolve_backend`),
    or ``"pipeline"``: the front-end :mod:`repro_torch.kernels.pipeline`,
    where ``devices`` forces a shard count and ``stream_batches > 1`` keeps
    the word stream on the host (pinned, on the card's machine) and feeds
    the pages to the device in that many double-buffered chunks
    (``encode_stream``; ``decode_stream`` back, the words returned to the
    host).  Every path is bit-identical to one codec call.
    """

    word_bits: int = 16
    name: str = "fr"
    lossless: bool = False
    cfg: FRConfig | None = None
    backend: str = "auto"
    devices: int | None = None     # pipeline backend: explicit shard count
    stream_batches: int = 0        # pipeline backend: > 1 streams from the host

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.backend not in ("auto", "kernel", "pipeline"):
            raise ValueError(f"unknown FR backend {self.backend!r}; choose auto, kernel "
                             "or pipeline")

    def _config(self) -> FRConfig:
        return self.cfg if self.cfg is not None else default_config(self.word_bits)

    @property
    def _streams(self) -> bool:
        return self.backend == "pipeline" and self.stream_batches > 1

    def stream(self, data: np.ndarray) -> torch.Tensor:
        """Upload a raw buffer as the (n_words,) int32 words of the config
        (a streaming codec keeps them on the host, pinned for the card)."""
        bits = self._config().word_bits
        if not self._streams:
            return gbdi.word_stream(data, bits, self._device)
        words = gbdi.word_stream(data, bits, "cpu")
        return words.pin_memory() if self._device.type == "cuda" else words

    def fit(self, words: torch.Tensor) -> BaseTable:
        # fit_fr_bases drops zeros and caps/tiles the sample
        return fit_fr_bases(words.to(self._device), self._config())

    def encode(self, words: torch.Tensor, table: BaseTable) -> dict[str, Any]:
        cfg = self._config()
        if not self._streams:
            words = words.to(self._device)
        n = words.shape[0]
        # an aligned stream is paged as a view; only a ragged tail is padded
        # (the pad copies the whole stream)
        if n % cfg.page_words:
            words = torch.nn.functional.pad(words, (0, (-n) % cfg.page_words))
        pages = words.reshape(-1, cfg.page_words)
        if self._streams:
            parts = torch.tensor_split(pages, min(self.stream_batches, max(1, pages.shape[0])))
            blobs = list(pipeline.encode_stream(parts, table, cfg, device=self._device))
            blob: dict[str, Any] = {k: torch.cat([b[k] for b in blobs]) for k in blobs[0]}
        elif self.backend == "pipeline":
            blob = dict(pipeline.encode_pages(pages, table, cfg, devices=self.devices))
        else:
            blob = dict(ops.encode_pages(pages, table, cfg, backend=self.backend))
        blob.update(_table=table, _cfg=cfg, _n_words=n)
        return blob

    def decode(self, blob: dict[str, Any]) -> torch.Tensor:
        """The (n_words,) int32 word stream, where :meth:`stream` put it."""
        cfg: FRConfig = blob["_cfg"]
        inner = {k: v for k, v in blob.items() if not k.startswith("_")}
        if self._streams:
            n = min(self.stream_batches, max(1, inner["n_out"].shape[0]))
            chunks = {k: torch.tensor_split(v, n) for k, v in inner.items()}
            parts = [{k: c[i] for k, c in chunks.items()} for i in range(n)]
            pages = torch.cat(list(pipeline.decode_stream(parts, blob["_table"], cfg,
                                                          device=self._device)))
            # the words go back to the host stream they came from
            return pages.reshape(-1)[: blob["_n_words"]].cpu()
        if self.backend == "pipeline":
            pages = pipeline.decode_pages(inner, blob["_table"], cfg, devices=self.devices,
                                          unsigned=True)
        else:
            pages = ops.decode_pages(inner, blob["_table"], cfg, backend=self.backend)
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
    reg.register("gbdi", lambda wb: GBDICodec(word_bits=wb, device=device))
    reg.register("bdi", lambda wb: BDICodec(word_bits=wb, device=device))
    reg.register("fr", lambda wb: FRCodec(word_bits=wb, device=device))
    reg.register("fr_xla", lambda wb: FRCodec(word_bits=wb, device=device, backend="pipeline",
                                              name="fr_xla"))
    reg.register("fr_kernel", lambda wb: FRCodec(word_bits=wb, device=device, backend="kernel",
                                                 name="fr_kernel"))
    return reg


__all__ = ["BDICodec", "FRCodec", "GBDICodec", "default_codecs", "default_config",
           "word_bits_for_dtype"]
