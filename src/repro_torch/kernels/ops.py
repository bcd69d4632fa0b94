"""Public wrappers around the GBDI-FR codec with backend selection.

Backends (bit-identical blobs):

* ``'ref'``    — the plain PyTorch oracle (:mod:`repro_torch.kernels.ref`);
  CPU tensors only, so a tensor on the card never takes the plain path;
* ``'kernel'`` — the CUDA kernels (:mod:`repro_torch.kernels.gbdi_encode`,
  :mod:`repro_torch.kernels.gbdi_decode`); their wrappers run the plain
  version for a CPU tensor;
* ``'auto'``   — follows the tensor: ``kernel`` on a CUDA device, ``ref`` on
  the CPU.  The default.

Tensor-level helpers bitcast fp32/bf16/int32 tensors to word pages and back.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.format import TableLike
from repro_torch.core.gbdi_fr import FRConfig, pages_to_tensor, tensor_to_pages
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.gbdi_decode import gbdi_decode
from repro_torch.kernels.gbdi_encode import PreparedTable, gbdi_encode, plain_table

BACKENDS = ("ref", "kernel", "auto")


def resolve_backend(backend: str | None, device: torch.device) -> str:
    """Resolve ``'auto'``/``None`` by device; refuse the plain path on the card."""
    if backend not in (None, *BACKENDS):
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend in (None, "auto"):
        return "kernel" if device.type == "cuda" else "ref"
    if backend == "ref" and device.type != "cpu":
        raise ValueError(f"backend 'ref' is the CPU path; a tensor on {device} "
                         "goes to the CUDA kernel ('kernel' or 'auto')")
    return backend


def encode_pages(
    x_pages: torch.Tensor, table: TableLike | PreparedTable, cfg: FRConfig,
    backend: str = "auto",
) -> dict[str, torch.Tensor]:
    if resolve_backend(backend, x_pages.device) == "kernel":
        return gbdi_encode(x_pages, table, cfg)
    return _ref.encode_ref(x_pages, plain_table(table), cfg)


def decode_pages(
    blob: dict[str, torch.Tensor], table: TableLike | PreparedTable, cfg: FRConfig,
    backend: str = "auto",
) -> torch.Tensor:
    if resolve_backend(backend, blob["ptrs"].device) == "kernel":
        return gbdi_decode(blob, table, cfg)
    return _ref.decode_ref(blob, plain_table(table), cfg)


def encode_tensor(
    x: torch.Tensor, table: TableLike, cfg: FRConfig, backend: str = "auto"
) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """Bitcast + page a tensor and encode it (no tile padding: a CUDA block
    takes one page, so any page count launches as it is)."""
    pages, meta = tensor_to_pages(x, cfg)
    meta["n_pages"] = pages.shape[0]
    return encode_pages(pages.contiguous(), table, cfg, backend), meta


def decode_tensor(
    blob: dict[str, torch.Tensor], meta: dict[str, Any], table: TableLike, cfg: FRConfig,
    backend: str = "auto",
) -> torch.Tensor:
    return pages_to_tensor(decode_pages(blob, table, cfg, backend), meta, cfg)
