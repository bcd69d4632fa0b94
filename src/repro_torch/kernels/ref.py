"""Plain PyTorch oracle for the GBDI-FR kernels.

The oracle *is* the batched fixed-rate codec in
:mod:`repro_torch.core.gbdi_fr`; the CUDA kernels must reproduce it bit for
bit, and it reproduces the JAX oracle for the same table.
"""
from __future__ import annotations

import torch

from repro_torch.core.format import TableLike
from repro_torch.core.gbdi_fr import FRConfig, fr_decode, fr_encode


def encode_ref(x_pages: torch.Tensor, table: TableLike, cfg: FRConfig) -> dict[str, torch.Tensor]:
    return fr_encode(x_pages, table, cfg)


def decode_ref(blob: dict[str, torch.Tensor], table: TableLike, cfg: FRConfig) -> torch.Tensor:
    return fr_decode(blob, table, cfg)
