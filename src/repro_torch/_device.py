"""Device choice for the port's entry points (the card unless told
otherwise), and the one helper through which the port copies host values to
the card with a blocking copy."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import obs


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` must be asked for by name.

    Raises when no card is present and the caller did not ask for the CPU,
    so no entry point silently carries on on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


def upload(data: Any, *, dtype: torch.dtype, device: str | torch.device) -> torch.Tensor:
    """``torch.tensor(data, dtype=dtype, device=device)``.  On a CUDA device
    that is a copy from pageable host memory, which waits for the stream's
    queued work; there it is counted in ``uploads`` and recorded as an
    ``upload`` span."""
    if torch.device(device).type != "cuda":
        return torch.tensor(data, dtype=dtype, device=device)
    obs.count("uploads")
    with obs.span("upload"):
        return torch.tensor(data, dtype=dtype, device=device)


__all__ = ["resolve_device", "upload"]
