"""Device choice for the port's entry points: the card unless told otherwise."""
from __future__ import annotations

import torch


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


__all__ = ["resolve_device"]
