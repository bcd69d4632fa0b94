"""Plain float32 decode attention over a raw K/V history, full or windowed.

The semantic yardstick of the compressed KV path (``kv_cache``) for a
model whose layers mix sliding-window and full attention.  One query token
a row at position ``pos`` attends over the raw tokens at positions
``[pos - window + 1, pos]`` (``window`` 0: ``[0, pos]``), the convention of
``models/layers.py``'s mask; query head ``h`` reads KV head ``h // (H //
Kv)``.  Plain torch operations in float32 with TF32 off: no kernel, no
cache, no batching tricks, nothing of the JAX package.
"""
from __future__ import annotations

import torch


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
                     window: int = 0) -> torch.Tensor:
    """q (B, H, hd); k and v (B, T, Kv, hd) by position, T > ``pos`` ->
    (B, H, hd) float32 over positions ``[max(0, pos - window + 1), pos]``."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        lo = max(0, pos - window + 1) if window else 0
        B, H, hd = q.shape
        Kv = k.shape[2]
        kf, vf = k[:, lo:pos + 1].float(), v[:, lo:pos + 1].float()
        qf = q.float().reshape(B, Kv, H // Kv, hd)
        scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
        logits = torch.einsum("bkgh,btkh->bkgt", qf, kf) * scale
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bkgt,btkh->bkgh", probs, vf).reshape(B, H, hd)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


__all__ = ["window_attention"]
