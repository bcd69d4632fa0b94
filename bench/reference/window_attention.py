"""Plain float32 decode attention over a sliding window of cached tokens.

One query token a row at position ``pos`` attends over the tokens at
positions ``[pos - window + 1, pos]`` (``window`` 0: ``[0, pos]``), the
convention of the published configs' ``sliding_window``; query head ``h``
reads KV head ``h // (H // Kv)``.  TF32 is switched off so the float32
products are float32.  Rows go through in blocks, as ``attention.attend``.
The benchmark's own copy: it imports nothing of the program.
"""
from __future__ import annotations

import torch


def first_position(pos: int, window: int) -> int:
    """The first position a query at ``pos`` attends to."""
    return max(0, pos - window + 1) if window else 0


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
                     window: int = 0, *, rows: int = 4) -> torch.Tensor:
    """q (B, H, hd); k and v (B, T, Kv, hd) by position, T > ``pos`` ->
    (B, H, hd) float32 over positions ``[first_position(pos, window), pos]``."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        lo = first_position(pos, window)
        B, H, hd = q.shape
        Kv = k.shape[2]
        scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
        outs = []
        for b0 in range(0, B, rows):
            qb = q[b0:b0 + rows].float().reshape(-1, Kv, H // Kv, hd)
            kb = k[b0:b0 + rows, lo:pos + 1].float()
            vb = v[b0:b0 + rows, lo:pos + 1].float()
            logits = torch.einsum("bkgh,btkh->bkgt", qb, kb) * scale
            probs = torch.softmax(logits, dim=-1)
            outs.append(torch.einsum("bkgt,btkh->bkgh", probs, vb).reshape(-1, H, hd))
        return torch.cat(outs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
