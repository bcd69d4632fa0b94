"""Plain float32 decode attention, and the cache's precision one step down.

One query token per row attends over every cached token ``[0, pos]``; query
head ``h`` reads KV head ``h // (H // Kv)``.  TF32 is switched off so the
float32 products are float32.  Rows go through in blocks so that the float32
copy of a long cache fits beside whatever else is resident.
"""
from __future__ import annotations

import torch


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, rows: int = 4) -> torch.Tensor:
    """q (B, H, hd), k and v (B, T, Kv, hd) -> (B, H, hd) float32."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _attend(q, k, v, rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rows: int) -> torch.Tensor:
    B, H, hd = q.shape
    Kv = k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    outs = []
    for b0 in range(0, B, rows):
        qb = q[b0:b0 + rows].float().reshape(-1, Kv, H // Kv, hd)
        kb, vb = k[b0:b0 + rows].float(), v[b0:b0 + rows].float()
        logits = torch.einsum("bkgh,btkh->bkgt", qb, kb) * scale.to(qb.device)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bkgt,btkh->bkgh", probs, vb).reshape(-1, H, hd))
    return torch.cat(outs)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """The cache one precision below bf16: values rounded through float8 e4m3."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)
