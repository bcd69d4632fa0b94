"""Token-choice top-k MoE with fixed-capacity sort-based dispatch.

PyTorch counterpart of :mod:`repro.models.moe` (qwen3: 128 experts top-8,
mixtral: 8 experts top-2).  Dispatch is the reference's sort/rank
construction, op for op:

  top-k -> flatten (T*k assignments) -> stable sort by expert ->
  within-expert rank via exclusive-cumsum starts -> keep rank < capacity ->
  gather tokens into an (E*C, d) buffer -> stacked-expert SwiGLU einsum ->
  gather back, combine with router weights.

Expert weights are stacked on a leading E axis.  The leading shard axis G of
the reference's shard-local dispatch is kept; the port runs a model on one
device, so G is 1 (``cfg.dp_shards`` is 1 there too).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init

#: at most this many token-expert assignments run at full (no-drop)
#: capacity, so decode steps and small batches are exact
NO_DROP_ASSIGNMENTS = 8192


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: torch.device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def stacked(shape: tuple[int, int, int], fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (w / np.sqrt(np.float32(fan_in))).to(device=device, dtype=dtype)

    return {
        "router": dense_init(gen, (d, e), torch.float32, device),
        "wg": stacked((e, d, f), d),
        "wu": stacked((e, d, f), d),
        "wd": stacked((e, f, d), f),
    }


def _n_shards(cfg: ModelConfig, T: int) -> int:
    """DP shard count for shard-local dispatch (1 = global path)."""
    n = cfg.dp_shards
    return n if n > 1 and T % n == 0 else 1


def capacity(cfg: ModelConfig, T: int) -> int:
    """Per-expert slots a shard: every assignment when ``T * top_k`` is at
    most :data:`NO_DROP_ASSIGNMENTS`, else the capacity-factor share."""
    K = cfg.top_k
    Tl = T // _n_shards(cfg, T)
    if T * K <= NO_DROP_ASSIGNMENTS:
        return Tl * K
    return int(Tl * K // cfg.n_experts * cfg.capacity_factor) + 1


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Load-balancing aux loss per Switch."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = _n_shards(cfg, T)
    Tl = T // G
    xt = x.reshape(G, Tl, d)

    logits = torch.einsum("gtd,de->gte", xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    w, eid = torch.topk(probs, K, dim=-1)                           # (G, Tl, K)
    w = (w / w.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype)

    # load-balance aux loss (Switch): E * sum_e fraction_e * prob_e
    frac = F.one_hot(eid[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (frac * probs.mean(dim=(0, 1))).sum()

    C = capacity(cfg, T)
    N = Tl * K
    dev = x.device
    flat_e = eid.reshape(G, N)
    flat_t = (torch.arange(N, device=dev) // K)[None, :].expand(G, N)
    flat_w = w.reshape(G, N)

    # shard-local stable sort; dispatch and combine are gathers
    order = torch.argsort(flat_e, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)                 # unsort permutation
    se = torch.gather(flat_e, -1, order)
    st = torch.gather(flat_t, -1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, se, torch.ones_like(se))
    starts = torch.cat([torch.zeros((G, 1), dtype=counts.dtype, device=dev),
                        torch.cumsum(counts, dim=-1)[:, :-1]], dim=-1)
    rank = torch.arange(N, device=dev)[None, :] - torch.gather(starts, -1, se)
    keep = rank < C                                                 # (G, N) token kept

    # dispatch: buf[g, e, c] = sorted row at starts[e]+c (valid if c < counts)
    slots_c = torch.arange(C, device=dev)[None, None, :]
    src = (starts[:, :, None] + slots_c).clamp(0, N - 1).reshape(G, E * C)
    valid = slots_c < counts[:, :, None]
    tok_of_slot = torch.gather(st, -1, src)                         # (G, E*C)
    h = torch.gather(xt, 1, tok_of_slot[..., None].expand(G, E * C, d))
    h = (h * valid.reshape(G, E * C, 1).to(x.dtype)).reshape(G, E, C, d)

    act = F.silu(torch.einsum("gecd,edf->gecf", h, p["wg"])) * torch.einsum(
        "gecd,edf->gecf", h, p["wu"])
    y = torch.einsum("gecf,efd->gecd", act, p["wd"]).reshape(G, E * C, d)

    # combine: sorted row n lives at slot se*C+rank (if kept) -> unsort ->
    # (Tl, K) rows per token -> weighted sum
    slot = (se * C + rank).clamp(0, E * C - 1)
    y_sorted = torch.gather(y, 1, slot[..., None].expand(G, N, d))
    y_sorted = y_sorted * keep[..., None].to(y.dtype)
    y_tok = torch.gather(y_sorted, 1, inv[..., None].expand(G, N, d))  # token-major
    out = (y_tok * flat_w[..., None]).reshape(G, Tl, K, d).sum(dim=2)
    return out.reshape(B, S, d), aux.float()


__all__ = ["NO_DROP_ASSIGNMENTS", "capacity", "moe_apply", "moe_init"]
