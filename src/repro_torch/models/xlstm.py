"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, a time loop), the 7:1 pattern of xlstm-1.3b.

PyTorch counterpart of :mod:`repro.models.xlstm`, op for op.

mLSTM (stabiliser-free; the gates are sigmoid-bounded so the chunked form
stays finite in float32):
  C_t = f_t C_{t-1} + i_t v_t k_t^T      (C: dk x dv matrix memory per head)
  n_t = f_t n_{t-1} + i_t k_t
  h_t = (C_t^T q_t) / max(|n_t^T q_t|, 1)

Chunked like SSD: an intra-chunk decay matrix from the cumulative log f,
the (C, n) state carried across chunks (a Python loop where the reference
scans).  Decode is the O(1) recurrence.  The masked entries of the decay
matrix are ``exp`` of a positive sum before the mask zeroes them, exactly
as in the reference: past about 88 in float32 they overflow, which leaves
the forward finite and the gradient NaN (``ROADMAP.md`` §3).

sLSTM: a per-head scalar cell with a block-diagonal recurrent R, computed
one time step after another; its FFN uses the tanh-approximated GELU, the
default of ``jax.nn.gelu``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init, rmsnorm, rmsnorm_init


def _maximum(x: torch.Tensor, floor: float) -> torch.Tensor:
    """``jnp.maximum(x, floor)``: at a tie the gradient is split in half, as
    JAX splits it (``clamp_min`` would pass all of it)."""
    return torch.maximum(x, torch.tensor(floor, dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d = cfg.d_model
    d_in = 2 * d
    return {
        "up": dense_init(gen, (d, 2 * d_in), dtype, device),         # -> (x, z gate)
        "wq": dense_init(gen, (d_in, d_in), dtype, device),
        "wk": dense_init(gen, (d_in, d_in), dtype, device),
        "wv": dense_init(gen, (d_in, d_in), dtype, device),
        "wif": dense_init(gen, (d_in, 2 * cfg.n_heads), torch.float32, device),
        "norm": rmsnorm_init(d_in, dtype, device),
        "down": dense_init(gen, (d_in, d), dtype, device),
    }


def _mlstm_qkv(p: Params, cfg: ModelConfig, u: torch.Tensor):
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    hd = d_in // H
    up = torch.einsum("bsd,de->bse", u, p["up"])
    x, z = up[..., :d_in], up[..., d_in:]
    B, S = x.shape[:2]
    q = torch.einsum("bse,ef->bsf", x, p["wq"]).reshape(B, S, H, hd)
    # the reference divides by jnp.sqrt(hd), a float32 scalar taken in x's dtype
    k = torch.einsum("bse,ef->bsf", x, p["wk"]).reshape(B, S, H, hd) / torch.tensor(
        np.sqrt(np.float32(hd)), dtype=torch.float32).to(x.dtype).to(x.device)
    v = torch.einsum("bse,ef->bsf", x, p["wv"]).reshape(B, S, H, hd)
    gates = torch.einsum("bse,eg->bsg", x.float(), p["wif"])
    i_g = torch.sigmoid(gates[..., :H])                              # (B,S,H)
    logf = F.logsigmoid(gates[..., H:])                              # (B,S,H)
    return x, z, q, k, v, i_g, logf


def mlstm_apply(
    p: Params, cfg: ModelConfig, u: torch.Tensor, *,
    cache: Params | None = None, decode: bool = False, chunk: int = 128,
) -> tuple[torch.Tensor, Params | None]:
    B, S, d = u.shape
    d_in, H = 2 * d, cfg.n_heads
    hd = d_in // H
    x, z, q, k, v, i_g, logf = _mlstm_qkv(p, cfg, u)
    qf, kf, vf = q.float(), k.float(), v.float()

    if decode:  # S == 1; q/k/v[:, 0] are (B, H, hd)
        f = torch.exp(logf[:, 0])[:, :, None, None]                  # (B,H,1,1)
        C = cache["C"] * f + i_g[:, 0][:, :, None, None] * torch.einsum(
            "bhk,bhv->bhkv", kf[:, 0], vf[:, 0])
        n = cache["n"] * f[..., 0] + i_g[:, 0][:, :, None] * kf[:, 0]
        qh = qf[:, 0]
        num = torch.einsum("bhkv,bhk->bhv", C, qh)
        den = _maximum(torch.einsum("bhk,bhk->bh", n, qh).abs(), 1.0)
        h = (num / den[:, :, None]).reshape(B, 1, d_in).to(u.dtype)
        out = rmsnorm(p["norm"], h * F.silu(z), cfg.norm_eps)
        return torch.einsum("bse,ed->bsd", out, p["down"]), {"C": C, "n": n}

    l = min(chunk, S)
    if S % l:
        l = S
    c = S // l
    qc = qf.reshape(B, c, l, H, hd)
    kc = kf.reshape(B, c, l, H, hd)
    vc = vf.reshape(B, c, l, H, hd)
    ic = i_g.reshape(B, c, l, H)
    lfc = logf.reshape(B, c, l, H)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=u.device))[None, :, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=u.device)

    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=u.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=u.device)
    hs = []
    for i in range(c):
        qb, kb, vb, ib, lfb = qc[:, i], kc[:, i], vc[:, i], ic[:, i], lfc[:, i]
        cum = torch.cumsum(lfb, dim=1)                                # (B,l,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]                 # (B,l,l,H) decay j->i
        # cum_i - cum_j = sum_{j<s<=i} log f_s: injection at j decays from
        # j+1 onward, scaled by i_j; exp before the mask, as the reference
        decay = torch.where(tri, torch.exp(seg), zero) * ib[:, None, :, :]
        scores = torch.einsum("blhk,bmhk->blmh", qb, kb) * decay
        num_intra = torch.einsum("blmh,bmhv->blhv", scores, vb)
        den_intra = torch.einsum("blmh,bmhk,blhk->blh", decay, kb, qb)
        dec_out = torch.exp(cum)                                      # (B,l,H)
        num_inter = torch.einsum("blhk,bhkv,blh->blhv", qb, C, dec_out)
        den_inter = torch.einsum("blhk,bhk,blh->blh", qb, n, dec_out)
        num = num_intra + num_inter
        den = _maximum((den_intra + den_inter).abs(), 1.0)
        hs.append(num / den[..., None])
        total = torch.exp(cum[:, -1])                                 # (B,H)
        dec_in = torch.exp(cum[:, -1:, :] - cum) * ib                 # (B,l,H)
        C = C * total[:, :, None, None] + torch.einsum("blhk,blhv,blh->bhkv", kb, vb, dec_in)
        n = n * total[:, :, None] + torch.einsum("blhk,blh->bhk", kb, dec_in)
    h = torch.stack(hs, dim=1).reshape(B, S, d_in).to(u.dtype)
    out = rmsnorm(p["norm"], h * F.silu(z), cfg.norm_eps)
    new_cache = {"C": C, "n": n} if cache is not None else None
    return torch.einsum("bse,ed->bsd", out, p["down"]), new_cache


def mlstm_cache_init(cfg: ModelConfig, batch: int, device: torch.device) -> Params:
    d_in, H = 2 * cfg.d_model, cfg.n_heads
    hd = d_in // H
    return {"C": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_ff(d: int) -> int:
    """The sLSTM block's FFN width: 4/3 of ``d`` cut to a multiple of 128."""
    return int(d * 4 / 3) // 128 * 128 or d


def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    ff = slstm_ff(d)
    r = torch.randn((H, hd, 4 * hd), generator=gen, device=gen.device, dtype=torch.float32)
    return {
        "w": dense_init(gen, (d, 4 * d), torch.float32, device),    # i,f,z,o pre-acts
        "r": (r / np.sqrt(np.float32(hd))).to(device),
        "norm": rmsnorm_init(d, dtype, device),
        "up": dense_init(gen, (d, ff), dtype, device),
        "down": dense_init(gen, (ff, d), dtype, device),
    }


def slstm_apply(
    p: Params, cfg: ModelConfig, u: torch.Tensor, *,
    cache: Params | None = None, decode: bool = False,
) -> tuple[torch.Tensor, Params | None]:
    B, S, d = u.shape
    H = cfg.n_heads
    hd = d // H
    wx = torch.einsum("bsd,de->bse", u.float(), p["w"]).reshape(B, S, H, 4 * hd)

    if cache is not None and decode:
        h, c, n = cache["h"], cache["c"], cache["n"]
    else:
        h = c = n = torch.zeros((B, H, hd), dtype=torch.float32, device=u.device)
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    hs = []
    for t in range(S):
        g = wx[:, t] + torch.einsum("bhk,hkg->bhg", h, p["r"])
        i_g = torch.exp(torch.minimum(g[..., :hd], zero))
        f_g = torch.sigmoid(g[..., hd:2 * hd])
        z_g = torch.tanh(g[..., 2 * hd:3 * hd])
        o_g = torch.sigmoid(g[..., 3 * hd:])
        c = f_g * c + i_g * z_g
        n = f_g * n + i_g
        h = o_g * c / _maximum(n, 1.0)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(u.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    y = torch.einsum("bsf,fd->bsd",
                     F.gelu(torch.einsum("bsd,df->bsf", y, p["up"]), approximate="tanh"),
                     p["down"])
    new_cache = {"h": h, "c": c, "n": n} if cache is not None else None
    return y, new_cache


def slstm_cache_init(cfg: ModelConfig, batch: int, device: torch.device) -> Params:
    H = cfg.n_heads
    hd = cfg.d_model // H
    return {k: torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
            for k in ("h", "c", "n")}


__all__ = ["mlstm_apply", "mlstm_cache_init", "mlstm_init", "slstm_apply",
           "slstm_cache_init", "slstm_ff", "slstm_init"]
