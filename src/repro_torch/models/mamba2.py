"""Mamba2 (SSD) mixer: chunked linear recurrence (train / prefill) and the
O(1) state step (decode).  Used by the zamba2-7b hybrid backbone.

PyTorch counterpart of :mod:`repro.models.mamba2`, op for op: a depthwise
conv over (x, B, C), a scalar decay A per head, an (N x P) state per head,
and the chunked scan

  intra-chunk:  Y  = (L o C B^T) X          (L = exp(segsum(dtA)), causal)
  chunk state:  S_c = sum_t exp(cum_end - cum_t) B_t X_t^T
  inter-chunk:  the carried state, a Python loop over chunks where the
                reference scans.

The state is float32; the conv tail is in the model's dtype.  Prefill
starts the conv and the state from zero, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init, rmsnorm, rmsnorm_init

HEAD_P = 64  # SSD head dim


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_in = 2 * cfg.d_model
    H = d_in // HEAD_P
    N = cfg.ssm_state
    conv_ch = d_in + 2 * N  # conv over (x, B, C), groups G=1
    return d_in, H, N, conv_ch


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d = cfg.d_model
    d_in, H, N, conv_ch = _dims(cfg)
    conv = torch.randn((cfg.conv_width, conv_ch), generator=gen, device=gen.device,
                       dtype=torch.float32)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * N + H), dtype, device),
        "conv_w": (conv * 0.1).to(device=device, dtype=dtype),
        "A_log": a_log.to(device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(d_in, dtype, device),
        "out_proj": dense_init(gen, (d_in, d), dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + e^x)`` as ``logaddexp(x, 0)`` everywhere
    (torch's ``softplus`` is the identity above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split(p: Params, cfg: ModelConfig, u: torch.Tensor):
    """in_proj -> z, xBC (pre-conv), dt."""
    d_in, H, N, conv_ch = _dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", u, p["in_proj"])
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_ch]
    dt = softplus(zxbcdt[..., -H:].float() + p["dt_bias"])
    return z, xbc, dt


def _conv(p: Params, cfg: ModelConfig, xbc: torch.Tensor,
          conv_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width w; returns (out, new_conv_state)."""
    w = cfg.conv_width
    if conv_state is None:
        pad = F.pad(xbc, (0, 0, w - 1, 0))
    else:
        pad = torch.cat([conv_state, xbc], dim=1)
    S = xbc.shape[1]
    out = pad[:, 0:S] * p["conv_w"][0][None, None, :]
    for i in range(1, w):
        out = out + pad[:, i:i + S] * p["conv_w"][i][None, None, :]
    return F.silu(out), pad[:, -(w - 1):]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) -> (..., l, l) with out[..., i, j] = sum_{j<t<=i} a_t, and
    -inf above the diagonal."""
    l = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(tri, seg, torch.tensor(-np.inf, dtype=seg.dtype, device=a.device))


def mamba_apply(
    p: Params,
    cfg: ModelConfig,
    u: torch.Tensor,                 # (B, S, d)
    *,
    cache: Params | None = None,     # {"state": (B,H,N,P), "conv": (B,w-1,ch)}
    decode: bool = False,
    chunk: int = 128,
) -> tuple[torch.Tensor, Params | None]:
    d_in, H, N, conv_ch = _dims(cfg)
    B_, S, _ = u.shape
    A = -torch.exp(p["A_log"])  # (H,) negative decay rates

    z, xbc, dt = _split(p, cfg, u)

    if decode:
        xbc, new_conv = _conv(p, cfg, xbc, cache["conv"])
        x = xbc[..., :d_in].reshape(B_, S, H, HEAD_P)
        Bc = xbc[..., d_in:d_in + N]
        Cc = xbc[..., d_in + N:]
        # one-step recurrence (S == 1)
        dtA = dt[:, 0] * A[None, :]                                    # (B,H)
        decay = torch.exp(dtA)[:, :, None, None]
        inject = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], Bc[:, 0].float(), x[:, 0].float())
        state = cache["state"] * decay + inject
        y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), state)
        y = y + p["D"][None, :, None] * x[:, 0].float()
        y = y.reshape(B_, 1, d_in).to(u.dtype)
        out = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
        return torch.einsum("bse,ed->bsd", out, p["out_proj"]), {"state": state, "conv": new_conv}

    xbc, conv_tail = _conv(p, cfg, xbc, None)
    x = xbc[..., :d_in].reshape(B_, S, H, HEAD_P)
    Bc = xbc[..., d_in:d_in + N].float()
    Cc = xbc[..., d_in + N:].float()

    l = min(chunk, S)
    if S % l:
        l = S  # fall back to a single chunk for odd shapes, as the reference does
    c = S // l
    xc = x.reshape(B_, c, l, H, HEAD_P).float()
    bc = Bc.reshape(B_, c, l, N)
    cc = Cc.reshape(B_, c, l, N)
    dtc = dt.reshape(B_, c, l, H)
    dtA = dtc * A[None, None, None, :]                                 # (B,c,l,H)

    # prefill starts from a zero state, as the reference does
    state = torch.zeros((B_, H, N, HEAD_P), dtype=torch.float32, device=u.device)
    ys = []
    for i in range(c):
        xcb, bcb, ccb, dtab, dtb = xc[:, i], bc[:, i], cc[:, i], dtA[:, i], dtc[:, i]
        cum = torch.cumsum(dtab, dim=1)                                # (B,l,H)
        L = torch.exp(_segsum(dtab.transpose(1, 2)))                   # (B,H,l,l)
        scores = torch.einsum("bln,bmn->blm", ccb, bcb)[:, None] * L   # (B,H,l,l)
        y_intra = torch.einsum("bhlm,bmh,bmhp->blhp", scores, dtb, xcb)
        decay_out = torch.exp(cum)                                     # (B,l,H)
        y_inter = torch.einsum("bln,blh,bhnp->blhp", ccb, decay_out, state)
        total = torch.exp(cum[:, -1])                                  # (B,H)
        decay_in = torch.exp(cum[:, -1:, :] - cum)                     # (B,l,H)
        s_new = torch.einsum("bln,blh,blh,blhp->bhnp", bcb, decay_in, dtb, xcb)
        state = state * total[:, :, None, None] + s_new
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, S, H, HEAD_P)
    y = y + p["D"][None, None, :, None] * x.float()
    y = y.reshape(B_, S, d_in).to(u.dtype)
    out = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    new_cache = None
    if cache is not None:  # prefill fills the recurrent cache
        new_cache = {"state": state, "conv": conv_tail}
    return torch.einsum("bse,ed->bsd", out, p["out_proj"]), new_cache


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    d_in, H, N, conv_ch = _dims(cfg)
    return {
        "state": torch.zeros((batch, H, N, HEAD_P), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
    }


__all__ = ["HEAD_P", "mamba_apply", "mamba_cache_init", "mamba_init", "softplus"]
