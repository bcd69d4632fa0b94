"""Shared layer primitives: RMSNorm, RoPE, GQA attention (global / sliding
window / prefix-LM, train+prefill+decode), SwiGLU MLP.

PyTorch counterpart of :mod:`repro.models.layers`: functions over parameter
trees (plain dicts of tensors), each the reference's arithmetic op for op in
the same dtypes.  Attention is query-chunked (a Python loop where the
reference scans) so the live score tensor is ``(B, q_chunk, S)`` rather than
``(B, S, S)``.  The projections and the attention are plain ``einsum``s: the
reference computes them outside any Pallas kernel too.

Initialisation draws from an explicit ``torch.Generator`` (the reference
draws from ``jax.random``), so the two packages' freshly initialised weights
differ draw for draw by design; parity is held on weights carried across
(:func:`repro_torch.interop.params_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

Params = dict

#: score of a masked key, as the reference writes it
MASKED = -1e30


def constrain_batch(x: torch.Tensor, cfg: ModelConfig, *extra: object) -> torch.Tensor:
    """The reference pins the batch dim to its data-parallel mesh axes here.
    The port runs a model on one device, so this is a no-op that returns
    ``x``; it marks the places where a multi-device port would shard."""
    return x


def dense_init(gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
               device: torch.device, in_axis: int = 0) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), drawn in float32 on the generator's device."""
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w / np.sqrt(np.float32(shape[in_axis]))).to(device=device, dtype=dtype)


def rmsnorm_init(d: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["scale"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32, device=x.device))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      * (log_theta / half))
    if positions.ndim == 1:
        ang = positions[None, :, None].float() * freqs[None, None, :]
    else:
        ang = positions[:, :, None].float() * freqs[None, None, :]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              device: torch.device) -> Params:
    d, hd = cfg.d_model, cfg.head_dim_
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype, device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype, device),
    }


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, window: int,
          prefix_len: int) -> torch.Tensor:
    """(Sq, Sk) bool; causal, optionally sliding-window / prefix-LM."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window:
        causal &= (q_pos[:, None] - k_pos[None, :]) < window
    if prefix_len:
        causal |= k_pos[None, :] < prefix_len
    return causal


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          scale: float) -> torch.Tensor:
    """q: (B,Sq,H,hd) k/v: (B,Sk,Kv,hd) mask: (Sq,Sk) or (B,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    q = q.reshape(B, Sq, Kv, H // Kv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    logits = torch.where(mask, logits, torch.tensor(MASKED, dtype=torch.float32,
                                                    device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, H * hd)


def _inv_sqrt(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded in float32, as the reference forms its scale."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _write_rows(buf: torch.Tensor, x: torch.Tensor, start: torch.Tensor | int) -> torch.Tensor:
    """A copy of ``buf`` (B, W, ...) with ``x`` (B, S, ...) written along axis
    1 at ``start`` (a scalar, or one start a row), each start clamped into
    ``[0, W - S]`` as ``lax.dynamic_update_slice`` clamps it."""
    B, S = x.shape[:2]
    W = buf.shape[1]
    out = buf.clone()
    if not isinstance(start, torch.Tensor) or start.ndim == 0:
        s = min(max(int(start), 0), W - S)
        out[:, s:s + S] = x
        return out
    rows = torch.arange(B, device=buf.device)
    s = start.long().clamp(0, W - S)
    for j in range(S):
        out[rows, s + j] = x[:, j]
    return out


def attention_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, S, d)
    positions: torch.Tensor,             # (S,) or (B, S) int32 absolute positions
    *,
    window: int = 0,
    prefix_len: int = 0,
    cache: Params | None = None,         # {"k","v"}: (B, S_cache, Kv, hd)
    cache_pos: torch.Tensor | int | None = None,   # next write slot: scalar or (B,)
) -> tuple[torch.Tensor, Params | None]:
    """Returns (out (B,S,d), updated cache or None).

    Modes: train (no cache), prefill (cache written at [0,S)), decode
    (S==1 appended at cache_pos; sliding-window caches are ring buffers).
    RoPE is applied before caching so cached keys are position-absolute.
    The cache is never written in place: the update is a new tree, so a
    caller can merge old and new rows (:meth:`Model.merge_cache_rows`).
    """
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = rope(torch.einsum("bsd,dh->bsh", x, p["wq"]).reshape(B, S, H, hd), positions,
             cfg.rope_theta)
    k = rope(torch.einsum("bsd,dh->bsh", x, p["wk"]).reshape(B, S, Kv, hd), positions,
             cfg.rope_theta)
    v = torch.einsum("bsd,dh->bsh", x, p["wv"]).reshape(B, S, Kv, hd)
    scale = _inv_sqrt(hd)

    if cache is None or cache_pos is None:
        # train / stateless forward: query chunks over the sequence
        n_chunks = max(1, S // cfg.q_chunk) if S % cfg.q_chunk == 0 else 1
        if n_chunks > 1:
            c = S // n_chunks
            out = torch.cat([
                _sdpa(q[:, i * c:(i + 1) * c], k, v,
                      _mask(positions[i * c:(i + 1) * c], positions, window=window,
                            prefix_len=prefix_len), scale)
                for i in range(n_chunks)], dim=1)
        else:
            m = _mask(positions, positions, window=window, prefix_len=prefix_len)
            out = _sdpa(q, k, v, m, scale)
        new_cache = None
        if cache is not None:
            W = cache["k"].shape[1]
            if W >= S:
                new_cache = {"k": _write_rows(cache["k"], k, 0),
                             "v": _write_rows(cache["v"], v, 0)}
            else:
                # sliding-window ring buffer: position p lives at slot p % W,
                # so the kept tail (positions S-W..S-1) is a cyclic shift
                new_cache = {"k": torch.roll(k[:, -W:], S % W, dims=1),
                             "v": torch.roll(v[:, -W:], S % W, dims=1)}
        return torch.einsum("bsh,hd->bsd", out, p["wo"]), new_cache

    # decode: append one step, attend to the cache.  ``cache_pos`` is a
    # scalar (all rows at one shared position) or a (B,) vector of per-slot
    # positions — a continuous-batching engine admits new sequences into
    # free slots while others decode, so every row owns its position.
    W = cache["k"].shape[1]
    slots = torch.arange(W, dtype=torch.int64, device=x.device)
    if not isinstance(cache_pos, torch.Tensor) or cache_pos.ndim == 0:
        cp = int(cache_pos)
        slot = cp % W if window else cp
        ck, cv = _write_rows(cache["k"], k, slot), _write_rows(cache["v"], v, slot)
        if window:
            valid = (cp - ((cp - slots) % W)) >= 0                  # (W,)
        else:
            valid = slots <= cp
        vmask = valid[None, None, None, None, :]
    else:
        cp = cache_pos.to(device=x.device, dtype=torch.int64)     # (B,)
        slot = cp % W if window else cp
        ck, cv = _write_rows(cache["k"], k, slot), _write_rows(cache["v"], v, slot)
        if window:
            valid = (cp[:, None] - ((cp[:, None] - slots[None, :]) % W)) >= 0   # (B, W)
        else:
            valid = slots[None, :] <= cp[:, None]
        vmask = valid[:, None, None, None, :]
    # float32 attention over the cache, as the reference computes it
    logits = torch.einsum("bskgh,btkh->bkgst",
                          q.reshape(B, S, Kv, H // Kv, hd).float(), ck.float()) * scale
    logits = torch.where(vmask, logits, torch.tensor(MASKED, dtype=torch.float32,
                                                     device=x.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, cv.float())
    out = out.reshape(B, S, H * hd).to(x.dtype)
    return torch.einsum("bsh,hd->bsd", out, p["wo"]), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
             device: torch.device) -> Params:
    return {
        "wg": dense_init(gen, (d, d_ff), dtype, device),
        "wu": dense_init(gen, (d, d_ff), dtype, device),
        "wd": dense_init(gen, (d_ff, d), dtype, device),
    }


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = (torch.nn.functional.silu(torch.einsum("bsd,df->bsf", x, p["wg"]))
         * torch.einsum("bsd,df->bsf", x, p["wu"]))
    return torch.einsum("bsf,fd->bsd", h, p["wd"])
