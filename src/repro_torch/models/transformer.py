"""Pattern-aware layer stack: periods stacked on a leading axis.

PyTorch counterpart of :mod:`repro.models.transformer`.  Layers are grouped
into the config's repeating ``pattern`` (e.g. gemma3's 5 local + 1 global,
zamba2's 6 mamba + 1 shared attention, xlstm's 7 mLSTM + 1 sLSTM).
Parameters of full repetitions are stacked with a leading ``n_periods``
axis, as the reference stacks them for its ``lax.scan``, so every parameter
has the reference's shape; the port walks the periods in a Python loop.
Leftover layers are kept per layer (``tail``).  Caches mirror the same
structure.  zamba2's ``shared_attn`` slots share one weight set
(``params["shared"]``) while each invocation keeps its own KV cache.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.models import mamba2, moe as moe_mod, xlstm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    Params,
    attention_apply,
    attn_init,
    constrain_batch,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)

#: mixers that own a (B, S, Kv, hd) KV cache
ATTN_MIXERS = ("attn", "local", "shared_attn")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec, dtype: torch.dtype,
               device: torch.device) -> Params:
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, dtype, device)}
    if spec.mixer in ("attn", "local"):
        p["attn"] = attn_init(gen, cfg, dtype, device)
    elif spec.mixer == "mamba":
        p["mamba"] = mamba2.mamba_init(gen, cfg, dtype, device)
    elif spec.mixer == "mlstm":
        p["mlstm"] = xlstm.mlstm_init(gen, cfg, dtype, device)
    elif spec.mixer == "slstm":
        p["slstm"] = xlstm.slstm_init(gen, cfg, dtype, device)
    # shared_attn: the weights live in params["shared"]
    if spec.ffn == "mlp":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    elif spec.ffn == "moe":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
    return p


def shared_block_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                      device: torch.device) -> Params:
    """zamba2's one attention + MLP block, run at every ``shared_attn`` slot."""
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    if spec.mixer in ATTN_MIXERS:
        length = min(max_len, cfg.window) if spec.mixer == "local" else max_len
        shape = (batch, length, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if spec.mixer == "mamba":
        return mamba2.mamba_cache_init(cfg, batch, dtype, device)
    if spec.mixer == "mlstm":
        return xlstm.mlstm_cache_init(cfg, batch, device)
    if spec.mixer == "slstm":
        return xlstm.slstm_cache_init(cfg, batch, device)
    raise ValueError(spec.mixer)


def layer_apply(
    p: Params,
    shared: Params | None,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    prefix_len: int = 0,
    cache: Params | None = None,
    cache_pos: torch.Tensor | int | None = None,
    mode: str = "train",
) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Returns (x, new_cache, aux_loss); aux is the MoE ffn's, else 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    decode = mode == "decode"
    if spec.mixer == "shared_attn":
        h = rmsnorm(shared["norm1"], x, cfg.norm_eps)
        attn_out, new_cache = attention_apply(shared["attn"], cfg, h, positions, cache=cache,
                                              cache_pos=cache_pos, prefix_len=prefix_len)
        x = x + attn_out
        h = rmsnorm(shared["norm2"], x, cfg.norm_eps)
        return x + mlp_apply(shared["mlp"], h), new_cache, aux

    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.mixer in ("attn", "local"):
        window = cfg.window if spec.mixer == "local" else 0
        out, new_cache = attention_apply(p["attn"], cfg, h, positions, window=window,
                                         prefix_len=prefix_len, cache=cache, cache_pos=cache_pos)
    elif spec.mixer == "mamba":
        out, new_cache = mamba2.mamba_apply(p["mamba"], cfg, h, cache=cache, decode=decode)
    elif spec.mixer == "mlstm":
        out, new_cache = xlstm.mlstm_apply(p["mlstm"], cfg, h, cache=cache, decode=decode)
    elif spec.mixer == "slstm":
        out, new_cache = xlstm.slstm_apply(p["slstm"], cfg, h, cache=cache, decode=decode)
    else:
        raise ValueError(spec.mixer)
    x = x + out
    if spec.ffn == "mlp":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    elif spec.ffn == "moe":
        out, aux = moe_mod.moe_apply(p["moe"], cfg, rmsnorm(p["norm2"], x, cfg.norm_eps))
        x = x + out
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# full stack
# ---------------------------------------------------------------------------

def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    p: Params = {}
    if any(s.mixer == "shared_attn" for s in cfg.pattern):
        p["shared"] = shared_block_init(gen, cfg, dtype, device)
    if cfg.n_periods:
        p["periods"] = {
            f"slot{si}": tree_map(lambda *xs: torch.stack(xs),
                                  *[layer_init(gen, cfg, spec, dtype, device)
                                    for _ in range(cfg.n_periods)])
            for si, spec in enumerate(cfg.pattern)
        }
    p["tail"] = [layer_init(gen, cfg, spec, dtype, device) for spec in cfg.tail_layers]
    return p


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    c: Params = {}
    if cfg.n_periods:
        c["periods"] = {
            f"slot{si}": tree_map(
                lambda x: x.expand(cfg.n_periods, *x.shape).clone(),
                layer_cache_init(cfg, spec, batch, max_len, dtype, device))
            for si, spec in enumerate(cfg.pattern)
        }
    c["tail"] = [layer_cache_init(cfg, spec, batch, max_len, dtype, device)
                 for spec in cfg.tail_layers]
    return c


def stack_apply(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    prefix_len: int = 0,
    cache: Params | None = None,
    cache_pos: torch.Tensor | int | None = None,
    mode: str = "train",
) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Returns (x, new_cache, aux_sum): the aux losses summed over layers."""
    shared = p.get("shared")
    has_cache = cache is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Params = {}
    if cfg.n_periods:
        period_caches = []
        for i in range(cfg.n_periods):
            x = constrain_batch(x, cfg)
            new_period = {}
            for si, spec in enumerate(cfg.pattern):
                lp = tree_map(lambda t: t[i], p["periods"][f"slot{si}"])
                lc = tree_map(lambda t: t[i], cache["periods"][f"slot{si}"]) if has_cache else None
                x, nc, a = layer_apply(lp, shared, cfg, spec, x, positions,
                                       prefix_len=prefix_len, cache=lc, cache_pos=cache_pos,
                                       mode=mode)
                new_period[f"slot{si}"] = nc
                aux = aux + a
            period_caches.append(new_period)
        if has_cache:
            new_cache["periods"] = tree_map(lambda *xs: torch.stack(xs), *period_caches)
    if has_cache:
        new_cache["tail"] = []
    for i, spec in enumerate(cfg.tail_layers):
        lc = cache["tail"][i] if has_cache else None
        x, nc, a = layer_apply(p["tail"][i], shared, cfg, spec, x, positions,
                               prefix_len=prefix_len, cache=lc, cache_pos=cache_pos, mode=mode)
        aux = aux + a
        if has_cache:
            new_cache["tail"].append(nc)
    return x, (new_cache if has_cache else None), aux
