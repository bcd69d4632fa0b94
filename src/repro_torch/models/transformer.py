"""Pattern-aware layer stack: periods stacked on a leading axis.

PyTorch counterpart of :mod:`repro.models.transformer` for the dense family
(``attn`` and ``local`` mixers, ``mlp`` or no ffn).  Layers are grouped into
the config's repeating ``pattern`` (e.g. gemma3's 5 local + 1 global).
Parameters of full repetitions are stacked with a leading ``n_periods`` axis,
as the reference stacks them for its ``lax.scan``, so every parameter has
the reference's shape; the port walks the periods in a Python loop.
Leftover layers are kept per layer (``tail``).  KV caches mirror the same
structure.  The other mixers (mamba, mLSTM, sLSTM, zamba2's shared
attention) and the MoE ffn are ``ROADMAP.md`` §1 item 12 and raise.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map
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

ATTN_MIXERS = ("attn", "local")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md §1 item 12); the port "
        "builds the dense family (attn/local mixers, mlp ffn)")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in ATTN_MIXERS:
        raise _not_ported(f"mixer {spec.mixer!r}")
    if spec.ffn not in ("mlp", "none"):
        raise _not_ported(f"ffn {spec.ffn!r}")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec, dtype: torch.dtype,
               device: torch.device) -> Params:
    _check_spec(spec)
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, dtype, device),
                 "attn": attn_init(gen, cfg, dtype, device)}
    if spec.ffn == "mlp":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    _check_spec(spec)
    length = min(max_len, cfg.window) if spec.mixer == "local" else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def layer_apply(
    p: Params,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    prefix_len: int = 0,
    cache: Params | None = None,
    cache_pos: torch.Tensor | int | None = None,
) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Returns (x, new_cache, aux_loss); the dense family's aux is 0."""
    _check_spec(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    window = cfg.window if spec.mixer == "local" else 0
    out, new_cache = attention_apply(p["attn"], cfg, h, positions, window=window,
                                     prefix_len=prefix_len, cache=cache, cache_pos=cache_pos)
    x = x + out
    if spec.ffn == "mlp":
        x = x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# full stack
# ---------------------------------------------------------------------------

def stack_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    p: Params = {}
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
) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Returns (x, new_cache, aux_sum)."""
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
                x, nc, a = layer_apply(lp, cfg, spec, x, positions, prefix_len=prefix_len,
                                       cache=lc, cache_pos=cache_pos)
                new_period[f"slot{si}"] = nc
                aux = aux + a
            period_caches.append(new_period)
        if has_cache:
            new_cache["periods"] = tree_map(lambda *xs: torch.stack(xs), *period_caches)
    if has_cache:
        new_cache["tail"] = []
    for i, spec in enumerate(cfg.tail_layers):
        lc = cache["tail"][i] if has_cache else None
        x, nc, a = layer_apply(p["tail"][i], cfg, spec, x, positions, prefix_len=prefix_len,
                               cache=lc, cache_pos=cache_pos)
        aux = aux + a
        if has_cache:
            new_cache["tail"].append(nc)
    return x, (new_cache if has_cache else None), aux
