"""Fake-tensor stand-ins for every model input: the dry-run's inputs.

PyTorch counterpart of :mod:`repro.launch.specs`.  The reference builds its
trees with ``jax.eval_shape`` over the real init functions; here the port's
own :meth:`Model.init`, :func:`repro_torch.optim.adamw.init_state` and
:meth:`Model.init_cache` run under one shared ``FakeTensorMode``, so the
dry-run sees exactly the shapes and dtypes the runtime would and nothing is
allocated.  Every function returns fake tensors of :func:`fake_mode`; run
anything that consumes them inside ``with fake_mode():``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.models.api import Model, build_model
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw

I32 = torch.int32


@functools.lru_cache(maxsize=1)
def fake_mode():
    """The one ``FakeTensorMode`` every spec is made under (fake tensors of
    two modes cannot meet in one op)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def sds(shape: tuple[int, ...], dtype: torch.dtype, device: Any = "cpu") -> torch.Tensor:
    """A fake tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``)."""
    with fake_mode():
        return torch.empty(shape, dtype=dtype, device=device)


def train_batch_specs(cfg: ModelConfig, sc: ShapeConfig, device: Any = "cpu") -> dict:
    B, S = sc.global_batch, sc.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        return {
            "frame_embeds": sds((B, S, cfg.d_model), dt, device),
            "targets": sds((B, S, cfg.n_codebooks), I32, device),
        }
    if cfg.family == "vlm":
        return {
            "patch_embeds": sds((B, cfg.n_patches, cfg.d_model), dt, device),
            "tokens": sds((B, S - cfg.n_patches), I32, device),
        }
    return {"tokens": sds((B, S), I32, device)}


def prefill_batch_specs(cfg: ModelConfig, sc: ShapeConfig, device: Any = "cpu") -> dict:
    b = train_batch_specs(cfg, sc, device)
    b.pop("targets", None)
    return b


def decode_step_specs(cfg: ModelConfig, sc: ShapeConfig, device: Any = "cpu") -> dict:
    B = sc.global_batch
    if cfg.family == "audio":
        return {"frame_embeds": sds((B, 1, cfg.d_model), getattr(torch, cfg.dtype), device)}
    return {"tokens": sds((B, 1), I32, device)}


def params_specs(model: Model) -> Any:
    """The model's parameter tree, drawn under the fake mode and registered
    on ``model``."""
    with fake_mode():
        return model.init(torch.Generator(device=model.device).manual_seed(0))


def opt_state_specs(params: Any) -> dict:
    with fake_mode():
        return adamw.init_state(params)


def cache_specs(model: Model, batch: int, max_len: int) -> Any:
    with fake_mode():
        return model.init_cache(batch, max_len)


def input_specs(cfg: ModelConfig, sc: ShapeConfig, device: Any = "cpu",
                model: Model | None = None) -> dict:
    """The full input tree for the cell's step function (``model``, if given,
    is the one whose parameters are drawn)."""
    model = model if model is not None else build_model(cfg, device)
    p = params_specs(model)
    if sc.kind == "train":
        return {"params": p, "opt_state": opt_state_specs(p),
                "batch": train_batch_specs(cfg, sc, model.device)}
    if sc.kind == "prefill":
        return {"params": p, "batch": prefill_batch_specs(cfg, sc, model.device),
                "cache": cache_specs(model, sc.global_batch, sc.seq_len)}
    return {"params": p, "step_in": decode_step_specs(cfg, sc, model.device),
            "cache": cache_specs(model, sc.global_batch, sc.seq_len),
            "pos": sds((), I32, model.device)}


__all__ = ["cache_specs", "decode_step_specs", "fake_mode", "input_specs", "opt_state_specs",
           "params_specs", "prefill_batch_specs", "sds", "train_batch_specs"]
