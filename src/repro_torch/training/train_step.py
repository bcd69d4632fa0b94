"""The train step: loss -> gradients -> clipped AdamW update.

PyTorch counterpart of ``src/repro/training/train_step.py``, eager (no
``torch.compile``).  The model's loss runs through the port's
:class:`~repro_torch.models.api.Model` API: the step registers the
parameters it is given on the model, runs backward, and hands the
gradients to :func:`repro_torch.optim.adamw.apply_updates`, which writes the
step into the parameter and optimizer trees in place and returns them.
With ``n_micro > 1`` the batch's leading axis is cut into micro-slices
whose float32 gradients and losses are summed in slice order and divided
by ``n_micro``, as the reference's ``lax.scan`` does.  With
``compress_grads`` the gradients cross pods through the GBDI-FR ring of
:mod:`repro_torch.distributed.collectives` before the update.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.models.api import Model
from repro_torch.optim import adamw

TrainStep = Callable[[Any, dict, dict], tuple[Any, dict, dict]]


def _grads(model: Model, batch: dict) -> tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of one batch on the model's registered params.
    A parameter the loss never reads (the norm of a zamba2 ``shared_attn``
    slot, whose block runs on ``params["shared"]``) gets a zero gradient,
    as ``jax.grad`` gives it."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)[0]
    loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                     model.params())
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _micro(batch: dict, n_micro: int, i: int) -> dict:
    def cut(x: Any) -> Any:
        b = x.shape[0] // n_micro
        return x[i * b:(i + 1) * b]
    return {k: cut(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def make_train_step(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    *,
    n_micro: int = 1,
    compress_grads: bool = False,
    fr_bases: Any = None,
) -> TrainStep:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates ``params`` and ``opt_state`` in place and
    returns them; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``."""

    def compute_grads(batch: dict) -> tuple[torch.Tensor, Any]:
        if n_micro == 1:
            return _grads(model, batch)
        acc = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n_micro):
            loss, grads = _grads(model, _micro(batch, n_micro, i))
            if acc is None:
                acc = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                     device=g.device), grads)
            acc = tree_map(lambda a, g: a + g, acc, grads)
            loss_sum = loss_sum + loss
        return loss_sum / n_micro, tree_map(lambda g: g / n_micro, acc)

    def train_step(params: Any, opt_state: dict, batch: dict) -> tuple[Any, dict, dict]:
        model.set_params(params)
        loss, grads = compute_grads(batch)
        if compress_grads:
            from repro_torch.distributed import collectives

            grads = collectives.compressed_crosspod_mean(grads, fr_bases)
        params, opt_state, opt_metrics = adamw.apply_updates(opt_cfg, model.params(), grads,
                                                             opt_state)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


__all__ = ["TrainStep", "make_train_step"]
