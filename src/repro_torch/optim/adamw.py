"""AdamW with decoupled weight decay and global-norm clipping.

PyTorch counterpart of :mod:`repro.optim.adamw`: functions over parameter
trees (nested dicts of tensors, walked in the reference's leaf order).  The
state (m, v) is float32; parameters update in float32 and are cast back to
their own dtype.  Unlike the reference, whose ``apply_updates`` returns new
trees, :func:`apply_updates` writes the step into the trees it is given,
in slices of :data:`SLICE` elements, so that a step needs no second copy of
the parameters and moments (the difference between fitting a full-width MoE
layer's training step on one card or not).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch._tree import tree_leaves, tree_map

Params = Any

#: elements of a leaf updated at a time: the float32 temporaries of one slice
#: are all the memory a step needs beyond the trees
SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_state(params: Params) -> dict:
    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step_device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


def _step_scalars(cfg: AdamWConfig, step: torch.Tensor, grads: Params) -> tuple[torch.Tensor, ...]:
    """The step's scalars: (grad norm, clip scale, lr, bias corrections)."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    return gn, scale, schedule(cfg, step), 1 - cfg.b1 ** step.float(), 1 - cfg.b2 ** step.float()


def _update(cfg: AdamWConfig, scalars: tuple[torch.Tensor, ...], p: torch.Tensor,
            g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's (new param, m, v), elementwise."""
    _, scale, lr, b1c, b2c = scalars
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    new_p = p.float() - lr * (u + cfg.weight_decay * p.float())
    return new_p.to(p.dtype), m, v


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params, grads: Params,
                  state: dict) -> tuple[Params, dict, dict]:
    """One AdamW step, written in place into ``params`` and ``state``
    (``state["step"]`` advanced).  Returns the same trees and
    ``{"grad_norm", "lr"}``, in the reference's ``(params, state, metrics)``."""
    state["step"] = state["step"] + 1
    scalars = _step_scalars(cfg, state["step"], grads)
    for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state["m"], state["v"]))):
        flat = [p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)]
        for s in range(0, p.numel(), SLICE):
            part = [t[s:s + SLICE] for t in flat]
            for dst, src in zip((part[0], part[2], part[3]), _update(cfg, scalars, *part)):
                dst.copy_(src)
    return params, state, {"grad_norm": scalars[0], "lr": scalars[2]}
