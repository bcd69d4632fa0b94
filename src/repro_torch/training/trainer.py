"""Training loop with fault tolerance and the GBDI integration hooks.

PyTorch counterpart of ``src/repro/training/trainer.py``:

* auto-resume: on start, restore the latest checkpoint if present; the
  index-based token pipeline makes a resume bit-exact;
* periodic atomic GBDI-compressed checkpoints (:mod:`repro_torch.checkpoint.ckpt`,
  the reference's on-disk format);
* crash injection (``fail_at_step``) for the failure-recovery tests;
* a periodic GBDI-FR base refit from a parameter sample, under the
  gradient transport's config (:data:`repro_torch.distributed.collectives.GRAD_FR`).

As in the reference, the trainer's step takes neither ``fr_bases`` nor
``compress_grads``: the refit table is kept in :attr:`Trainer.fr_bases` for
a caller that builds a compressed step itself.  Parameters are initialised
from a ``torch.Generator`` on the model's device, seeded with ``seed``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch._tree import tree_leaves
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.api import Model
from repro_torch.optim import adamw
from repro_torch.training.train_step import make_train_step


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    #: the reference's ``/tmp/repro_ckpt``, under the process's temp directory
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    resume: bool = True
    log_every: int = 10
    n_micro: int = 1
    refit_fr_every: int = 0      # 0 = off; else refit GBDI-FR bases every N steps
    fail_at_step: int = -1       # crash injection for recovery tests


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(
        self,
        model: Model,
        opt_cfg: adamw.AdamWConfig,
        pipe: TokenPipeline,
        tc: TrainerConfig,
        *,
        batch_fn: Callable[[int], dict] | None = None,
    ):
        self.model, self.opt_cfg, self.pipe, self.tc = model, opt_cfg, pipe, tc
        self.batch_fn = batch_fn or (lambda step: pipe.batch_at(step))
        self.step_fn = make_train_step(model, opt_cfg, n_micro=tc.n_micro)
        self.fr_bases = None
        self.history: list[dict] = []

    def init_or_resume(self, seed: int = 0) -> tuple[int, Any, dict]:
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        params = self.model.init(gen)
        opt_state = adamw.init_state(params)
        start = 0
        if self.tc.resume and ckpt.latest_step(self.tc.ckpt_dir) is not None:
            start, tree = ckpt.load(self.tc.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            self.model.set_params(params)
        return start, params, opt_state

    def run(self, seed: int = 0) -> tuple[Any, dict]:
        tc = self.tc
        start, params, opt_state = self.init_or_resume(seed)
        t0 = time.time()
        for step in range(start, tc.total_steps):
            if step == tc.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self.batch_fn(step)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            if tc.refit_fr_every and (step + 1) % tc.refit_fr_every == 0:
                self._refit_fr(params)
            if (step + 1) % tc.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall=time.time() - t0)
                self.history.append(m)
            if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.total_steps:
                stats = ckpt.save(tc.ckpt_dir, step + 1, {"params": params, "opt": opt_state})
                self.history.append({"step": step, "ckpt_ratio": stats["ratio"]})
        return params, opt_state

    def _refit_fr(self, params: Any) -> None:
        """The paper's "background data analysis" as a live hook: refit the
        global base table from a parameter sample (the first 4,096 words of
        each of the first 8 bf16 leaves past 4,096 elements) under the
        transport config, so fit and encode widths agree."""
        from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases
        from repro_torch.distributed.collectives import GRAD_FR

        leaves = [p for p in tree_leaves(params)
                  if p.dtype == torch.bfloat16 and p.numel() > 4096]
        if not leaves:
            return
        sample = torch.cat([leaf.detach().reshape(-1)[:4096] for leaf in leaves[:8]])
        self.fr_bases = fit_fr_bases(bf16_to_words(sample), GRAD_FR)


__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
