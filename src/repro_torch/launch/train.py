"""Training entrypoint.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --reduced \
      --steps 50 --batch 4 --seq 128                 # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 6 --device cpu

Counterpart of :mod:`repro.launch.train`, with ``--device`` as the serve CLI
has.  Checkpoints are GBDI-compressed and the run auto-resumes from the
latest one (kill and re-run to verify).  It trains the dense, moe, hybrid
and ssm families; the vlm and audio families are refused, as the reference
refuses them.  xlstm-1.3b's mLSTM gradient goes NaN in both packages once
a chunk's forget-gate decay overflows float32, from about 128 tokens
(``ROADMAP.md`` §3).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("use examples/ for the stub-frontend families")
    model = build_model(cfg, resolve_device(args.device))
    print(f"{cfg.arch_id}: {cfg.param_count()/1e6:.1f}M params")

    pipe = TokenPipeline(PipelineConfig(cfg.vocab_size, args.seq, args.batch))
    tc = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=10, n_micro=args.n_micro,
    )
    trainer = Trainer(model, adamw.AdamWConfig(lr=args.lr, total_steps=args.steps), pipe, tc)
    trainer.run()
    for h in trainer.history:
        if "loss" in h:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}")
        elif "ckpt_ratio" in h:
            print(f"step {h['step']:5d}  ckpt GBDI ratio {h['ckpt_ratio']:.2f}x")
    return trainer


if __name__ == "__main__":
    main()
