"""End-to-end training script on the PyTorch port: train a small LM for a few
hundred steps with the full substrate (token pipeline, AdamW,
GBDI-compressed atomic checkpoints, auto-resume).

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --preset 25m   # on the card
  PYTHONPATH=src python examples/train_lm_torch.py --steps 40 --device cpu

The counterpart of ``examples/train_lm.py``, with its presets.  Kill it
mid-run and re-run the same command: it resumes from the latest checkpoint
bit-exactly.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

PRESETS = {
    # (d_model, n_layers, n_heads, d_ff, vocab, seq, batch)
    "2m": (128, 4, 4, 512, 2048, 128, 8),
    "25m": (512, 8, 8, 2048, 8192, 256, 8),
    "100m": (768, 12, 12, 3072, 32768, 512, 8),
}


def main(argv: list[str] | None = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="2m", choices=sorted(PRESETS))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)

    d, L, H, ff, V, S, B = PRESETS[args.preset]
    cfg = dataclasses.replace(
        get_config("deepseek-7b"),
        arch_id=f"lm-{args.preset}", n_layers=L, d_model=d, n_heads=H,
        n_kv_heads=H, d_ff=ff, vocab_size=V, head_dim=0,
        q_chunk=128, loss_chunk=128, dtype="float32",
    )
    model = build_model(cfg, resolve_device(args.device))
    print(f"params: {cfg.param_count()/1e6:.1f}M  seq={S} batch={B}")

    pipe = TokenPipeline(PipelineConfig(vocab_size=V, seq_len=S, batch_per_host=B, seed=0))
    tc = TrainerConfig(
        total_steps=args.steps, ckpt_every=max(20, args.steps // 5),
        ckpt_dir=args.ckpt_dir, log_every=10,
        refit_fr_every=0,
    )
    trainer = Trainer(model, adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                               total_steps=args.steps), pipe, tc)
    trainer.run()
    for h in trainer.history:
        if "loss" in h:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  ({h['wall']:.0f}s)")
        elif "ckpt_ratio" in h:
            print(f"step {h['step']:5d}  checkpoint GBDI ratio {h['ckpt_ratio']:.2f}x")
    return trainer


if __name__ == "__main__":
    main()
