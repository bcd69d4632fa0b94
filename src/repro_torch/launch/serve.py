"""Serving entrypoint: batched continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b --reduced \
      --requests 6 --max-new 8                  # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Counterpart of :mod:`repro.launch.serve`.  The model is initialised from
seed 0 on the device; prompts are 12 tokens drawn from seed 0.  It serves
the dense, moe, hybrid and ssm families; the stub-frontend families (vlm,
audio) are refused, as the reference refuses them.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, Request


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("use examples/ for the stub-frontend families")
    dev = resolve_device(args.device)
    model = build_model(cfg, dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, batch_slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(0)
    pending = [
        Request(i, rng.integers(0, cfg.vocab_size, 12).astype(np.int32), max_new=args.max_new)
        for i in range(args.requests)
    ]
    done = []
    while pending or any(r is not None and not r.done for r in eng.slot_req):
        n = eng.admit(pending)
        done += pending[:n]
        pending = pending[n:]
        while eng.tick():
            pass
        if n == 0 and not any(r is not None and not r.done for r in eng.slot_req):
            break
    for r in done:
        print(f"req {r.rid}: {r.out}")
    return done


if __name__ == "__main__":
    main()
