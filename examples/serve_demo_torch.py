"""Serve a small model through the continuous-batching scheduler on the
PyTorch port and report what GBDI-FR KV compression buys under a byte
budget.

  PYTHONPATH=src python examples/serve_demo_torch.py                 # on the CUDA card
  PYTHONPATH=src python examples/serve_demo_torch.py --device cpu    # plain PyTorch on the host

The counterpart of ``examples/serve_demo.py``: it imports only
``repro_torch``.  Ten full-length requests contend for a budget worth six
raw-cache sequences: under compressed accounting the same budget keeps
seven resident at once, and a late high-priority request shows
eviction/parking — the displaced sequence resumes transparently and still
finishes.  Reservations are token-level (each request is charged its own
final context, not the ``max_len`` slot), so the contention here comes from
the requests filling the cache; a short request reserves a fraction of that
(printed at the end).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import KVSpec
from repro_torch.serving.scheduler import Scheduler


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")

    cfg = reduced(ARCHS["deepseek-7b"])
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    max_len = 512                            # page count drives the ratio
    spec = model.kv_cache_spec(max_len)
    raw_seq = model.n_kv_layers * spec.raw_bytes(1)
    budget = 6 * raw_seq                     # room for 6 raw sequences
    rng = np.random.default_rng(0)

    max_new = max_len - 12                   # prompt 12 + max_new fills the cache
    counters = {}
    for accounting in ("raw", "compressed"):
        eng = Engine(model, params, batch_slots=8, max_len=max_len)
        sched = Scheduler(eng, byte_budget=budget, accounting=accounting)
        reqs = [sched.submit(rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                             max_new=max_new) for _ in range(10)]
        for _ in range(3):                   # let decode get going...
            sched.step()
        vip = sched.submit(rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                           max_new=max_new, priority=1)
        sched.run()                          # ...then drain everything
        c = counters[accounting] = dict(sched.counters)
        print(f"{accounting:>10}: budget={budget} B "
              f"({sched.bytes_per_seq} B/seq) -> peak resident "
              f"{c['peak_resident']}, evictions {c['evicted']}, "
              f"resumes {c['resumed']}, {c['tokens']} tokens, "
              f"vip waited {vip.admit_tick - vip.submit_tick} ticks")
        if not all(len(r.out) == max_new for r in reqs + [vip]):
            raise AssertionError(f"{accounting}: a request finished short of max_new={max_new}")
        if vip.evictions != 0:
            raise AssertionError(f"{accounting}: the priority-1 request was evicted")

    # token-level reservations: a short request is charged its own final
    # context, not the max_len slot it can never fill
    short = sched.prompt_bytes(12 + 8)
    print(f"\nshort request (prompt 12, max_new 8) reserves {short} B "
          f"vs {sched.bytes_per_seq} B for a full-length slot "
          f"({sched.bytes_per_seq / short:.1f}x more of them fit one budget)")

    # what the compressed cache buys at llama3-405b decode scale
    spec = KVSpec(n_kv=8, head_dim=128, max_len=32768)
    raw, comp = spec.raw_bytes(128), spec.compressed_bytes(128)
    print("\nKV cache @ llama3-405b decode_32k, one layer, batch 128:")
    print(f"  raw          {raw/2**30:.2f} GiB")
    print(f"  GBDI-FR      {comp/2**30:.2f} GiB  ({raw/comp:.2f}x less HBM traffic/step)")
    return counters


if __name__ == "__main__":
    main()
