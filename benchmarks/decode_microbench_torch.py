"""Decode steady-state microbench on the PyTorch port: per-token KV
decode-step latency vs context length, incremental resident region vs full
re-decode.

  PYTHONPATH=src python benchmarks/decode_microbench_torch.py                 # on the CUDA card
  PYTHONPATH=src python benchmarks/decode_microbench_torch.py --quick --device cpu

The counterpart of ``benchmarks/decode_microbench.py``, with its sizes,
modes, CLI and artifact schema; it imports only ``repro_torch``.  With
``KVSpec.resident_decode`` every flushed page is decoded once (at flush)
into a resident bf16 region, so a step's read cost is the tail overlay;
without it the ``oracle`` backend re-decodes every page slot each step.

Per (context, mode) cell the bench builds a fresh single-sequence
``KVSession``, prefills to one token short of ``context``, takes one step
(append + attend), then times the attend alone on that frozen cache each
repeat: host clock around a call that ends in ``torch.cuda.synchronize()``
on the card (the reference's host time after ``block_until_ready``).
Modes: ``resident`` is the auto backend over a ``resident_decode=True``
cache (flushes launch the encode and decode kernels); ``full`` is the
oracle backend over a plain cache (every attend launches the decode kernel
over all pages).

Artifact schema (``experiments/BENCH_decode_microbench_torch.json``,
mirrored to the repo root):

  meta:  bench="decode_microbench", contexts, repeats, seed, devices,
         device, power_limit, spec (n_kv, head_dim, page_words, page_tokens)
  rows:  one per (context, mode) cell —
         {context, mode, n_pages, us_per_token (median), us_best, repeats}
  summary: {mode: {scaling: us(ctx_max)/us(ctx_min), ctx_min, ctx_max}}
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.gbdi_fr import FRConfig, bf16_to_words, fit_fr_bases
from repro_torch.eval.run import device_name, power_limit, write_artifact
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.engine import KVSession

MODES = ("resident", "full")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_cell(spec: kvc.KVSpec, table, context: int, repeats: int, seed: int,
               backend: str, dev: torch.device) -> list[float]:
    rng = np.random.default_rng(seed)
    sess = KVSession(spec, 1, table, backend=backend, device=dev)
    ch = rng.normal(0, 1, (1, 1, spec.n_kv, spec.head_dim)) * 2

    def mk(n: int) -> torch.Tensor:
        x = ch + rng.normal(0, 0.1, (1, n, spec.n_kv, spec.head_dim))
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    sess.prefill(mk(context - 1), mk(context - 1))
    q = torch.from_numpy(rng.normal(0, 1, (1, 1, 2 * spec.n_kv, spec.head_dim))
                         .astype(np.float32)).to(dev)
    # one step at this position, then re-enter the timed region from the
    # same position each repeat (steady state: mid-page, no flush) by timing
    # attend-after-append on a frozen cache
    k1, v1 = mk(1), mk(1)
    sess.step(q, k1, v1)
    times = []
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        kvc.attention_decode(spec, q, sess.cache, sess.pos - 1, backend=backend)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--contexts", default="128,256,512,1024",
                    help="comma-separated context lengths (tokens)")
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="experiments/BENCH_decode_microbench_torch.json",
                    help="artifact path ('' to skip writing); experiments/ "
                         "paths are mirrored to the repo root")
    ap.add_argument("--quick", action="store_true",
                    help="two short contexts, fewer repeats (CI smoke)")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)
    if args.quick:
        args.contexts, args.repeats = "64,256", 3
    contexts = sorted(int(c) for c in args.contexts.split(","))
    dev = resolve_device(args.device)

    fr = FRConfig(word_bits=16, page_words=512, width_set=(4, 8),
                  bucket_caps=(128, 512), num_bases=14, outlier_cap=32)
    n_kv, hd = 4, 32
    rng = np.random.default_rng(args.seed)
    sample = (rng.normal(0, 1, (1, 1, n_kv, hd)) * 2
              + rng.normal(0, 0.1, (1, 1024, n_kv, hd))).astype(np.float32)
    table = fit_fr_bases(bf16_to_words(torch.from_numpy(sample).to(dev)).reshape(-1), fr)

    rows = []
    for context in contexts:
        for mode in MODES:
            spec = kvc.KVSpec(n_kv=n_kv, head_dim=hd, max_len=context, fr=fr,
                              resident_decode=(mode == "resident"))
            backend = "auto" if mode == "resident" else "oracle"
            times = _time_cell(spec, table, context, args.repeats, args.seed, backend, dev)
            us_med = statistics.median(times) * 1e6
            us_best = min(times) * 1e6
            rows.append({"context": context, "mode": mode, "n_pages": spec.n_pages,
                         "us_per_token": us_med, "us_best": us_best,
                         "repeats": args.repeats})
            print(f"decode_microbench/ctx{context}_{mode},{us_med:.1f},"
                  f"best={us_best:.1f};n_pages={spec.n_pages}")

    summary = {}
    for mode in MODES:
        us = {r["context"]: r["us_per_token"] for r in rows if r["mode"] == mode}
        summary[mode] = {"ctx_min": contexts[0], "ctx_max": contexts[-1],
                         "scaling": us[contexts[-1]] / us[contexts[0]]}
        print(f"decode_microbench/scaling_{mode},0,"
              f"x{summary[mode]['scaling']:.2f} over "
              f"{contexts[0]}->{contexts[-1]} tokens")

    payload = {
        "bench": "decode_microbench",
        "contexts": contexts,
        "repeats": args.repeats,
        "seed": args.seed,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "device": device_name(dev),
        "power_limit": power_limit() if dev.type == "cuda" else "",
        "spec": {"n_kv": n_kv, "head_dim": hd, "page_words": fr.page_words,
                 "page_tokens": fr.page_words // (n_kv * hd)},
        "rows": rows,
        "summary": summary,
    }
    if args.json:
        for p in write_artifact(args.json, payload):
            print(f"wrote {p}")
    return payload


if __name__ == "__main__":
    main()
