"""Multi-request serving benchmark on the PyTorch port: the
continuous-batching scheduler under compressed-KV memory pressure, swept
over concurrent-request count.

  PYTHONPATH=src python benchmarks/serving_bench_torch.py                   # on the CUDA card
  PYTHONPATH=src python benchmarks/serving_bench_torch.py --quick --device cpu

The counterpart of ``benchmarks/serving_bench.py``, with its CLI, defaults
and artifact schema; it imports only ``repro_torch``.  Admission is
governed by a KV *byte* budget, and at an equal budget the compressed
accounting (``KVSpec.compressed_bytes``) keeps more sequences resident
than the raw-cache baseline (``KVSpec.raw_bytes``).  Both accounting modes
drive the same engine and the same schedule, so the only variable is how
many sequences the byte budget admits at once.

Per (concurrency, accounting) cell the bench builds a fresh engine and
scheduler with a shared byte budget (``--budget-slots`` x the raw cost of
one resident sequence), submits ``concurrency`` requests up front, and
drives the scheduler to drain, recording wall-clock tokens/s (host clock;
on the card every step ends with its tokens copied to the host),
time-to-first-token (includes queue wait), queue latency in scheduler
ticks, peak resident sequences, and resident sequences per GiB of budget.
The model is the reduced deepseek-7b (bf16) initialised from ``--seed`` on
the device.

Artifact schema (``experiments/BENCH_serving_torch.json``, mirrored to the
repo root):

  meta:  bench="serving", arch, concurrencies, byte_budget, budget_slots,
         accounting modes, engine geometry (max_len, prompt_len, max_new),
         seed, devices, device, power_limit, spec fields (n_kv, head_dim,
         page_words, n_kv_layers, bytes_per_seq per accounting)
  rows:  one per (concurrency, accounting) cell —
         {concurrency, accounting, bytes_per_seq, capacity_seqs,
          peak_resident, resident_per_gib, tokens, wall_s, tokens_s,
          ttft_s_mean, ttft_s_median, ttft_s_max, queue_wait_ticks_mean,
          queue_wait_ticks_max, evictions, finished}
  summary: headline at the max concurrency — peak_resident, tokens_s and
         resident_per_gib per accounting mode at the shared budget; the
         evidence is summary.peak_resident.compressed >
         summary.peak_resident.raw.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, reduced
from repro_torch.eval.run import device_name, power_limit, write_artifact
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Scheduler

MODES = ("compressed", "raw")


def _run_cell(model, params, *, concurrency: int, accounting: str,
              byte_budget: int, max_len: int, prompt_len: int,
              max_new: int, seed: int) -> dict:
    spec = model.kv_cache_spec(max_len)
    per_seq = model.n_kv_layers * (
        spec.compressed_bytes(1) if accounting == "compressed"
        else spec.raw_bytes(1))
    capacity = byte_budget // per_seq
    engine = Engine(model, params,
                    batch_slots=max(1, min(concurrency, capacity)),
                    max_len=max_len)
    sched = Scheduler(engine, byte_budget=byte_budget, accounting=accounting)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    reqs = [sched.submit(
        rng.integers(0, model.cfg.vocab_size, prompt_len).astype(np.int32),
        max_new=max_new) for _ in range(concurrency)]
    sched.run()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    ttft = [r.first_token_t - r.submit_t for r in reqs]
    waits = [r.admit_tick - r.submit_tick for r in reqs]
    return {
        "concurrency": concurrency,
        "accounting": accounting,
        "bytes_per_seq": per_seq,
        "capacity_seqs": capacity,
        "peak_resident": sched.counters["peak_resident"],
        "resident_per_gib": sched.counters["peak_resident"]
        / (byte_budget / 2**30),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_s": tokens / wall,
        "ttft_s_mean": statistics.mean(ttft),
        "ttft_s_median": statistics.median(ttft),
        "ttft_s_max": max(ttft),
        "queue_wait_ticks_mean": statistics.mean(waits),
        "queue_wait_ticks_max": max(waits),
        "evictions": sched.counters["evicted"],
        "finished": sched.counters["finished"],
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--concurrencies", default="2,4,8,12",
                    help="comma-separated concurrent-request counts")
    ap.add_argument("--max-len", type=int, default=512,
                    help="per-slot cache ceiling (tokens); page count per "
                         "sequence scales with it, so so does the "
                         "compressed-vs-raw byte ratio")
    ap.add_argument("--budget-slots", type=int, default=8,
                    help="byte budget = this many RAW resident sequences; "
                         "shared by both accounting modes")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="experiments/BENCH_serving_torch.json",
                    help="artifact path ('' to skip writing); experiments/ "
                         "paths are mirrored to the repo root")
    ap.add_argument("--quick", action="store_true",
                    help="small engine, two concurrency points (CI smoke)")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)
    if args.quick:
        args.concurrencies, args.max_len = "2,3", 128
        args.budget_slots, args.max_new = 2, 4
    concurrencies = sorted(int(c) for c in args.concurrencies.split(","))

    dev = resolve_device(args.device)
    cfg = reduced(ARCHS["deepseek-7b"])
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    spec = model.kv_cache_spec(args.max_len)
    raw_seq = model.n_kv_layers * spec.raw_bytes(1)
    comp_seq = model.n_kv_layers * spec.compressed_bytes(1)
    byte_budget = args.budget_slots * raw_seq
    print(f"serving_bench: budget={byte_budget} B "
          f"(= {args.budget_slots} raw seqs; raw {raw_seq} B/seq, "
          f"compressed {comp_seq} B/seq, ratio {raw_seq / comp_seq:.3f})")

    rows = []
    for concurrency in concurrencies:
        for accounting in MODES:
            row = _run_cell(
                model, params, concurrency=concurrency,
                accounting=accounting, byte_budget=byte_budget,
                max_len=args.max_len, prompt_len=args.prompt_len,
                max_new=args.max_new, seed=args.seed)
            rows.append(row)
            print(f"serving/c{concurrency}_{accounting},"
                  f"{row['tokens_s']:.1f},tok_s;resident={row['peak_resident']}"
                  f";ttft_med={row['ttft_s_median'] * 1e3:.1f}ms"
                  f";evict={row['evictions']}")

    top = concurrencies[-1]
    summary = {
        "concurrency": top,
        "byte_budget": byte_budget,
        "peak_resident": {r["accounting"]: r["peak_resident"]
                          for r in rows if r["concurrency"] == top},
        "tokens_s": {r["accounting"]: r["tokens_s"]
                     for r in rows if r["concurrency"] == top},
        "resident_per_gib": {r["accounting"]: r["resident_per_gib"]
                             for r in rows if r["concurrency"] == top},
    }
    print(f"serving/headline,0,budget={byte_budget};resident "
          f"compressed={summary['peak_resident']['compressed']} vs "
          f"raw={summary['peak_resident']['raw']}")

    payload = {
        "bench": "serving",
        "arch": cfg.arch_id,
        "concurrencies": concurrencies,
        "byte_budget": byte_budget,
        "budget_slots": args.budget_slots,
        "accounting_modes": list(MODES),
        "max_len": args.max_len,
        "prompt_len": args.prompt_len,
        "max_new": args.max_new,
        "seed": args.seed,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "device": device_name(dev),
        "power_limit": power_limit() if dev.type == "cuda" else "",
        "spec": {"n_kv": cfg.n_kv_heads, "head_dim": cfg.head_dim_,
                 "page_words": spec.fr.page_words,
                 "n_kv_layers": model.n_kv_layers,
                 "bytes_per_seq_compressed": comp_seq,
                 "bytes_per_seq_raw": raw_seq},
        "rows": rows,
        "summary": summary,
    }
    if args.json:
        for p in write_artifact(args.json, payload):
            print(f"wrote {p}")
    return payload


if __name__ == "__main__":
    main()
