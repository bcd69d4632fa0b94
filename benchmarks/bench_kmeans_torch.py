"""Paper §II.A claim on the PyTorch port: modified (bit-cost) k-means beats
vanilla k-means on compression ratio.  One row per workload: CR_modified vs
CR_vanilla, each fitted and encoded on the device.

  PYTHONPATH=src python benchmarks/bench_kmeans_torch.py               # on the CUDA card
  PYTHONPATH=src python benchmarks/bench_kmeans_torch.py --device cpu

The counterpart of ``benchmarks/bench_kmeans.py``; it imports only ``repro_torch``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core import gbdi
from repro_torch.data import workloads
from repro_torch.eval.run import device_name, power_limit


def run(n_bytes: int = 2 << 20, seed: int = 0, device: str | None = None) -> list[dict]:
    dev = resolve_device(device)
    rows = []
    for name in workloads.WORKLOADS:
        data = workloads.generate(name, n_bytes=n_bytes, seed=seed)
        words = gbdi.word_stream(data, 32, dev)
        crs = {}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for modified in (True, False):
            cfg = gbdi.GBDIConfig(modified_kmeans=modified)
            crs[modified] = gbdi.compression_ratio(gbdi.encode(words, gbdi.fit(words, cfg)))
        dt = time.perf_counter() - t0
        rows.append({"workload": name, "cr_modified": crs[True], "cr_vanilla": crs[False],
                     "us": dt * 1e6, "device": device_name(dev),
                     "power_limit": power_limit() if dev.type == "cuda" else ""})
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bytes", type=int, default=2 << 20, dest="n_bytes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)
    rows = run(n_bytes=args.n_bytes, seed=args.seed, device=args.device)
    wins = 0
    for r in rows:
        wins += r["cr_modified"] >= r["cr_vanilla"] - 1e-3
        print(f"kmeans/{r['workload']},{r['us']:.0f},"
              f"modified={r['cr_modified']:.3f};vanilla={r['cr_vanilla']:.3f}")
    print(f"kmeans/summary,0,modified_wins={wins}/{len(rows)}")
    return rows


if __name__ == "__main__":
    main()
