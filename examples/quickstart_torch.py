"""Quickstart on the PyTorch port: compress a synthetic memory dump with GBDI.

  PYTHONPATH=src python examples/quickstart_torch.py                 # on the CUDA card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu    # plain PyTorch on the host

The counterpart of ``examples/quickstart.py``: it imports only ``repro_torch``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import bdi, gbdi
from repro_torch.data import workloads


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)

    # 1. a "memory dump" (SPEC mcf-like pointer heap, 4 MiB)
    dump = workloads.generate("605.mcf_s", n_bytes=4 << 20, seed=0)
    print(f"dump: {dump.nbytes / 1e6:.1f} MB of 32-bit words")

    # 2. background data analysis: fit global bases with modified k-means
    model = gbdi.fit(dump, gbdi.GBDIConfig(num_bases=30, width_set=(4, 8, 16, 24)),
                     device=args.device)
    print(f"device: {model.device}")
    print(f"global bases (hex): {[hex(int(b) & 0xFFFFFFFF) for b in model.bases[:6]]} ...")
    print(f"paired delta widths: {model.widths[:6].tolist()} ...")

    # 3. compress / decompress — lossless
    words = gbdi.word_stream(dump, 32, model.device)
    blob = gbdi.encode(words, model)
    if not torch.equal(gbdi.decode(blob), words):
        raise SystemExit("GBDI must be lossless")
    print(f"GBDI compression ratio: {gbdi.compression_ratio(blob):.3f}x")

    # 4. the paper's baseline for contrast
    print(f"BDI  compression ratio: "
          f"{bdi.compression_ratio(bdi.compress(dump, device=model.device)):.3f}x")

    # 5. the same measurement through the eval harness — every registered
    #    codec over a workload, roundtrip-verified per cell:
    #    (full suite: PYTHONPATH=src python -m repro_torch.eval.run --suite all)
    from repro_torch.eval.codecs import default_codecs
    from repro_torch.eval.run import evaluate, format_table
    from repro_torch.eval.workloads import default_workloads

    cells = evaluate(default_workloads(), default_codecs(args.device),
                     suite="605.mcf_s,java_svm", codecs="gbdi,bdi", n_bytes=1 << 18)
    print()
    print(format_table(cells))


if __name__ == "__main__":
    main()
