"""Encode/decode throughput of every codec on the card (paper §IV: the
compression and decompression engines), on the PyTorch port.

  PYTHONPATH=src python benchmarks/bench_throughput_torch.py            # full run
  PYTHONPATH=src python benchmarks/bench_throughput_torch.py --quick    # smoke

The counterpart of ``benchmarks/bench_throughput.py``: a thin delegate over
``python -m repro_torch.eval.run --throughput`` with the same flags.  Warmed,
median-of-K encode/decode GiB/s for every codec x workload family, each row
with its roofline share of the card's memory bandwidth, the card's name and
power limit, written to ``experiments/BENCH_throughput_torch.json``.  Codec
roles on the card: ``gbdi`` and ``bdi`` are the paper's codecs as plain
PyTorch, ``fr`` the GBDI-FR kernels through ``kernels.ops``, ``fr_xla`` the
same kernels through the front-end ``kernels.pipeline`` and ``fr_kernel``
the kernels asked for by name (full streams: no row is truncated).  It
needs the card: on the host it exits non-zero without timing anything.
"""
from __future__ import annotations

import argparse

from repro_torch.eval import run as eval_run


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bytes", type=int, default=2 << 20, dest="n_bytes")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codec", default=eval_run.THROUGHPUT_CODECS)
    ap.add_argument("--json", default="experiments/BENCH_throughput_torch.json",
                    help="artifact path ('' to skip writing); paths under experiments/ are "
                         "mirrored to the directory above it")
    ap.add_argument("--quick", action="store_true", help="small streams, fewer repeats")
    args = ap.parse_args(argv)
    if args.quick:
        args.n_bytes, args.repeats = 256 << 10, 2

    cli = ["--throughput", "--csv", "--codec", args.codec, "--bytes", str(args.n_bytes),
           "--repeats", str(args.repeats), "--seed", str(args.seed)]
    if args.json:
        cli += ["--json", args.json]
    eval_run.main(cli)


if __name__ == "__main__":
    main()
