"""Gradient-compression benchmark on the PyTorch port: cross-pod wire bytes
and fidelity of the GBDI-FR gradient transport.

  PYTHONPATH=src python benchmarks/bench_gradcomp_torch.py               # on the CUDA card
  PYTHONPATH=src python benchmarks/bench_gradcomp_torch.py --device cpu

The counterpart of ``benchmarks/bench_gradcomp.py``, with its two CSV lines
(``gradcomp/wire_bytes`` and ``gradcomp/fidelity``): the fixed rate of
:data:`repro_torch.distributed.collectives.GRAD_FR` against bf16 and float32
transport, and the exactness of a bf16 gradient mixture after an encode and
a decode (the CUDA kernels on the card, the plain versions on the CPU).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases, words_to_bf16
from repro_torch.distributed.collectives import GRAD_FR
from repro_torch.kernels import pipeline


def run(device: str | None = None) -> list[str]:
    """The two CSV lines."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    # layered gradient scales, zeros from masking: a realistic mixture
    parts = [
        rng.normal(0, s, 1 << 16) * (rng.random(1 << 16) > z)
        for s, z in [(1e-3, 0.2), (3e-2, 0.0), (1e-4, 0.5), (5e-3, 0.1)]
    ]
    g = torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(dev)
    gb = g.to(torch.bfloat16)
    pages = bf16_to_words(gb).reshape(-1, GRAD_FR.page_words)
    bases = fit_fr_bases(pages, GRAD_FR)
    blob = pipeline.encode_pages(pages, bases, GRAD_FR)
    dec = pipeline.decode_pages(blob, bases, GRAD_FR)
    back = words_to_bf16(dec.reshape(-1)[: gb.numel()])

    raw_fp32 = g.numel() * 4
    raw_bf16 = raw_fp32 // 2
    comp = pages.shape[0] * GRAD_FR.compressed_bytes_per_page()
    exact = float((back == gb).to(torch.float32).mean())
    err = float((back.float() - g).abs().max())
    bf16_err = float((gb.float() - g).abs().max())
    return [
        f"gradcomp/wire_bytes,0,fp32={raw_fp32};bf16={raw_bf16};gbdi_fr={comp};"
        f"x_vs_fp32={raw_fp32/comp:.2f};x_vs_bf16={raw_bf16/comp:.2f}",
        f"gradcomp/fidelity,0,exact_frac={exact:.4f};maxerr={err:.2e};"
        f"bf16_cast_err={bf16_err:.2e};dropped={int(blob['n_dropped'].sum())}",
    ]


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)
    lines = run(args.device)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
