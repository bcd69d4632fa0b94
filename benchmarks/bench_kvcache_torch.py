"""KV-cache compression benchmark on the PyTorch port: memory per sequence
plus attention error.

  PYTHONPATH=src python benchmarks/bench_kvcache_torch.py                 # on the CUDA card
  PYTHONPATH=src python benchmarks/bench_kvcache_torch.py --device cpu

The counterpart of ``benchmarks/bench_kvcache.py``; it imports only
``repro_torch``.  Llama-3-405B-class decode (8 KV heads of 128, 32K
context): raw vs GBDI-FR paged bytes; then the decode-attention output's
deviation on channel-structured K/V over a short window: 96 tokens appended
one at a time (each a page, so every append flushes through the encode
kernel), then one ``attention_decode`` with the ``auto`` backend, which on a
cache with no resident region is the paged-attention kernel over the
compressed pages.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.format import BaseTable
from repro_torch.core.gbdi_fr import FRConfig, bf16_to_words, fit_fr_bases
from repro_torch.serving import kv_cache as kvc


def run(device: str | torch.device | None = None,
        bases: BaseTable | None = None) -> dict:
    """The bytes of the 32K spec at batch 4 and the fidelity run's errors.

    ``bases`` is the fidelity run's FR base table; ``None`` fits it on the
    run's K/V.  The table used is returned under ``"bases"``, so a second
    run (another device) can compress the same pages with it."""
    dev = resolve_device(device)
    spec = kvc.KVSpec(n_kv=8, head_dim=128, max_len=32768)
    B = 4
    out = {"raw": spec.raw_bytes(B), "compressed": spec.compressed_bytes(B)}

    small = kvc.KVSpec(n_kv=4, head_dim=32, max_len=128,
                       fr=FRConfig(word_bits=16, page_words=128, delta_bits=8,
                                   num_bases=14, outlier_cap=16))
    rng = np.random.default_rng(0)
    n = 96
    ch = rng.normal(0, 1, (1, 1, 4, 32)) * 2
    ks = torch.from_numpy((ch + rng.normal(0, 0.1, (2, n, 4, 32))).astype(np.float32)).to(dev)
    vs = torch.from_numpy((ch + rng.normal(0, 0.1, (2, n, 4, 32))).astype(np.float32)).to(dev)
    if bases is None:
        bases = fit_fr_bases(bf16_to_words(torch.cat([ks, vs], 1)).reshape(-1), small.fr)
    bases = bases.to(dev)
    cache = kvc.init_compressed(small, 2, bases, device=dev)
    for t in range(n):
        kvc.append(small, cache, ks[:, t:t + 1], vs[:, t:t + 1], t)
    q = torch.from_numpy(rng.normal(0, 1, (2, 1, 8, 32)).astype(np.float32)).to(dev)
    out_c = kvc.attention_decode(small, q, cache, n - 1)
    Kr = ks[:, :n].to(torch.bfloat16).float()
    Vr = vs[:, :n].to(torch.bfloat16).float()
    qg = q.reshape(2, 1, 4, 2, 32)
    lg = torch.einsum("bskgh,btkh->bkgst", qg, Kr) / np.sqrt(32)
    pr = torch.softmax(lg, -1).to(torch.bfloat16).float()
    ref = torch.einsum("bkgst,btkh->bskgh", pr, Vr).to(torch.bfloat16).reshape(2, 1, 256)
    err = float((out_c.float() - ref.float()).abs().max())
    out.update(max_abs=err, max_rel=err / float(ref.float().abs().max()), out=out_c, ref=ref,
               bases=bases)
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"kvcache/bytes,0,raw={r['raw']};compressed={r['compressed']};"
          f"ratio={r['raw'] / r['compressed']:.3f}")
    print(f"kvcache/attention_error,0,max_abs={r['max_abs']:.4f};max_rel={r['max_rel']:.4f}")
    return r


if __name__ == "__main__":
    main()
