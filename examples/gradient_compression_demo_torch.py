"""Cross-pod gradient compression demo on two gloo ranks.

  PYTHONPATH=src python examples/gradient_compression_demo_torch.py               # the card
  PYTHONPATH=src python examples/gradient_compression_demo_torch.py --device cpu

The counterpart of ``examples/gradient_compression_demo.py``: two ranks (two
processes of one gloo group, standing for two pods; on the card both share
it) run the same gradient exchange two ways, a plain float32 all-reduce mean
and the GBDI-FR compressed ring
(:func:`repro_torch.distributed.collectives.compressed_pod_mean`), and print
the largest difference and the cross-pod wire bytes a device.  The
reference reads its wire bytes from the compiled HLO (``launch/hlo_stats.py``,
not ported yet); here they are byte counts of the exchanged tensors: the
float32 and bf16 all-reduce payloads (a two-rank all-reduce sends each
rank's payload once) and the packed blob buffer each hop of the ring sends.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _grads() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    return {"wq": rng.normal(0, 1e-3, (2, 1 << 14)).astype(np.float32),
            "wo": rng.normal(0, 2e-2, (2, 1 << 13)).astype(np.float32)}


def rank_main(rank: int, world: int, device: str) -> dict:
    """One pod: its row of each gradient, both exchanges, the wire bytes."""
    from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases
    from repro_torch.distributed.collectives import GRAD_FR, compressed_pod_mean, plain_pod_mean

    dev = torch.device(device)
    full = _grads()
    words = bf16_to_words(torch.cat([torch.from_numpy(v.reshape(-1)) for v in full.values()]))
    bases = fit_fr_bases(words.to(dev), GRAD_FR)
    grads = {k: torch.from_numpy(v[rank:rank + 1].copy()).to(dev) for k, v in full.items()}
    stats: dict = {}
    out_c = compressed_pod_mean(grads, bases, stats=stats)
    out_p = plain_pod_mean(grads)
    err = max(float((out_c[k] - out_p[k]).abs().max()) for k in grads)
    n = sum(g.numel() for g in grads.values())
    return {"err": err, "fp32_bytes": 4 * n, "bf16_bytes": 2 * n,
            "ring_bytes": stats["wire_bytes"], "dropped": stats["n_dropped"]}


def main(argv: list[str] | None = None) -> list[dict]:
    from repro_torch._device import resolve_device
    from repro_torch.distributed.spawn import run_ranks

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run_ranks(rank_main, 2, str(dev))
    err = max(r["err"] for r in out)
    print(f"max |compressed - plain| = {err:.3e} (bf16-transport tolerance; "
          f"{sum(r['dropped'] for r in out)} words dropped)")
    r = out[0]
    for name, b in [("plain f32 all-reduce", r["fp32_bytes"]),
                    ("plain bf16 all-reduce", r["bf16_bytes"]),
                    ("GBDI-FR ring", r["ring_bytes"])]:
        print(f"{name:21s} cross-pod wire bytes/device: {b}")
    return out


if __name__ == "__main__":
    main()
