"""Roofline table from the PyTorch port's dry-run JSONs, on H100 constants.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --fit
  PYTHONPATH=src python benchmarks/roofline_torch.py --mesh pod --markdown

The counterpart of ``benchmarks/roofline.py``; it imports only
``repro_torch`` and takes its constants from ``repro_torch.launch.mesh``
(H100 SXM5: 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3).  Per (arch x shape x
mesh):

  * the three terms (seconds/chip/step): compute, memory, collective;
  * dominant = the bottleneck;
  * useful_flops = MODEL_FLOPS / counted FLOPs (redundancy waste);
  * roofline_frac = ideal_step / actual_step, where actual_step =
    max(terms) (perfect overlap assumption) and ideal_step =
    max(model-compute time, minimal-traffic memory time):

      train:   min_bytes = (2+2+16)*N_active/chips      params r + grads w +
               fp32 m,v r/w - activations assumed perfectly fused/rematted
      prefill: min_bytes = (2*N_active + kv_write)/chips
      decode:  min_bytes = (2*N_active + kv_read)/chips

    i.e. the fraction of ideal roofline speed the counted program reaches.
It is host arithmetic over the JSON cells and runs on any host.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import SHAPES

DRYRUN_DIR = "experiments/dryrun_torch"


def peak_bytes_per_s() -> float:
    """Modelled HBM peak bandwidth (bytes/s) - the roofline memory ceiling,
    ``repro_torch.launch.mesh.HBM_BW``."""
    return float(HBM_BW)


def load_cells(d: str = DRYRUN_DIR) -> list[dict]:
    cells = []
    for f in sorted(Path(d).glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("ok") and not r.get("skipped"):
            cells.append(r)
    return cells


def _kv_bytes(cfg, sc) -> int:
    """Raw bf16 KV/state bytes for the whole cache (global)."""
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    per_tok = 2 * cfg.n_kv_heads * hd * 2  # k+v bf16
    specs = list(cfg.pattern) * (cfg.n_layers // len(cfg.pattern)) + list(
        cfg.pattern[: cfg.n_layers % len(cfg.pattern)]
    )
    total = 0
    for s in specs:
        if s.mixer in ("attn", "shared_attn"):
            total += sc.global_batch * sc.seq_len * per_tok
        elif s.mixer == "local":
            total += sc.global_batch * min(sc.seq_len, cfg.window) * per_tok
        elif s.mixer == "mamba":
            total += sc.global_batch * (2 * cfg.d_model // 64) * cfg.ssm_state * 64 * 4
        elif s.mixer in ("mlstm", "slstm"):
            d_in = 2 * cfg.d_model
            hd_x = d_in // cfg.n_heads
            total += sc.global_batch * cfg.n_heads * hd_x * hd_x * 4
    return total


def ideal_step_s(arch: str, shape: str, n_chips: int) -> tuple[float, float]:
    cfg = get_config(arch)
    sc = SHAPES[shape]
    n_active = cfg.active_param_count()
    toks = sc.global_batch * (sc.seq_len if sc.kind != "decode" else 1)
    mult = 6 if sc.kind == "train" else 2
    compute = mult * n_active * toks / n_chips / PEAK_FLOPS_BF16
    if sc.kind == "train":
        min_bytes = 20 * n_active / n_chips
    else:
        min_bytes = (2 * n_active + _kv_bytes(cfg, sc)) / n_chips
    return compute, min_bytes / HBM_BW


def rows(cells: list[dict]) -> list[dict]:
    out = []
    for c in cells:
        rf = c["roofline"]
        terms = {k: rf[f"{k}_s"] for k in ("compute", "memory", "collective")}
        actual = max(terms.values())
        comp_ideal, mem_ideal = ideal_step_s(c["arch"], c["shape"], c["n_chips"])
        ideal = max(comp_ideal, mem_ideal)
        out.append({
            "arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
            "variant": c.get("variant", "baseline"),
            **{f"{k}_s": v for k, v in terms.items()},
            "dominant": rf["dominant"],
            "ideal_s": ideal,
            "roofline_frac": ideal / actual if actual else 0.0,
            "useful_flops": rf["useful_flops_ratio"],
        })
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    cells = [c for c in load_cells(args.dir) if c["mesh"] == args.mesh]
    rs = rows(cells)
    if args.markdown:
        print("| arch | shape | variant | compute_s | memory_s | collective_s | dominant | ideal_s | roofline_frac | useful_flops |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        for r in rs:
            print(f"| {r['arch']} | {r['shape']} | {r['variant']} | {r['compute_s']:.4f} | {r['memory_s']:.4f} "
                  f"| {r['collective_s']:.4f} | {r['dominant']} | {r['ideal_s']:.4f} "
                  f"| {r['roofline_frac']:.3f} | {(r['useful_flops'] or 0):.2f} |")
    else:
        print("arch,shape,compute_s,memory_s,collective_s,dominant,ideal_s,roofline_frac,useful_flops")
        for r in rs:
            print(f"{r['arch']},{r['shape']},{r['compute_s']:.4f},{r['memory_s']:.4f},"
                  f"{r['collective_s']:.4f},{r['dominant']},{r['ideal_s']:.4f},"
                  f"{r['roofline_frac']:.4f},{(r['useful_flops'] or 0):.3f}")


if __name__ == "__main__":
    main()
