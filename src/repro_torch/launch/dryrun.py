"""Multi-pod dry-run: count every (arch x shape x mesh) cell on fake tensors.

PyTorch counterpart of :mod:`repro.launch.dryrun`, which lowers and compiles
each cell's step against ``ShapeDtypeStruct`` inputs and reads XLA's cost
and memory analyses.  Here :func:`count_cell` runs the port's real step
function (``make_train_step`` with loss, backward and AdamW; ``Model.prefill``;
``Model.decode_step``) at the cell's global shape on the fake tensors of
:mod:`repro_torch.launch.specs`, under the op counter of
:mod:`repro_torch.launch.op_stats`, and :func:`analyse` turns the count into
the reference's record:

  * ``flops_per_chip`` / ``bytes_per_chip``: the global count over the
    mesh's chips (``"per_chip": "global/n_chips"``), not a traced
    per-device program;
  * collective wire bytes from the placements of
    :mod:`repro_torch.distributed.sharding` (``"collective_model":
    "placements"``): each parameter leaf sharded over ``data`` is
    all-gathered over ``data`` once in forward and, in training, once in
    backward, for every micro-batch; in training the gradients are
    reduce-scattered over ``data`` (all-reduced where a leaf is replicated
    over it) and all-reduced over ``pod``; every dot whose weight has its
    contracted dim sharded over ``model`` has its output all-reduced over
    ``model``.  Each collective takes the ring formulas of
    :func:`repro_torch.launch.op_stats.ring_wire_bytes`;
  * ``memory_analysis``: one device's argument bytes from the specs, and a
    peak of arguments, gradients (training) and the largest leaf gathered
    over ``data``; activations are not placed, so they are not counted;
  * the three roofline terms on the H100 constants of
    :mod:`repro_torch.launch.mesh`, and MODEL_FLOPS (6ND / 2ND) over the
    count.

FLOPs and bytes do not depend on the mesh, so :func:`main` counts each
(arch, shape) once and derives every mesh's record from that count.  The
MoE dispatch runs its global (one-shard) path.

It runs on the host by design: fake tensors carry shapes, dtypes and
strides and allocate nothing, so the count needs no device.  This is not a
CPU fallback of a device path.

``--fit`` counts a cell whose op count grows with its sequence length (the
sLSTM's time loop, the 128-token chunk loops of Mamba2 and the mLSTM) at
three short lengths, fits F(S) = a + b*S + c*S^2 exactly, checks the fit at
a fourth length and evaluates it at the cell's (:func:`count_cell_fit`), the
counterpart of the reference multiplying a loop body by its trip count.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --fit --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from fractions import Fraction
from pathlib import Path
from typing import Any

from repro_torch._tree import tree_leaves
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_stats, specs
from repro_torch.launch.mesh import (
    HBM_BW,
    PEAK_FLOPS_BF16,
    RING_BW_PER_GPU,
    production_axis_sizes,
)
from repro_torch.models.api import build_model
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.moe import NO_DROP_ASSIGNMENTS
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import make_train_step

#: the token chunk of the Mamba2 and mLSTM loops (their ``chunk`` default)
RECURRENT_CHUNK = 128
_RECURRENT = ("mamba", "mlstm", "slstm")
_CHUNKED = ("mamba", "mlstm")
_ATTENTION = ("attn", "local", "shared_attn")


def runs_long_context(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic stacks (DESIGN.md §5)."""
    return not all(s.mixer in ("attn", "shared_attn") for s in cfg.pattern)


def cell_skipped(cfg: ModelConfig, sc: ShapeConfig) -> str | None:
    if sc.name == "long_500k" and not runs_long_context(cfg):
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


@dataclasses.dataclass
class CellCount:
    """One (arch, shape)'s global count."""
    flops: int
    hbm_bytes: int
    tp_allreduce_bytes: int
    seconds: float
    #: the cell's input tree (fake tensors), for the placements
    tree: dict
    counted_at: list[int] | None = None
    top_ops: list[dict] | None = None


def cell_step(cfg: ModelConfig, sc: ShapeConfig, n_micro: int = 4, device: Any = "cpu"):
    """(fake input tree, thunk running the cell's step on it; run it under
    :func:`repro_torch.launch.specs.fake_mode`)."""
    model = build_model(cfg, device)
    tree = specs.input_specs(cfg, sc, device, model)
    if sc.kind == "train":
        step = make_train_step(model, AdamWConfig(), n_micro=n_micro)
        return tree, lambda: step(tree["params"], tree["opt_state"], tree["batch"])
    if sc.kind == "prefill":
        return tree, lambda: model.prefill(tree["batch"], tree["cache"])
    # the port's decode step takes its position as a host integer: the last slot
    return tree, lambda: model.decode_step(tree["step_in"], tree["cache"], sc.seq_len - 1)


def count_cell(cfg: ModelConfig, sc: ShapeConfig, n_micro: int = 4, *,
               axis_sizes: dict[str, int] | None = None, device: Any = "cpu") -> CellCount:
    """The global FLOPs and HBM bytes of the cell's step at its own shape,
    and the output bytes of the dots a TP program all-reduces over
    ``model`` under ``axis_sizes``' parameter specs."""
    axis_sizes = axis_sizes or production_axis_sizes()
    t0 = time.time()
    tree, run = cell_step(cfg, sc, n_micro, device)
    watch = (tree["params"], shd.params_specs(tree["params"], axis_sizes), "model")
    with specs.fake_mode():
        _, stats = op_stats.count(run, watch=watch)
    return CellCount(stats.flops, stats.hbm_bytes, stats.tp_allreduce_bytes,
                     time.time() - t0, tree, top_ops=op_stats.top_ops(stats, 10))


def _regime(cfg: ModelConfig, sc: ShapeConfig, S: int, n_micro: int) -> tuple:
    """The code paths a length takes; a fit holds only within one.  A loop
    of one chunk is a regime of its own: its views keep size-1 dims, which
    changes where ``einsum`` copies."""
    mixers = {s.mixer for s in cfg.pattern}
    tokens = (sc.global_batch // n_micro if sc.kind == "train" else sc.global_batch) * S
    return (
        bool(cfg.n_experts) and tokens * cfg.top_k <= NO_DROP_ASSIGNMENTS,
        bool(mixers & set(_ATTENTION)) and S // cfg.q_chunk > 1,
        bool(mixers & set(_CHUNKED)) and S // RECURRENT_CHUNK > 1,
        sc.kind == "train" and S // cfg.loss_chunk > 1,
        "local" in mixers and sc.kind != "train" and S <= cfg.window,
    )


def fit_lengths(cfg: ModelConfig, sc: ShapeConfig, n_micro: int = 4) -> list[int]:
    """Four lengths, multiples of every chunk size the step uses, in the
    cell's regime: three to fit, the fourth to check."""
    mixers = {s.mixer for s in cfg.pattern}
    unit = 1
    if mixers & set(_CHUNKED):
        unit = math.lcm(unit, RECURRENT_CHUNK)
    if mixers & set(_ATTENTION):
        unit = math.lcm(unit, cfg.q_chunk)
    if sc.kind == "train":
        unit = math.lcm(unit, cfg.loss_chunk)
    want = _regime(cfg, sc, sc.seq_len, n_micro)
    for k in range(2, sc.seq_len // unit):
        lengths = [unit * (k + i) for i in range(4)]
        if all(_regime(cfg, sc, s, n_micro) == want for s in lengths):
            return lengths
    raise ValueError(f"no fit lengths for {cfg.arch_id} x {sc.name}")


def _quadratic_at(points: list[tuple[int, int]], x: int) -> Fraction:
    """The quadratic through three ``(S, F)`` points, evaluated at ``x``."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(points):
        term = Fraction(yi)
        for j, (xj, _) in enumerate(points):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def count_cell_fit(cfg: ModelConfig, sc: ShapeConfig, n_micro: int = 4, *,
                   axis_sizes: dict[str, int] | None = None, device: Any = "cpu") -> CellCount:
    """:func:`count_cell` at the cell's length from an exact quadratic fit
    over three shorter lengths, checked at a fourth; raises where the fit
    does not reproduce the fourth count or gives a fraction."""
    lengths = fit_lengths(cfg, sc, n_micro)
    counts = [count_cell(cfg, dataclasses.replace(sc, seq_len=s), n_micro,
                         axis_sizes=axis_sizes, device=device) for s in lengths]
    fields = ("flops", "hbm_bytes", "tp_allreduce_bytes")
    out = {}
    for f in fields:
        points = [(s, getattr(c, f)) for s, c in zip(lengths[:3], counts[:3])]
        check = _quadratic_at(points, lengths[3])
        if check != getattr(counts[3], f):
            raise ValueError(f"{cfg.arch_id} x {sc.name}: the fit of {f} over {lengths[:3]} "
                             f"gives {check} at {lengths[3]}, the count {getattr(counts[3], f)}")
        value = _quadratic_at(points, sc.seq_len)
        if value.denominator != 1:
            raise ValueError(f"{cfg.arch_id} x {sc.name}: the fit of {f} is {value} at "
                             f"{sc.seq_len}, not an integer")
        out[f] = int(value)
    return CellCount(**out, seconds=sum(c.seconds for c in counts),
                     tree=specs.input_specs(cfg, sc, device), counted_at=lengths)


def fit_saves_work(cfg: ModelConfig, sc: ShapeConfig, n_micro: int = 4) -> bool:
    """True where the cell has a recurrent loop and the fit's four lengths
    together are shorter than the cell's."""
    if sc.kind == "decode" or not {s.mixer for s in cfg.pattern} & set(_RECURRENT):
        return False
    try:
        return sum(fit_lengths(cfg, sc, n_micro)) < sc.seq_len
    except ValueError:
        return False


def _dp(axis_sizes: dict[str, int]) -> int:
    return math.prod(axis_sizes[a] for a in shd.batch_axes(axis_sizes))


def collective_bytes(params: Any, p_specs: Any, axis_sizes: dict[str, int], sc: ShapeConfig,
                     tp_allreduce_bytes: int, n_micro: int) -> dict[str, float]:
    """Wire bytes one chip sends in one step, by collective kind (see the
    module docstring for the model)."""
    D, M, pod = axis_sizes["data"], axis_sizes["model"], axis_sizes.get("pod", 1)
    wire = op_stats.ring_wire_bytes
    train = sc.kind == "train"
    gathers = 2 * n_micro if train else 1
    coll = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for leaf, spec in zip(tree_leaves(params), shd.spec_leaves(p_specs)):
        shard = math.prod(shd.shard_shape(leaf.shape, spec, axis_sizes)) * leaf.element_size()
        on_data = "data" in shd.spec_axes(spec)
        if on_data:
            coll["all-gather"] += gathers * wire("all-gather", 0, shard * D, D)
        if train:
            if on_data:
                coll["reduce-scatter"] += wire("reduce-scatter", shard * D, 0, D)
            else:
                coll["all-reduce"] += wire("all-reduce", shard, 0, D)
            coll["all-reduce"] += wire("all-reduce", shard, 0, pod)
    # the activations are split over the DP axes where the batch divides them
    dp = _dp(axis_sizes) if sc.global_batch % _dp(axis_sizes) == 0 else 1
    coll["all-reduce"] += wire("all-reduce", tp_allreduce_bytes / dp, 0, M)
    coll["total"] = sum(coll.values())
    return coll


def memory_analysis(tree: dict, axis_sizes: dict[str, int], sc: ShapeConfig) -> dict:
    """One device's bytes under the specs: the arguments, and a peak of the
    arguments, the gradients (training) and the largest leaf gathered over
    ``data``."""
    p = tree["params"]
    p_specs = shd.params_specs(p, axis_sizes)
    args = shd.per_device_bytes(p, p_specs, axis_sizes)
    if "opt_state" in tree:
        st = tree["opt_state"]
        args += 2 * shd.per_device_bytes(st["m"], p_specs, axis_sizes) + st["step"].element_size()
    for key in ("batch", "step_in"):
        if key in tree:
            args += shd.per_device_bytes(tree[key], shd.batch_specs(tree[key], axis_sizes),
                                         axis_sizes)
    if "cache" in tree:
        args += shd.per_device_bytes(tree["cache"], shd.cache_specs(tree["cache"], axis_sizes),
                                     axis_sizes)
    grads = shd.per_device_bytes(p, p_specs, axis_sizes) if sc.kind == "train" else 0
    gathered = max((math.prod(shd.shard_shape(leaf.shape, s, axis_sizes)) * leaf.element_size()
                    * axis_sizes["data"]
                    for leaf, s in zip(tree_leaves(p), shd.spec_leaves(p_specs))
                    if "data" in shd.spec_axes(s)), default=0)
    return {"argument_bytes": args, "peak_bytes": args + grads + gathered,
            "peak_model": "arguments + gradients (train) + largest leaf gathered over data"}


def analyse(cfg: ModelConfig, sc: ShapeConfig, mesh_name: str, count: CellCount,
            axis_sizes: dict[str, int], *, n_micro: int = 4) -> dict:
    """The reference's record for one mesh, from one (arch, shape) count."""
    n_chips = math.prod(axis_sizes.values())
    tree = count.tree
    p_specs = shd.params_specs(tree["params"], axis_sizes)
    coll = collective_bytes(tree["params"], p_specs, axis_sizes, sc, count.tp_allreduce_bytes,
                            n_micro)
    flops = count.flops / n_chips
    bytes_accessed = count.hbm_bytes / n_chips

    toks = sc.global_batch * (sc.seq_len if sc.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    model_flops_per_chip = (6 if sc.kind == "train" else 2) * n_active * toks / n_chips

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll["total"] / RING_BW_PER_GPU
    dominant = max(("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
                   key=lambda kv: kv[1])[0]
    rec = {
        "arch": cfg.arch_id,
        "shape": sc.name,
        "mesh": mesh_name,
        "n_chips": n_chips,
        "axis_sizes": dict(axis_sizes),
        "ok": True,
        "count_seconds": count.seconds,
        "n_micro": n_micro if sc.kind == "train" else None,
        "per_chip": "global/n_chips",
        "collective_model": "placements",
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_accessed,
        "collective_wire_bytes": coll,
        "memory_analysis": memory_analysis(tree, axis_sizes, sc),
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": dominant,
            "model_flops_per_chip": model_flops_per_chip,
            "useful_flops_ratio": model_flops_per_chip / flops if flops else None,
        },
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "params_tree": sum(t.numel() for t in tree_leaves(tree["params"])),
    }
    if count.counted_at:
        rec["counted_at"] = count.counted_at
    if count.top_ops:
        rec["top_ops"] = count.top_ops
    return rec


def _mesh_axes(mesh_name: str, mesh_shape: tuple[int, ...] | None) -> dict[str, int]:
    if mesh_shape is None:
        return production_axis_sizes(multi_pod=mesh_name == "multipod")
    names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    return dict(zip(names, mesh_shape))


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: Path, *, n_micro: int = 4,
             variant: str = "", overrides: dict | None = None,
             mesh_shape: tuple[int, ...] | None = None, fit: bool = False,
             counts: dict | None = None, cfg: ModelConfig | None = None,
             sc: ShapeConfig | None = None) -> dict:
    """Count (or take from ``counts``, a memo keyed by (arch, shape, data,
    model)) and write one cell's JSON; ``cfg`` and ``sc`` replace the named
    config and shape."""
    cfg = cfg or get_config(arch)
    sc = sc or SHAPES[shape]
    suffix = f"__{variant}" if variant else ""
    out_path = Path(out_dir) / f"{arch}__{shape}__{mesh_name}{suffix}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    skip = cell_skipped(cfg, sc)
    if skip:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": True, "skipped": skip}
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[OK] {arch} x {shape} x {mesh_name}{suffix} skip={skip}", flush=True)
        return rec
    try:
        cfg = dataclasses.replace(cfg, **(overrides or {}))
        axis_sizes = _mesh_axes(mesh_name, mesh_shape)
        key = (arch, shape, axis_sizes["data"], axis_sizes["model"])
        counts = counts if counts is not None else {}
        if key not in counts:
            use_fit = fit and fit_saves_work(cfg, sc, n_micro)
            counter = count_cell_fit if use_fit else count_cell
            counts[key] = counter(cfg, sc, n_micro, axis_sizes=axis_sizes)
        rec = analyse(cfg, sc, mesh_name, counts[key], axis_sizes, n_micro=n_micro)
        rec["variant"] = variant or "baseline"
        rec["overrides"] = {k: str(v) for k, v in (overrides or {}).items()}
        if mesh_shape is not None:
            rec["mesh_shape"] = list(mesh_shape)
    except Exception:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False,
               "variant": variant or "baseline", "error": traceback.format_exc(limit=25)}
    out_path.write_text(json.dumps(rec, indent=2))
    status = "OK" if rec.get("ok") else "FAIL"
    print(f"[{status}] {arch} x {shape} x {mesh_name}{suffix}"
          f" ({rec.get('count_seconds', 0):.1f}s)", flush=True)
    return rec


def _parse_overrides(pairs: list[str]) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--variant", default="", help="suffix recorded in the cell JSON")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override, e.g. --set q_chunk=1024")
    ap.add_argument("--mesh-shape", default=None,
                    help="override mesh, e.g. 4,64 (single-pod hillclimb variants)")
    ap.add_argument("--fit", action="store_true",
                    help="count recurrent cells at three short lengths and fit")
    args = ap.parse_args(argv)

    overrides = _parse_overrides(args.set)
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = sorted(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]

    failures = 0
    suffix = f"__{args.variant}" if args.variant else ""
    counts: dict = {}
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                out_path = out_dir / f"{arch}__{shape}__{mesh_name}{suffix}.json"
                if args.skip_existing and out_path.exists():
                    if json.loads(out_path.read_text()).get("ok"):
                        continue
                rec = run_cell(arch, shape, mesh_name, out_dir, n_micro=args.n_micro,
                               variant=args.variant, overrides=overrides,
                               mesh_shape=mesh_shape, fit=args.fit, counts=counts)
                failures += 0 if rec.get("ok") else 1
    print(f"done; failures={failures}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
