"""The port's launch tools against the JAX package's ``repro.launch``.

``repro_torch.launch.specs`` builds the fake input trees the reference
builds with ``jax.eval_shape``; ``op_stats`` counts dot FLOPs and bytes op by
op and holds the reference's ring formulas; ``dryrun`` keeps the
reference's skips and record and fits the cells whose op count grows with
the sequence.  Everything runs on fake tensors or small CPU tensors.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from repro_torch._tree import tree_flatten_with_path
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import dryrun, op_stats, specs
from repro_torch.models.api import build_model
from repro_torch.models.config import SHAPES, LayerSpec, ShapeConfig

#: the reference's record keys (``repro.launch.dryrun.analyse`` and
#: ``run_cell``) that only an XLA compile produces: its cost analysis, the
#: f32x2 legalisation switch, and the compile time (the port records
#: ``count_seconds``)
XLA_ONLY = {"xla_cost_analysis", "roofline_dtype", "compile_seconds"}
REF_KEYS = {"arch", "shape", "mesh", "n_chips", "ok", "compile_seconds", "flops_per_chip",
            "bytes_per_chip", "collective_wire_bytes", "xla_cost_analysis", "memory_analysis",
            "roofline", "params_total", "params_active", "variant", "overrides",
            "roofline_dtype"}
REF_ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                     "model_flops_per_chip", "useful_flops_ratio"}


@pytest.fixture(scope="module")
def ref():
    import jax

    from repro.configs import get_config
    from repro.launch import specs as rspecs
    from repro.models.api import build_model as rbuild

    @functools.lru_cache(maxsize=None)
    def params(arch):
        return rspecs.params_specs(rbuild(get_config(arch)))

    return jax, rspecs, rbuild, get_config, params


def _leaves(tree, key):
    return [(tuple(str(k) for k in path), tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
            for path, leaf in key(tree)]


def _ref_leaves(jax, tree):
    return _leaves(tree, lambda t: [
        (tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path), leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]])


def _port_leaves(tree):
    return _leaves(tree, tree_flatten_with_path)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_reference_eval_shape(ref, arch):
    jax, rspecs, rbuild, get_config, params = ref
    cfg, rcfg = ARCHS[arch], get_config(arch)
    model = build_model(cfg, "cpu")
    p = specs.params_specs(model)
    assert _port_leaves(p) == _ref_leaves(jax, params(arch))
    assert _port_leaves(specs.opt_state_specs(p)) == _ref_leaves(
        jax, rspecs.opt_state_specs(params(arch)))
    for sc in SHAPES.values():
        for fn in ("train_batch_specs", "prefill_batch_specs", "decode_step_specs"):
            assert _port_leaves(getattr(specs, fn)(cfg, sc)) == _ref_leaves(
                jax, getattr(rspecs, fn)(rcfg, sc)), (fn, sc.name)
    sc = SHAPES["decode_32k"]
    assert _port_leaves(specs.cache_specs(model, sc.global_batch, sc.seq_len)) == _ref_leaves(
        jax, rspecs.cache_specs(rbuild(rcfg), sc.global_batch, sc.seq_len))
    tree = specs.input_specs(cfg, sc, model=model)
    assert sorted(tree) == ["cache", "params", "pos", "step_in"]
    assert tuple(tree["pos"].shape) == () and tree["pos"].dtype == torch.int32


def test_op_counter_dot_flops_views_and_in_place():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(8, 16, generator=g), torch.randn(16, 4, generator=g)
    x, y = torch.randn(3, 8, 16, generator=g), torch.randn(3, 16, 4, generator=g)
    _, st = op_stats.count(torch.mm, a, b)
    assert st.flops == 2 * 8 * 4 * 16
    assert st.hbm_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    _, st = op_stats.count(torch.bmm, x, y)
    assert st.flops == 2 * 3 * 8 * 4 * 16
    _, st = op_stats.count(torch.einsum, "bmk,bkn->bmn", x, y)
    assert st.flops == 2 * 3 * 8 * 4 * 16
    # views and metadata move nothing
    _, st = op_stats.count(lambda t: t.view(16, 8).t().unsqueeze(0).expand(5, 8, 16), a)
    assert st.hbm_bytes == 0 and st.flops == 0
    # in place: the operand is read once and written once
    c = a.clone()
    _, st = op_stats.count(c.add_, a)
    assert st.hbm_bytes == 3 * a.numel() * 4
    # copy_ and fills write their operand without reading it
    _, st = op_stats.count(c.copy_, a)
    assert st.hbm_bytes == 2 * a.numel() * 4
    _, st = op_stats.count(c.zero_)
    assert st.hbm_bytes == a.numel() * 4
    # a gather reads its indices and the rows it takes, not the table
    idx = torch.tensor([1, 3])
    _, st = op_stats.count(lambda: a[idx])
    assert st.hbm_bytes == 2 * 8 + 2 * 2 * 16 * 4
    # a broadcast operand is read once
    _, st = op_stats.count(torch.add, a, b[:1, :1].expand(8, 16))
    assert st.hbm_bytes == (2 * a.numel() + 1) * 4


def test_op_counter_all_reduces_dots_that_contract_a_model_sharded_dim():
    """Megatron's pattern: a dot whose weight is split over ``model`` on
    the dim it contracts (row-parallel, or a column-parallel weight's
    transpose in backward) all-reduces its output; one split on the other
    dim does not.  The weight may reach the dot as a view."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 8, generator=g)
    params = {"w": torch.randn(2, 8, 16, generator=g)}   # (layers, in, out)
    out_bytes = 4 * 6 * 16 * 4
    for spec, fn, want in [
        ((None, "model", None), lambda w: x @ w[1], out_bytes),
        ((None, None, "model"), lambda w: x @ w[1], 0),
        ((None, None, "model"), lambda w: torch.randn(4, 6, 16, generator=g) @ w[0].t(),
         4 * 6 * 8 * 4),
        ((None, "model", None), lambda w: torch.einsum("bsd,df->bsf", x, w[0]), out_bytes),
    ]:
        _, st = op_stats.count(fn, params["w"], watch=(params, {"w": spec}, "model"))
        assert st.tp_allreduce_bytes == want, spec


def test_ring_formulas_give_the_reference_walker_numbers():
    """``tests/test_hlo_stats.py::test_collective_wire_bytes_ring_model``: 7
    iterations of ``(c @ w) @ w.T`` with x over data=2 and w over model=4
    (local c (32, 256), w (256, 64)) all-reduce a (32, 256) f32 block over
    4 devices each iteration."""
    exp_flops = 7 * (2 * 32 * 64 * 256 + 2 * 32 * 256 * 64)
    exp_ar = 7 * 2 * 32 * 256 * 4 * 3 / 4
    g = torch.Generator().manual_seed(0)
    c, w = torch.randn(32, 256, generator=g), torch.randn(256, 64, generator=g)

    def body():
        out = c
        for _ in range(7):
            out = (out @ w) @ w.T
        return out

    _, st = op_stats.count(body)
    assert st.flops == exp_flops
    assert 7 * op_stats.ring_wire_bytes("all-reduce", 32 * 256 * 4, 0, 4) == exp_ar
    assert op_stats.ring_wire_bytes("all-gather", 0, 400, 4) == 300
    assert op_stats.ring_wire_bytes("reduce-scatter", 400, 0, 4) == 300
    assert op_stats.ring_wire_bytes("all-to-all", 400, 0, 4) == 300
    assert op_stats.ring_wire_bytes("collective-permute", 400, 0, 4) == 400


def test_cell_skipped_matches_reference(ref):
    jax = ref[0]
    jax.devices()  # the reference's dryrun sets XLA_FLAGS on import; the backend is up already
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    get_config = ref[3]
    for arch in ARCHS:
        rcfg = get_config(arch)
        for sc in SHAPES.values():
            assert dryrun.cell_skipped(ARCHS[arch], sc) == rdryrun.cell_skipped(rcfg, sc)
        assert dryrun.runs_long_context(ARCHS[arch]) == rdryrun.runs_long_context(rcfg)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_run_cell_writes_the_reference_record(tmp_path, kind):
    """The reference test's cell (``tests/test_launch.py``): reduced
    gemma3-12b, seq 64, batch 4, on a 2 x 2 mesh."""
    cfg = dataclasses.replace(reduced(ARCHS["gemma3-12b"]), dtype="float32")
    sc = ShapeConfig(f"tiny_{kind}", seq_len=64, global_batch=4, kind=kind)
    rec = dryrun.run_cell("gemma3-12b", sc.name, "tiny", tmp_path, n_micro=1, mesh_shape=(2, 2),
                          cfg=cfg, sc=sc)
    assert rec["ok"], rec.get("error")
    assert REF_KEYS - XLA_ONLY <= set(rec)
    assert REF_ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert rec["n_chips"] == 4 and rec["per_chip"] == "global/n_chips"
    assert rec["collective_model"] == "placements"
    assert rec["collective_wire_bytes"]["total"] > 0
    assert rec["memory_analysis"]["peak_bytes"] >= rec["memory_analysis"]["argument_bytes"] > 0
    assert json.loads((tmp_path / f"gemma3-12b__{sc.name}__tiny.json").read_text()) == rec


@pytest.mark.parametrize("arch,pattern", [
    ("xlstm-1.3b", (LayerSpec("mlstm", "none"),)),
    ("xlstm-1.3b", (LayerSpec("slstm", "none"),)),
    ("zamba2-7b", (LayerSpec("mamba", "none"), LayerSpec("shared_attn", "none"))),
])
def test_fit_equals_the_direct_count_at_a_fifth_length(arch, pattern):
    """The reduced config cut to one layer of each mixer kind (the mLSTM's
    chunk loop, the sLSTM's time loop, Mamba2's chunk loop beside the
    shared attention, its query chunk raised to the recurrent chunk to keep
    the op count small): the exact quadratic over three lengths, checked at
    a fourth, gives the direct count at a fifth."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), pattern=pattern, n_layers=len(pattern),
                              q_chunk=dryrun.RECURRENT_CHUNK)
    lengths = dryrun.fit_lengths(cfg, ShapeConfig("x", 4096, 1, "prefill"))
    fifth = lengths[-1] + (lengths[1] - lengths[0])
    sc = ShapeConfig("x", fifth, 1, "prefill")
    fit = dryrun.count_cell_fit(cfg, sc)
    direct = dryrun.count_cell(cfg, sc)
    assert fit.counted_at == lengths
    assert (fit.flops, fit.hbm_bytes, fit.tp_allreduce_bytes) == (
        direct.flops, direct.hbm_bytes, direct.tp_allreduce_bytes)


def test_cli_writes_json_and_exits_zero(tmp_path, capsys):
    out = tmp_path / "cells"
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "paligemma-3b", "--shape", "decode_32k", "--mesh", "both",
                     "--set", "n_layers=1", "--out", str(out)])
    assert exc.value.code == 0
    recs = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
    assert [r["mesh"] for r in recs] == ["multipod", "pod"]
    assert all(r["ok"] and r["flops_per_chip"] > 0 for r in recs)
    # one count, two meshes: the same global work split over 512 and 256 chips
    assert recs[0]["flops_per_chip"] * 512 == recs[1]["flops_per_chip"] * 256
    assert "failures=0" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "paligemma-3b", "--shape", "long_500k", "--out", str(out)])
    assert exc.value.code == 0
    assert json.loads((out / "paligemma-3b__long_500k__pod.json").read_text())["skipped"]
    assert np.isfinite(recs[1]["roofline"]["compute_s"])
