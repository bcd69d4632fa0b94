"""The port's model substrate and model-backed ML families against the JAX
package: configs, the token pipeline, the dense transformer's logits, loss,
gradients and greedy decode (prefill, per-slot positions, ``prefill_into``),
AdamW, and the four families built from a trained model.

Weights are carried across as numpy (:func:`repro_torch.interop.params_from_numpy`):
the two packages draw their initial weights from different generators by
design.  A float32 copy of the reduced config is held tightly; the families'
own bf16 config by tolerance, because XLA keeps float32 precision across a
fused bf16 chain (``rmsnorm``, ``rope``, ``silu``) where torch rounds after
each op.  Observed on the reduced deepseek-7b (seed 0, CPU): float32 logits
within 5.2e-6 absolute, loss equal, every gradient leaf within 1.7e-6 of its
largest |g|; bf16 loss within 3.0e-5 relative and every gradient leaf at
cosine >= 0.9997.  The reference is imported inside the ``ref`` fixture, so
the card tests also run where JAX is absent.
"""
import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import path_str, tree_flatten_with_path, tree_leaves
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.eval import codecs as t_codecs
from repro_torch.eval import run as t_run
from repro_torch.eval import workloads as t_wl
from repro_torch.models.api import build_model
from repro_torch.optim import adamw

N_BYTES = 64 << 10
B, S = 4, 32
#: the reduced deepseek-7b's parameter leaves in the reference's order
LEAVES = ["embed", "final_norm/scale", "head"] + [
    f"stack/periods/slot0/{k}" for k in ("attn/wk", "attn/wo", "attn/wq", "attn/wv", "mlp/wd",
                                         "mlp/wg", "mlp/wu", "norm1/scale", "norm2/scale")]
DENSE = ("deepseek-7b", "gemma3-12b", "gemma3-27b", "llama3-405b")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's models, optimizer and ML families (skips without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs
    from repro.eval import codecs, run, workloads
    from repro.models.api import build_model as jbuild
    from repro.optim import adamw as jadamw

    return SimpleNamespace(jax=jax, jnp=jnp, configs=configs, build=jbuild, adamw=jadamw,
                           codecs=codecs, run=run, workloads=workloads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _np(ref, tree):
    return ref.jax.tree.map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(np.asarray(x).astype(np.float32))


def _batch(vocab: int, seed: int = 0) -> dict:
    pipe = TokenPipeline(PipelineConfig(vocab, S, B, seed=seed))
    return {"tokens": np.asarray(pipe.batch_at(0)["tokens"], np.int32)}


def _pair(ref, arch: str, dtype: str, seed: int = 0):
    """(reference model, its params, the port's model with them carried)."""
    cfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS[arch]), dtype=dtype)
    jm = ref.build(cfg)
    jp = jm.init(ref.jax.random.PRNGKey(seed))
    tm = build_model(dataclasses.replace(reduced(T_ARCHS[arch]), dtype=dtype), "cpu")
    tm.set_params(interop.params_from_numpy(_np(ref, jp), device="cpu"))
    return jm, jp, tm


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def carried(ref, request):
    """Both models on one carried init, with loss, logits and gradients."""
    dtype = request.param
    jm, jp, tm = _pair(ref, "deepseek-7b", dtype)
    batch = _batch(tm.cfg.vocab_size)
    jloss = float(jm.loss(jp, batch)[0])
    jgrads = ref.jax.grad(lambda p: jm.loss(p, batch)[0])(jp)
    tloss = tm.loss(batch)[0]
    tloss.backward()
    return SimpleNamespace(
        dtype=dtype, jm=jm, jp=jp, tm=tm, batch=batch, jloss=jloss, tloss=float(tloss.detach()),
        jlogits=_f32(jm.forward(jp, batch)), tlogits=_f32(tm.forward(batch)),
        jgrads={path_str(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)): _f32(g)
                for path, g in ref.jax.tree_util.tree_flatten_with_path(jgrads)[0]},
        tgrads={k: _f32(p.grad) for k, p in tm.flatten_params().items()})


@pytest.fixture(scope="module")
def ref_state(ref):
    """The reference's own ML-family state (seed 0) as numpy trees."""
    params, grads, state = ref.workloads._model_state(0)
    return _np(ref, params), _np(ref, grads), _np(ref, state)


# ---------------------------------------------------------------------------
# configs, pipeline, parameter tree
# ---------------------------------------------------------------------------

def test_configs_match_reference(ref):
    assert list(T_ARCHS) == list(ref.configs.ARCHS)
    for arch, jcfg in ref.configs.ARCHS.items():
        tcfg = get_config(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), arch
        assert dataclasses.asdict(reduced(tcfg)) == dataclasses.asdict(ref.configs.reduced(jcfg))
        assert (tcfg.head_dim_, tcfg.n_periods, tcfg.param_count(), tcfg.active_param_count()) \
            == (jcfg.head_dim_, jcfg.n_periods, jcfg.param_count(), jcfg.active_param_count())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


def test_pipeline_matches_reference(ref):
    from repro.data.pipeline import PipelineConfig as JConfig
    from repro.data.pipeline import TokenPipeline as JPipe

    for seed, step, host, n_hosts in ((0, 0, 0, 1), (3, 7, 1, 4), (11, 123, 2, 3)):
        a = JPipe(JConfig(512, 32, 4, seed=seed)).batch_at(step, host, n_hosts)["tokens"]
        b = TokenPipeline(PipelineConfig(512, 32, 4, seed=seed)).batch_at(step, host, n_hosts)
        np.testing.assert_array_equal(b["tokens"], a)


def test_parameter_tree_matches_reference(ref):
    """Names, leaf order, shapes and dtypes of the reduced deepseek-7b, its
    module paths, and the numpy bridge both ways."""
    jm, jp, tm = _pair(ref, "deepseek-7b", "bfloat16")
    flat = tm.flatten_params()
    assert list(flat) == LEAVES
    jleaves = ref.jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [(tuple(p.shape), str(p.dtype)) for p in flat.values()] == \
        [(tuple(x.shape), "torch." + str(x.dtype)) for _, x in jleaves]
    assert sum(p.numel() for p in tm.parameters()) == 459_392
    assert "stack.periods.slot0.attn.wq" in dict(tm.named_parameters())
    back = interop.params_to_numpy(tm.params())
    for (_, a), b in zip(jleaves, tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a).view(np.uint16))
    # a fresh init has the reference's shapes; its draws are the port's own
    fresh = build_model(reduced(T_ARCHS["deepseek-7b"]), "cpu")
    fresh.init(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in fresh.flatten_params().values()] == \
        [tuple(p.shape) for p in flat.values()]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_logits_match_reference(ref, arch):
    """Every dense config, float32 copy: gemma3's local windows, tail layers
    and tied embeddings included."""
    jm, jp, tm = _pair(ref, arch, "float32", seed=1)
    batch = _batch(tm.cfg.vocab_size, seed=1)
    np.testing.assert_allclose(_f32(tm.forward(batch)), _f32(jm.forward(jp, batch)),
                               rtol=0, atol=1e-4)
    assert tm.n_kv_layers == jm.n_kv_layers == tm.cfg.n_layers


def test_kv_cache_spec_matches_reference(ref):
    jm, _, tm = _pair(ref, "deepseek-7b", "bfloat16")
    j, t = jm.kv_cache_spec(64), tm.kv_cache_spec(64, resident_decode=True)
    assert (t.n_kv, t.head_dim, t.max_len, t.resident_decode) == \
        (j.n_kv, j.head_dim, j.max_len, True)
    assert dataclasses.asdict(t.fr) == dataclasses.asdict(j.fr)


# ---------------------------------------------------------------------------
# forward, loss, gradients (float32 tight, bf16 by tolerance)
# ---------------------------------------------------------------------------

def test_logits_match_reference(carried):
    atol = 1e-4 if carried.dtype == "float32" else 0.25
    np.testing.assert_allclose(carried.tlogits, carried.jlogits, rtol=0, atol=atol)


def test_loss_matches_reference(carried):
    rtol = 1e-5 if carried.dtype == "float32" else 1e-2
    assert abs(carried.tloss - carried.jloss) <= rtol * abs(carried.jloss)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients_match_reference(carried, leaf):
    """float32: within 1e-4 of the leaf's largest |g|; bf16: cosine >= 0.99."""
    j, t = carried.jgrads[leaf], carried.tgrads[leaf]
    assert t.shape == j.shape
    if carried.dtype == "float32":
        assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()
    else:
        cos = float((t * j).sum() / np.sqrt((t * t).sum() * (j * j).sum()))
        assert cos >= 0.99, cos


def test_greedy_decode_matches_reference(ref):
    """float32: prefill of rows 0-1, three decode steps, ``prefill_into`` of
    row 2 (rows 0-1 bit-stable), then five steps at staggered per-slot
    positions: the same greedy tokens as the reference at every step."""
    jnp = ref.jnp
    jm, jp, tm = _pair(ref, "deepseek-7b", "float32", seed=2)
    rng = np.random.default_rng(4)
    vocab, max_len = tm.cfg.vocab_size, 48
    prompt = rng.integers(0, vocab, (3, 8)).astype(np.int32)
    late = rng.integers(0, vocab, (3, 8)).astype(np.int32)
    first = np.array([True, True, False])

    jc, jl = jm.prefill_into(jp, {"tokens": prompt}, jm.init_cache(3, max_len), first)
    tc, tl = tm.prefill_into({"tokens": prompt}, tm.init_cache(3, max_len), torch.tensor(first))
    pos = np.array([8, 8, 0])
    jtok, ttok = np.argmax(_f32(jl)[:, -1], -1), _f32(tl)[:, -1].argmax(-1)
    assert (ttok == jtok)[first].all()
    steps = []
    for step in range(8):
        if step == 3:
            old = [x.clone() for x in tree_leaves(tc)]
            jc, jl = jm.prefill_into(jp, {"tokens": late}, jc, ~first)
            tc, tl = tm.prefill_into({"tokens": late}, tc, torch.tensor(~first))
            for o, n in zip(old, tree_leaves(tc)):      # period leaves: batch on axis 1
                assert torch.equal(o[:, :2], n[:, :2])
            jtok[2], ttok[2] = np.argmax(_f32(jl)[2, -1]), _f32(tl)[2, -1].argmax()
            pos[2] = 8
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(jtok[:, None].astype(np.int32))}, jc,
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step({"tokens": ttok[:, None]}, tc, torch.as_tensor(pos))
        jtok, ttok = np.argmax(_f32(jl)[:, 0], -1), _f32(tl)[:, 0].argmax(-1)
        live = first if step < 3 else np.ones(3, bool)
        assert (ttok == jtok)[live].all(), (step, ttok, jtok)
        steps.append(ttok.copy())
        pos += 1
    assert len({tuple(s) for s in steps}) > 1       # the tokens move


def test_local_window_decode_matches_reference(ref):
    """gemma3's ring-buffer windows: a prefill longer than the window, then
    scalar-position decode steps, float32."""
    jnp = ref.jnp
    jm, jp, tm = _pair(ref, "gemma3-12b", "float32", seed=3)
    prompt = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jc, jl = jm.prefill(jp, {"tokens": prompt}, jm.init_cache(2, 24))
    tc, tl = tm.prefill({"tokens": prompt}, tm.init_cache(2, 24))
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=1e-4)
    tok = np.argmax(_f32(jl)[:, -1], -1)
    for pos in range(12, 18):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok[:, None].astype(np.int32))}, jc,
                                jnp.int32(pos))
        tl, tc = tm.decode_step({"tokens": tok[:, None]}, tc, pos)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=1e-4)
        tok = np.argmax(_f32(jl)[:, 0], -1)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_apply_updates_matches_reference(ref, ref_state):
    """One step on the reference's carried params, grads and (non-zero)
    state, float32 throughout: within 1e-6 relative."""
    params, grads, state = ref_state
    f32 = lambda t: ref.jax.tree.map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    params, grads = f32(params), f32(grads)
    acfg = ref.adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jp, js, jm = ref.adamw.apply_updates(acfg, params, grads, state)
    tcfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tp, ts, tm = adamw.apply_updates(tcfg, interop.params_from_numpy(params, "cpu"),
                                     interop.params_from_numpy(grads, "cpu"),
                                     interop.state_from_numpy(state, "cpu"))
    assert int(ts["step"]) == int(js["step"]) == 3
    for key in ("grad_norm", "lr"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-6 * abs(float(jm[key]))
    for jt, tt in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for a, b in zip(ref.jax.tree.leaves(jt), tree_leaves(tt)):
            a, b = np.asarray(a), _f32(b)
            assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max()


def test_adamw_keeps_dtypes_and_float32_moments(ref):
    _, _, tm = _pair(ref, "deepseek-7b", "bfloat16")
    params = tm.params()
    state = adamw.init_state(params)
    grads = params
    norm = float(np.sqrt(sum((_f32(g) ** 2).sum() for g in tree_leaves(grads))))
    new, state, metrics = adamw.apply_updates(adamw.AdamWConfig(), params, grads, state)
    assert all(a.dtype == torch.bfloat16 for a in tree_leaves(new))
    assert all(m.dtype == torch.float32 for m in tree_leaves(state["m"]) + tree_leaves(state["v"]))
    assert float(metrics["grad_norm"]) == pytest.approx(norm, rel=1e-5)
    assert float(adamw.schedule(adamw.AdamWConfig(), torch.tensor(0))) == 0.0


# ---------------------------------------------------------------------------
# the model-backed ML families
# ---------------------------------------------------------------------------

def test_throughput_set_matches_reference(ref):
    assert t_run.THROUGHPUT_WORKLOADS == ref.run.THROUGHPUT_WORKLOADS


def test_ml_registry_matches_reference(ref):
    jreg, treg = ref.workloads.default_workloads("/no/such/dir"), t_wl.default_workloads(
        "/no/such/dir")
    assert [(w.name, w.kind, w.word_bits, w.description) for w in treg.select("ml")] == \
        [(w.name, w.kind, w.word_bits, w.description) for w in jreg.select("ml")]
    assert t_wl.MODEL_FAMILIES == tuple(n for n, *_ in ref.workloads._ML_FAMILIES[:4])


@pytest.mark.parametrize("n_bytes", [N_BYTES, 4 << 20])
@pytest.mark.parametrize("family", t_wl.MODEL_FAMILIES)
def test_ml_streams_byte_equal_on_carried_state(ref, ref_state, family, n_bytes):
    """The reference's final state carried across: the same bytes, trimmed at
    64 KiB and tiled at 4 MiB (past every tree's size)."""
    params, grads, state = ref_state
    got = t_wl.ml_streams(interop.params_from_numpy(params, "cpu"),
                          interop.params_from_numpy(grads, "cpu"),
                          interop.state_from_numpy(state, "cpu"), n_bytes)[family]
    want = getattr(ref.workloads, family)(n_bytes, 0)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def port_state_cells(ref):
    """Cells of the four families at 64 KiB: the reference's own state, and
    the port's state trained from the reference's carried initial weights."""
    _, _, tm = _pair(ref, "deepseek-7b", "bfloat16", seed=0)
    streams = t_wl.ml_streams(*t_wl.train_state(tm, 0), N_BYTES)
    jreg = ref.workloads.default_workloads("/no/such/dir")
    jc, tc = ref.codecs.default_codecs(), t_codecs.default_codecs("cpu")
    out = {}
    for name in t_wl.MODEL_FAMILIES:
        wl = jreg.get(name)
        jcells = [ref.run.evaluate_cell(wl, jc.make(c, wl.word_bits), wl.generate(N_BYTES, 0),
                                        repeats=1) for c in ("gbdi", "bdi", "fr")]
        tcells = [t_run.evaluate_cell(wl, tc.make(c, wl.word_bits), streams[name], repeats=1)
                  for c in ("gbdi", "bdi", "fr")]
        out[name] = (jcells, tcells)
    return out


@pytest.mark.parametrize("family", t_wl.MODEL_FAMILIES)
def test_ml_ratios_of_port_state_match_reference(port_state_cells, family):
    """bf16 forward and backward in torch against XLA's: every ratio of the
    port-trained state within 2 % of the reference's (observed: within
    0.3 %)."""
    for j, t in zip(*port_state_cells[family]):
        assert t.verified and j.verified
        assert abs(t.compression_ratio - j.compression_ratio) <= 0.02 * j.compression_ratio, \
            (t.codec, t.compression_ratio, j.compression_ratio)


def test_own_init_families_are_deterministic_and_follow_the_device_rule():
    reg = t_wl.default_workloads("/no/such/dir", device="cpu")
    a = [reg.get(n).generate(8192, 0) for n in t_wl.MODEL_FAMILIES]
    b = [reg.get(n).generate(8192, 0) for n in t_wl.MODEL_FAMILIES]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.dtype for x in a] == [np.uint32, np.uint16, np.uint32, np.uint16]
    assert not np.array_equal(a[0], reg.get("ml_weights_fp32").generate(8192, 1))
    # the registry's device rule: the card unless the CPU is asked for
    with (contextlib.nullcontext() if torch.cuda.is_available()
          else pytest.raises(RuntimeError, match="no CUDA device")):
        t_wl.default_workloads("/no/such/dir").get("ml_grads_bf16").generate(8192, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_model_families_on_card(cuda_device):
    """The reduced model trains on the card; its four families go through
    gbdi, bdi and fr there (kernels A and B), every cell verified."""
    from repro_torch import obs

    def launches():
        got = obs.snapshot(spans=False)["counters"]
        return got["launches.encode"], got["launches.decode"]

    reg = t_wl.default_workloads("/no/such/dir")
    enc0, dec0 = launches()
    cells = t_run.evaluate(reg, t_codecs.default_codecs(), suite=",".join(t_wl.MODEL_FAMILIES),
                           codecs="gbdi,bdi,fr", n_bytes=1 << 20, repeats=1)
    assert len(cells) == 12 and all(c.verified and c.device.startswith("NVIDIA") for c in cells)
    enc1, dec1 = launches()
    assert enc1 > enc0 and dec1 > dec0
    params, grads, state = t_wl._model_state(0, str(cuda_device))
    assert all(p.device.type == "cuda" for p in tree_leaves(params) + tree_leaves(grads))


@pytest.mark.cuda
def test_carried_model_on_card_matches_cpu(cuda_device):
    """One carried init: the card's loss within bf16 tolerance of the CPU's,
    every gradient leaf at cosine >= 0.99."""
    cfg = reduced(T_ARCHS["deepseek-7b"])
    cpu = build_model(cfg, "cpu")
    cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg)
    card.set_params(interop.params_from_numpy(interop.params_to_numpy(cpu.params()), cuda_device))
    batch = _batch(cfg.vocab_size)
    losses = []
    for m in (cpu, card):
        loss = m.loss(batch)[0]
        loss.backward()
        losses.append(float(loss.detach()))
    assert abs(losses[1] - losses[0]) <= 1e-2 * abs(losses[0])
    for (path, a), b in zip(tree_flatten_with_path(cpu.params()), tree_leaves(card.params())):
        ga, gb = _f32(a.grad), _f32(b.grad)
        assert float((ga * gb).sum() / np.sqrt((ga * ga).sum() * (gb * gb).sum())) >= 0.99, path
