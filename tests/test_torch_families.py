"""The six configs past the dense family (mixtral-8x22b and qwen3-moe-235b-a22b
(moe), zamba2-7b (hybrid: Mamba2 + a shared attention block), xlstm-1.3b
(ssm), paligemma-3b (vlm: a patch-embedding prefix) and musicgen-large (audio:
frame embeddings in, four codebook heads out)) in the port against the JAX
package, at their reduced sizes (``configs.reduced``).

Weights are carried across as numpy: the two packages draw their initial
weights from different generators by design.  Tolerances: a float32 copy
of each config is held tightly, logits within 1e-4 of max(1, their largest
magnitude) and every gradient leaf within 1e-4 of its largest |g| (the
float32 bound of ``tests/test_torch_models.py``).  The bf16 config: loss
within 1e-2 relative and every gradient leaf at cosine >= 0.99, the bounds
of that file; where a leaf falls below (XLA keeps float32 across a fused
bf16 chain where torch rounds after each op, a bf16 router can pick another
expert for a token, and the mLSTM amplifies rounding), the port's bf16 must
be as close to the float32 result on the same weights as the reference's
bf16 is (the tests' docstrings give the margins); serving consistency
(decode at S against the forward at S + 1) at ``tests/test_models_smoke.py``'s
0.15 in bf16 and within 1e-4 in float32.  Greedy decode and the ``Engine`` are held on float32 copies:
greedy tokens equal at every step.  The trainer, checkpoints and CLIs of
these families are in ``tests/test_torch_zoo_training.py``.  Observed errors
are in ``PERF.md`` §6.

The reference runs under ``jax.jit``: one compile costs less on the CPU than
the first eager dispatch of each op.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import path_str, tree_flatten_with_path
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.eval import ingest as t_ingest
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scheduler import Scheduler

FAMILIES = ("mixtral-8x22b", "qwen3-moe-235b-a22b", "zamba2-7b", "xlstm-1.3b",
            "paligemma-3b", "musicgen-large")
#: one MoE, the hybrid and the ssm config: the engine cases
TOKEN_TRIO = ("mixtral-8x22b", "zamba2-7b", "xlstm-1.3b")
B, S = 2, 32
F32_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the models here are small, and on a host shared
    with other test workers torch's thread pool contends more than it helps."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs
    from repro.eval import ingest as jingest
    from repro.models.api import build_model as jbuild
    from repro.serving import engine as jengine
    from repro.serving.scheduler import Scheduler as JScheduler

    return SimpleNamespace(jax=jax, jnp=jnp, configs=configs, build=jbuild, engine=jengine,
                           Scheduler=JScheduler, ingest=jingest)


def _np(ref, tree):
    return ref.jax.tree.map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(np.asarray(x).astype(np.float32))


def _jpaths(ref, tree) -> dict:
    return {path_str(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p)): v
            for p, v in ref.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed: int = 0, seq: int = S) -> dict:
    """A numpy batch of ``seq`` positions in the family's layout (vlm: the
    patch prefix counts toward them, as in ``tests/test_models_smoke.py``)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frame_embeds": rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, seq, cfg.n_codebooks))
                .astype(np.int32)}
    n_tok = seq - cfg.n_patches if cfg.family == "vlm" else seq
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _to_ref(ref, tree):
    """A tree of port tensors as the reference's arrays, dtypes kept."""
    jnp = ref.jnp
    return ref.jax.tree.map(
        lambda t: jnp.asarray(t.detach().float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


#: the reference's jitted float32 init of each reduced config, compiled once
_REF_INITS: dict = {}


def _ref_init(ref, arch: str, dtype: str, seed: int):
    """The reference's init of the reduced ``arch`` in ``dtype``.  Its init
    draws every leaf in float32 and casts it to the leaf's dtype, so the
    bf16 init is the float32 one cast leaf by leaf, bit for bit: one compile
    a config serves both dtypes and every seed."""
    if arch not in _REF_INITS:
        cfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS[arch]), dtype="float32")
        _REF_INITS[arch] = ref.jax.jit(ref.build(cfg).init)
    key = ref.jax.random.PRNGKey(seed)
    params = _REF_INITS[arch](key)
    if dtype == "float32":
        return params
    cfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS[arch]), dtype=dtype)
    like = ref.jax.eval_shape(ref.build(cfg).init, key)
    return ref.jax.tree.map(lambda x, want: x.astype(want.dtype), params, like)


def _pair(ref, arch: str, dtype: str, seed: int = 0):
    """(reference model, its params, the port's model with them carried)."""
    cfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS[arch]), dtype=dtype)
    jm = ref.build(cfg)
    jp = _ref_init(ref, arch, dtype, seed)
    tm = build_model(dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype), "cpu")
    tm.set_params(interop.params_from_numpy(_np(ref, jp), device="cpu"))
    return jm, jp, tm


@pytest.fixture(scope="module")
def runs() -> dict:
    """:func:`_carried`'s results, kept for the module."""
    return {}


def _carried(ref, runs: dict, arch: str, dtype: str):
    """Both models on one carried init: logits, loss and every gradient,
    computed once a module.  A bf16 entry also holds the float32 forward and
    gradients of its own (bf16-valued) weights, from the float32 entry's
    compiled reference, as the yardstick both packages' bf16 are held to."""
    key = (arch, dtype)
    if key in runs:
        return runs[key]
    jm, jp, tm = _pair(ref, arch, dtype, seed=1)
    batch = _batch(tm.cfg, seed=1)
    jax = ref.jax
    # one compile for the loss, its gradients and the logits
    jrun = jax.jit(lambda p, b: (*jax.value_and_grad(lambda q: jm.loss(q, b)[0])(p),
                                 jm.forward(p, b)))
    jloss, jgrads, jlogits = jrun(jp, batch)
    tloss = tm.loss(batch)[0]
    tloss.backward()
    c = SimpleNamespace(
        jm=jm, jp=jp, tm=tm, jrun=jrun, jloss=float(jloss),
        tloss=float(tloss.detach()), jlogits=_f32(jlogits),
        tlogits=_f32(tm.forward(batch)),
        jgrads={k: _f32(g) for k, g in _jpaths(ref, jgrads).items()},
        tgrads={k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None else _f32(p.grad))
                for k, p in tm.flatten_params().items()})
    if dtype == "bfloat16":
        f32 = _carried(ref, runs, arch, "float32")
        p32 = ref.jax.tree.map(lambda x: x.astype(ref.jnp.float32), jp)
        _, grads32, logits32 = f32.jrun(p32, batch)
        c.logits32 = _f32(logits32)
        c.grads32 = {k: _f32(g) for k, g in _jpaths(ref, grads32).items()}
    runs[key] = c
    return c


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


# ---------------------------------------------------------------------------
# parameter trees, KV geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_parameter_tree_matches_reference(ref, arch):
    """Paths, leaf order, shapes and dtypes of a fresh init in each package
    (bf16, the float32 router / SSM / gate leaves included), and the numpy
    bridge both ways."""
    jm, jp, tm = _pair(ref, arch, "bfloat16")
    fresh = build_model(reduced(ARCHS[arch]), "cpu")
    fresh.init(torch.Generator().manual_seed(0))
    jleaves = _jpaths(ref, jp)
    want = [(k, tuple(v.shape), str(v.dtype)) for k, v in jleaves.items()]
    for model in (tm, fresh):
        got = [(k, tuple(p.shape), str(p.dtype).removeprefix("torch."))
               for k, p in model.flatten_params().items()]
        assert got == want
    assert sum(p.numel() for p in fresh.parameters()) == sum(v.size for v in jleaves.values())
    back = dict(tree_flatten_with_path(interop.params_to_numpy(tm.params())))
    for k, v in jleaves.items():
        v = np.asarray(v)
        want_np = v.view(np.uint16) if v.dtype.name == "bfloat16" else v
        np.testing.assert_array_equal(back[tuple(int(s) if s.isdigit() else s
                                                 for s in k.split("/"))], want_np)
    if arch == "zamba2-7b":
        assert "stack/shared/attn/wq" in jleaves and "stack/periods/slot6/norm1/scale" in jleaves


@pytest.mark.parametrize("arch", FAMILIES)
def test_kv_geometry_matches_reference(ref, arch):
    """``n_kv_layers`` (zamba2's ``shared_attn`` slots counted) and the
    published config's ``kv_cache_spec``; zamba2's 3,584-word row neither
    divides nor is divided by a 2,048-word page, and both packages refuse it."""
    jm, tm = ref.build(ref.configs.ARCHS[arch]), build_model(get_config(arch), "cpu")
    assert tm.n_kv_layers == jm.n_kv_layers
    red = build_model(reduced(ARCHS[arch]), "cpu")
    assert red.n_kv_layers == ref.build(ref.configs.reduced(ref.configs.ARCHS[arch])).n_kv_layers
    j, t = jm.kv_cache_spec(2048), tm.kv_cache_spec(2048)
    assert (t.n_kv, t.head_dim, t.max_len) == (j.n_kv, j.head_dim, j.max_len)
    if arch == "zamba2-7b":
        assert (t.row_words, tm.n_kv_layers) == (3584, 11)
        with pytest.raises(AssertionError):
            j.page_tokens
        with pytest.raises(ValueError, match="divide one another"):
            t.page_tokens
    else:
        assert t.page_tokens == j.page_tokens and t.n_pages == j.n_pages


def test_scheduler_refuses_zamba2_geometry_as_the_reference(ref):
    """The reduced zamba2 with its published attention geometry (32 KV heads
    of 112): the reference's ``Scheduler`` asserts, the port's raises."""
    over = dict(n_heads=32, n_kv_heads=32, head_dim=112)
    jcfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS["zamba2-7b"]), **over)
    jm = ref.build(jcfg)
    tm = build_model(dataclasses.replace(reduced(ARCHS["zamba2-7b"]), **over), "cpu")
    jeng = ref.engine.Engine(jm, _to_ref(ref, tm.init(torch.Generator().manual_seed(0))),
                             batch_slots=1, max_len=8)
    with pytest.raises(AssertionError):
        ref.Scheduler(jeng, byte_budget=1 << 30)
    with pytest.raises(ValueError, match="divide one another"):
        Scheduler(Engine(tm, batch_slots=1, max_len=8), byte_budget=1 << 30)


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_logits_match_reference(ref, runs, arch, dtype):
    """float32: within 1e-4 of max(1, the largest |logit|).  bf16: no
    further from the float32 forward of the same weights than the
    reference's bf16 is (largest and rms error each within 1.25x the
    reference's plus 0.01): a bf16 router may pick another expert for a
    token in either package, and the mLSTM amplifies rounding alike in both."""
    c = _carried(ref, runs, arch, dtype)
    assert c.tlogits.shape == c.jlogits.shape
    if c.tm.cfg.n_codebooks:
        assert c.tlogits.shape == (B, S, c.tm.cfg.n_codebooks, c.tm.cfg.vocab_size)
    if dtype == "float32":
        scale = max(1.0, float(np.abs(c.jlogits).max()))
        assert np.abs(c.tlogits - c.jlogits).max() <= F32_TOL * scale
    else:
        et, ej = np.abs(c.tlogits - c.logits32), np.abs(c.jlogits - c.logits32)
        assert et.max() <= 1.25 * ej.max() + 0.01
        assert np.sqrt((et ** 2).mean()) <= 1.25 * np.sqrt((ej ** 2).mean()) + 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_reference(ref, runs, arch, dtype):
    c = _carried(ref, runs, arch, dtype)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    assert np.isfinite(c.tloss) and abs(c.tloss - c.jloss) <= rtol * abs(c.jloss)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_reference(ref, runs, arch, dtype):
    """float32: every leaf within 1e-4 of its largest |g|.  bf16: every leaf
    the loss reads at cosine >= 0.99 to the reference's, or else at least as
    close to the float32 gradient of the same weights as the reference's is
    (cosine within 0.02).  zamba2's ``shared_attn`` slot norms get zero in
    both packages."""
    c = _carried(ref, runs, arch, dtype)
    assert sorted(c.tgrads) == sorted(c.jgrads)
    for k, j in c.jgrads.items():
        t = c.tgrads[k]
        assert t.shape == j.shape and np.isfinite(t).all(), k
        if not np.abs(j).max():
            assert not np.abs(t).max(), k
        elif dtype == "float32":
            assert np.abs(t - j).max() <= F32_TOL * np.abs(j).max(), k
        elif _cos(t, j) < 0.99:
            g32 = c.grads32[k]
            assert _cos(t, g32) >= _cos(j, g32) - 0.02, (k, _cos(t, j), _cos(t, g32), _cos(j, g32))


# ---------------------------------------------------------------------------
# serving: greedy decode, prefill_into, consistency
# ---------------------------------------------------------------------------

def _step_in(cfg, tok: np.ndarray, rng) -> dict:
    if cfg.family == "audio":
        return {"frame_embeds": rng.standard_normal((tok.shape[0], 1, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": tok[:, None].astype(np.int32)}


def _close_logits(got: np.ndarray, want: np.ndarray) -> None:
    assert np.abs(got - want).max() <= F32_TOL * max(1.0, float(np.abs(want).max()))


def _greedy(logits: np.ndarray) -> np.ndarray:
    """The greedy token of each row (audio: of its first codebook)."""
    last = logits[:, -1]
    return (last[:, 0] if last.ndim == 3 else last).argmax(-1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_decode_and_prefill_into_match_reference(ref, arch):
    """float32: prefill of rows 0-1, three decode steps at per-slot
    positions, ``prefill_into`` of row 2 with rows 0-1 bit-stable in every
    cache leaf (KV, SSM state, conv tail, mLSTM and sLSTM state), then two
    steps of all three rows: the same greedy tokens, and logits within 1e-4,
    at every step."""
    jnp = ref.jnp
    jm, jp, tm = _pair(ref, arch, "float32", seed=2)
    cfg = tm.cfg
    B3, max_len = 3, 48
    first = np.array([True, True, False])
    prompt = _batch(dataclasses.replace(cfg), seed=4, seq=12)
    late = _batch(dataclasses.replace(cfg), seed=5, seq=12)
    prompt, late = ({k: np.concatenate([v, v[:1]]) for k, v in b.items()} for b in (prompt, late))
    jpi, jdec = ref.jax.jit(jm.prefill_into), ref.jax.jit(jm.decode_step)
    jc, jl = jpi(jp, prompt, jm.init_cache(B3, max_len), first)
    tc, tl = tm.prefill_into(prompt, tm.init_cache(B3, max_len), torch.tensor(first))
    _close_logits(_f32(tl)[first], _f32(jl)[first])
    tok = _greedy(_f32(jl))
    pos = np.array([12, 12, 0])
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for step in range(5):
        if step == 3:
            old = dict(tree_flatten_with_path(tc))
            jc, jl = jpi(jp, late, jc, ~first)
            tc, tl = tm.prefill_into(late, tc, torch.tensor(~first))
            for path, new in tree_flatten_with_path(tc):
                rows = (slice(None), slice(0, 2)) if path[0] == "periods" else (slice(0, 2),)
                assert torch.equal(old[path][rows], new[rows]), path
            _close_logits(_f32(tl)[2], _f32(jl)[2])
            tok[2] = _greedy(_f32(jl))[2]
            pos[2] = 12
        live = first if step < 3 else np.ones(3, bool)
        jl, jc = jdec(jp, {k: jnp.asarray(v) for k, v in _step_in(cfg, tok, rng_j).items()}, jc,
                      jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(_step_in(cfg, tok, rng_t), tc, torch.as_tensor(pos))
        jlog, tlog = _f32(jl), _f32(tl)
        _close_logits(tlog[live], jlog[live])
        tok = _greedy(jlog)
        assert (_greedy(tlog) == tok)[live].all(), (step, _greedy(tlog), tok)
        pos += 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_consistency(ref, arch, dtype):
    """prefill(S) then decode(1) agrees with a full forward at S + 1, as
    ``tests/test_models_smoke.py:69`` holds the reference: within its 0.15
    in bf16 (the port's own init), within 1e-4 in float32."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype)
    tm = build_model(cfg, "cpu")
    tm.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, seed=2)
    rng = np.random.default_rng(3)
    cache, _ = tm.prefill(batch, tm.init_cache(B, S + 4))
    if cfg.family == "audio":
        step = {"frame_embeds": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)}
        full = {"frame_embeds": np.concatenate([batch["frame_embeds"], step["frame_embeds"]], 1),
                "targets": np.pad(batch["targets"], ((0, 0), (0, 1), (0, 0)))}
    else:
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        step = {"tokens": nxt}
        full = {**batch, "tokens": np.concatenate([batch["tokens"], nxt], 1)}
    with torch.no_grad():
        dec, _ = tm.decode_step(step, cache, S)
        fwd = tm.forward(full)
    a, b = _f32(dec[:, 0]), _f32(fwd[:, -1])
    assert np.isfinite(a).all()
    if dtype == "float32":
        assert np.abs(a - b).max() <= F32_TOL * max(1.0, np.abs(b).max())
    else:
        np.testing.assert_allclose(a, b, rtol=0.15, atol=0.15)


def test_xlstm_bf16_decode_at_full_depth_drifts_as_the_reference(ref):
    """xlstm-1.3b's 48 layers at the reduced width, bf16, the port's init
    carried to the reference: prefill of 32 tokens, one decode step, and the forward
    at 33.  In bf16 both packages' decode drifts far from the float32
    decode of the same weights at this depth (the port's float32 decode is
    the yardstick: it is held to the reference's at 1e-4 above).  The port's
    bf16 decode is no further from it than the reference's bf16 decode is,
    and the port's decode-vs-forward difference (relative L2 a row) no
    larger than the reference's own; each within 1.25x the reference's plus
    0.01, the bound of the bf16 logits test."""
    jax, jnp = ref.jax, ref.jnp
    cfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS["xlstm-1.3b"]),
                              n_layers=48, dtype="bfloat16")
    jm = ref.build(cfg)
    init = build_model(dataclasses.replace(reduced(ARCHS["xlstm-1.3b"]), n_layers=48,
                                           dtype="bfloat16"), "cpu")
    jp = _to_ref(ref, init.init(torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    full = {"tokens": np.concatenate([tok, nxt], 1)}

    def serve(p):
        cache, _ = jm.prefill(p, {"tokens": tok}, jm.init_cache(B, S + 4))
        return jm.decode_step(p, {"tokens": jnp.asarray(nxt)}, cache, S)[0][:, 0], \
            jm.forward(p, full)[:, -1]

    jdec, jfwd = (_f32(x) for x in jax.jit(serve)(jp))          # one compile
    out = {}
    for dtype in ("bfloat16", "float32"):
        tm = build_model(dataclasses.replace(reduced(ARCHS["xlstm-1.3b"]), n_layers=48,
                                             dtype=dtype), "cpu")
        tm.set_params(interop.params_from_numpy(
            _np(ref, jax.tree.map(lambda x: x.astype(jnp.float32) if dtype == "float32"
                                  else x, jp)), device="cpu"))
        with torch.no_grad():
            tc, _ = tm.prefill({"tokens": tok}, tm.init_cache(B, S + 4))
            out[dtype] = (_f32(tm.decode_step({"tokens": nxt}, tc, S)[0][:, 0]),
                          _f32(tm.forward(full)[:, -1]))
    (tdec, tfwd), (dec32, _) = out["bfloat16"], out["float32"]
    et, ej = np.abs(tdec - dec32), np.abs(jdec - dec32)
    assert et.max() <= 1.25 * ej.max() + 0.01
    assert np.sqrt((et ** 2).mean()) <= 1.25 * np.sqrt((ej ** 2).mean()) + 0.01

    def drift(dec, fwd):
        return float((np.linalg.norm(dec - fwd, axis=-1) / np.linalg.norm(fwd, axis=-1)).max())

    assert drift(tdec, tfwd) <= 1.25 * drift(jdec, jfwd) + 0.01


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TOKEN_TRIO)
def test_engine_tokens_match_reference(ref, arch):
    """Float32 carried weights: a batched admit, two ticks, a mid-decode
    admit of another prompt length (one more request than slots), and the
    drain: every request's tokens, ``done`` and the per-slot positions
    equal after every call."""
    jm, jp, tm = _pair(ref, arch, "float32", seed=3)
    je = ref.engine.Engine(jm, jp, batch_slots=3, max_len=32)
    te = Engine(tm, batch_slots=3, max_len=32)
    rng = np.random.default_rng(6)
    specs = [(i, rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32), m)
             for i, (n, m) in enumerate([(8, 5), (8, 4), (5, 6), (11, 3)])]
    pairs = []

    def admit(group):
        jr = [ref.engine.Request(i, p.copy(), max_new=m) for i, p, m in group]
        tr = [Request(i, p.copy(), max_new=m) for i, p, m in group]
        n = te.admit(tr)
        assert n == je.admit(jr)
        pairs.extend(zip(jr[:n], tr[:n]))
        check()
        return n

    def check():
        np.testing.assert_array_equal(te.slot_pos, je.slot_pos)
        assert [r and r.rid for r in te.slot_req] == [r and r.rid for r in je.slot_req]
        for jr, tr in pairs:
            assert (tr.out, tr.done) == (jr.out, jr.done), tr.rid

    assert admit(specs[:2]) == 2
    for _ in range(2):
        assert te.tick() == je.tick()
        check()
    assert admit(specs[2:]) == 1
    ticks = 0
    while True:
        more = te.tick()
        assert more == je.tick()
        check()
        ticks += 1
        if not more:
            break
        assert ticks < 64
    assert admit(specs[3:]) == 1
    while te.tick():
        assert je.tick()
        check()
    assert all(tr.done and len(tr.out) == tr.max_new for _, tr in pairs)


def test_capture_of_params_and_recurrent_caches_matches_reference(ref):
    """``capture_pytree`` over carried zamba2 parameters and its prefilled
    serving cache (KV, SSM state, conv tail) and an xlstm cache: the
    reference's segment names, order and bytes."""
    images = []
    for arch in ("zamba2-7b", "xlstm-1.3b"):
        jm, jp, tm = _pair(ref, arch, "bfloat16", seed=4)
        batch = _batch(tm.cfg, seed=4, seq=8)
        jc, _ = ref.jax.jit(jm.prefill)(jp, batch, jm.init_cache(B, 16))
        tc, _ = tm.prefill(batch, tm.init_cache(B, 16))
        for name, jtree, ttree in ((f"{arch}-params", jp, tm.params()),
                                   (f"{arch}-cache", jc, tc)):
            j = ref.ingest.capture_pytree(jtree, name)
            t = t_ingest.capture_pytree(ttree, name)
            assert [s.name for s in t.segments] == [s.name for s in j.segments]
            assert t.word_bits == j.word_bits
            images.append((t, j, name))
    for t, j, name in images:
        if name.endswith("params"):   # carried: byte-equal
            assert [s.data.tobytes() for s in t.segments] == \
                [s.data.tobytes() for s in j.segments]
        else:                         # computed in bf16 by two libraries
            for ts, js in zip(t.segments, j.segments):
                assert ts.data.shape == js.data.shape and ts.data.dtype == js.data.dtype
    assert any("state@float32" in s.name for s in images[1][0].segments)
    assert any("conv@bfloat16" in s.name for s in images[1][0].segments)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_card_matches_cpu(arch):
    """One CPU float32 init carried to the card: logits within 1e-3 of the
    CPU's (TF32-free float32, other summation orders), the loss within 1e-4
    relative, and a finite gradient on every leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    cpu = build_model(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg, "cuda")
    card.set_params({k: v for k, v in _to(params, "cuda").items()})
    batch = _batch(cfg, seed=1)
    with torch.no_grad():
        a, b = _f32(card.forward(batch)), _f32(cpu.forward(batch))
    assert np.abs(a - b).max() <= 1e-3 * max(1.0, np.abs(b).max())
    loss = card.loss(batch)[0]
    loss.backward()
    assert abs(float(loss.detach()) - float(cpu.loss(batch)[0].detach())) <= \
        1e-4 * abs(float(loss.detach()))
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in card.parameters())


def _to(tree, device):
    return {k: (_to(v, device) if isinstance(v, dict) else
                [_to(x, device) for x in v] if isinstance(v, list) else
                v.detach().to(device)) for k, v in tree.items()}


def test_fresh_families_train_one_step_finite():
    """Every new family's own bf16 init: a loss and a full gradient tree
    (zeros where the loss never reads a leaf), finite."""
    for arch in FAMILIES:
        tm = build_model(reduced(ARCHS[arch]), "cpu")
        tm.init(torch.Generator().manual_seed(5))
        loss = tm.loss(_batch(tm.cfg, seed=6))[0]
        loss.backward()
        assert np.isfinite(float(loss.detach())), arch
        assert all(p.grad is None or torch.isfinite(p.grad).all() for p in tm.parameters())
        unread = [k for k, p in tm.flatten_params().items() if p.grad is None]
        assert unread == (["stack/periods/slot6/norm1/scale"] if arch == "zamba2-7b" else [])
