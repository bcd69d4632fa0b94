"""The port's xLSTM mixers (``repro_torch.models.xlstm``) against the JAX
package's ``repro.models.xlstm``, on carried weights and the same numpy
inputs, at the reduced xlstm-1.3b's width (d_model 128, 4 heads).

For the mLSTM and the sLSTM: training (the mLSTM over two chunks and over
the single-chunk fallback), prefill's recurrent cache and three decode steps
from it.  Tolerances, float32: outputs and caches within 1e-5 of their
largest magnitude, every gradient leaf (and the input's) within 1e-5 of its
largest magnitude; bf16: the output within 2e-2 of its largest magnitude.

The mLSTM's chunked form takes ``exp`` of the decay matrix before masking it
(``src/repro/models/xlstm.py:101``); in the masked entries that ``exp`` of a
positive sum of ``-log f`` overflows float32 once a chunk's sum passes about
88, and ``where`` then sends ``0 * inf = NaN`` into the gradient.  The port
keeps the forward identical, so it shares the fault:
:func:`test_mlstm_gradient_goes_nan_with_the_reference` holds both packages
to it (``ROADMAP.md`` §3).  Observed errors are in ``PERF.md`` §6.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import xlstm

B = 2
TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs
    from repro.models import xlstm as jxlstm

    return SimpleNamespace(jax=jax, jnp=jnp, configs=configs, x=jxlstm)


def _setup(ref, kind: str, dtype: str = "float32"):
    jnp = ref.jnp
    jcfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS["xlstm-1.3b"]), dtype=dtype)
    tcfg = dataclasses.replace(reduced(ARCHS["xlstm-1.3b"]), dtype=dtype)
    jdt = jnp.dtype(dtype)
    init = getattr(ref.x, f"{kind}_init")
    jp = ref.jax.jit(lambda k: init(k, jcfg, jdt))(ref.jax.random.PRNGKey(4))
    tp = interop.params_from_numpy(ref.jax.tree.map(np.asarray, jp), device="cpu")
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jdt=jdt, jp=jp, tp=tp,
                           japply=getattr(ref.x, f"{kind}_apply"),
                           tapply=getattr(xlstm, f"{kind}_apply"))


def _u(S: int, d: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(np.asarray(x).astype(np.float32))


def _close(got, want, tol: float = TOL) -> None:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _grads(ref, s, u: np.ndarray, **kw):
    """Reference and port gradients of sum(out * c) w.r.t. params and input."""
    c = np.random.default_rng(2).standard_normal(u.shape).astype(np.float32)
    jc = ref.jnp.asarray(c)

    def jloss(p, x):
        return (s.japply(p, s.jcfg, x, **kw)[0] * jc).sum()

    jout = ref.jax.jit(lambda p, x: s.japply(p, s.jcfg, x, **kw)[0])(s.jp, u)
    jgp, jgu = ref.jax.jit(ref.jax.grad(jloss, argnums=(0, 1)))(s.jp, ref.jnp.asarray(u))
    for leaf in tree_leaves(s.tp):
        leaf.requires_grad_(True)
    tu = torch.from_numpy(u).requires_grad_(True)
    tout, _ = s.tapply(s.tp, s.tcfg, tu, **kw)
    (tout * torch.from_numpy(c)).sum().backward()
    jgrads = dict(tree_flatten_with_path(ref.jax.tree.map(np.asarray, jgp)))
    return SimpleNamespace(jout=jout, tout=tout, jgu=jgu, tgu=tu.grad,
                           pairs=[(path, leaf.grad, jgrads[path])
                                  for path, leaf in tree_flatten_with_path(s.tp)])


@pytest.mark.parametrize("kind, S, chunk", [("mlstm", 32, 16), ("mlstm", 40, 128),
                                            ("slstm", 40, None)])
def test_train_forward_and_gradients_match_reference(ref, kind, S, chunk):
    """mLSTM: S = 32 in two chunks of 16 and S = 40, the single-chunk
    fallback (short enough that the gradient stays finite, see
    :func:`test_mlstm_gradient_goes_nan_with_the_reference`); sLSTM: 40
    time steps."""
    s = _setup(ref, kind)
    g = _grads(ref, s, _u(S, s.jcfg.d_model), **({"chunk": chunk} if chunk else {}))
    _close(g.tout, g.jout)
    _close(g.tgu, g.jgu)
    for path, t, j in g.pairs:
        assert np.isfinite(_f32(j)).all(), path
        _close(t, j)


def test_mlstm_long_forward_matches_reference(ref):
    """S = 256: two chunks of the default 128."""
    s = _setup(ref, "mlstm")
    u = _u(256, s.jcfg.d_model)
    jout, _ = ref.jax.jit(lambda p, x: s.japply(p, s.jcfg, x))(s.jp, u)
    with torch.no_grad():
        tout, _ = s.tapply(s.tp, s.tcfg, torch.from_numpy(u))
    assert np.isfinite(_f32(tout)).all()
    _close(tout, jout)


@pytest.mark.parametrize("S, nan", [(64, False), (128, True), (256, True)])
def test_mlstm_gradient_goes_nan_with_the_reference(ref, S, nan):
    """The reference's own gradient is NaN once a 128-token chunk's masked
    decay overflows (S >= 128 here); the port, with the same forward, gives
    NaN in the same leaves, and finite equal gradients where the reference's
    are finite."""
    s = _setup(ref, "mlstm")
    g = _grads(ref, s, _u(S, s.jcfg.d_model))
    _close(g.tout, g.jout)
    jnan = {path for path, _, j in g.pairs if not np.isfinite(_f32(j)).all()}
    tnan = {path for path, t, _ in g.pairs if not np.isfinite(_f32(t)).all()}
    assert tnan == jnan
    assert bool(jnan) == nan
    if not nan:
        for _, t, j in g.pairs:
            _close(t, j)


@pytest.mark.parametrize("kind, S", [("mlstm", 256), ("mlstm", 40), ("slstm", 40)])
def test_prefill_cache_and_three_decode_steps_match_reference(ref, kind, S):
    s = _setup(ref, kind)
    d = s.jcfg.d_model
    jinit, tinit = getattr(ref.x, f"{kind}_cache_init"), getattr(xlstm, f"{kind}_cache_init")
    jcache0 = jinit(s.jcfg, B)
    tcache0 = tinit(s.tcfg, B, CPU)
    assert [(k, tuple(v.shape), v.dtype) for k, v in sorted(tcache0.items())] == \
        [(k, tuple(v.shape), torch.float32) for k, v in sorted(jcache0.items())]
    u = _u(S, d)
    japply = ref.jax.jit(lambda p, x, c: s.japply(p, s.jcfg, x, cache=c))
    jdec = ref.jax.jit(lambda p, x, c: s.japply(p, s.jcfg, x, cache=c, decode=True))
    jout, jc = japply(s.jp, u, jcache0)
    with torch.no_grad():
        tout, tc = s.tapply(s.tp, s.tcfg, torch.from_numpy(u), cache=tcache0)
        _close(tout, jout)
        for key in jc:
            _close(tc[key], jc[key])
        for step in range(3):
            x = _u(1, d, seed=10 + step)
            jo, jc = jdec(s.jp, x, jc)
            to, tc = s.tapply(s.tp, s.tcfg, torch.from_numpy(x), cache=tc, decode=True)
            _close(to, jo)
            for key in jc:
                _close(tc[key], jc[key])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_matches_reference_by_tolerance(ref, kind):
    s = _setup(ref, kind, dtype="bfloat16")
    u = _u(40, s.jcfg.d_model)
    jout, _ = ref.jax.jit(lambda p, x: s.japply(p, s.jcfg, x))(
        s.jp, ref.jnp.asarray(u).astype(s.jdt))
    with torch.no_grad():
        tout, _ = s.tapply(s.tp, s.tcfg, torch.from_numpy(u).to(torch.bfloat16))
    assert tout.dtype == torch.bfloat16
    _close(tout, jout, tol=2e-2)


def test_slstm_ffn_is_tanh_gelu_at_the_reference_width(ref):
    assert xlstm.slstm_ff(128) == 128 and xlstm.slstm_ff(2048) == 2688
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(ref.jax.nn.gelu(x))
    gelu = torch.nn.functional.gelu
    np.testing.assert_allclose(gelu(torch.from_numpy(x), approximate="tanh").numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4   # erf is not it
