"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against the JAX
package's ``repro.models.mamba2``, on carried weights and the same numpy
inputs, at the reduced zamba2-7b's width (d_model 128: 4 SSD heads of 64,
state 16).

Training at S = 256 (two chunks of 128) and S = 40 (not a multiple of the
chunk: the single-chunk fallback), prefill's recurrent cache, and three
decode steps from it.  Tolerances, float32: outputs and caches within 1e-5
of their largest magnitude, every gradient leaf (and the input's) within
1e-5 of its largest magnitude; bf16: the output within 2e-2 of its largest
magnitude.  Observed errors are in ``PERF.md`` §6.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import mamba2

B = 2
TOL = 1e-5


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
    from repro.models import mamba2 as jmamba

    return SimpleNamespace(jax=jax, jnp=jnp, configs=configs, m=jmamba)


def _setup(ref, dtype: str = "float32", seed: int = 0):
    jnp = ref.jnp
    jcfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS["zamba2-7b"]), dtype=dtype)
    tcfg = dataclasses.replace(reduced(ARCHS["zamba2-7b"]), dtype=dtype)
    jdt = jnp.dtype(dtype)
    jp = ref.jax.jit(lambda k: ref.m.mamba_init(k, jcfg, jdt))(ref.jax.random.PRNGKey(seed))
    # a non-trivial dt_bias and D, so both float32 leaves carry signal
    jp = {**jp, "dt_bias": jnp.linspace(-1.0, 1.0, jp["dt_bias"].shape[0], dtype=jnp.float32),
          "D": jnp.linspace(0.5, 1.5, jp["D"].shape[0], dtype=jnp.float32)}
    tp = interop.params_from_numpy(ref.jax.tree.map(np.asarray, jp), device="cpu")
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jdt=jdt, tdt=getattr(torch, dtype), jp=jp, tp=tp)


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


def test_softplus_is_jax_softplus(ref):
    """``logaddexp(x, 0)`` on both sides of torch's threshold of 20."""
    x = np.linspace(-40, 40, 2001, dtype=np.float32)
    np.testing.assert_allclose(mamba2.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.jax.nn.softplus(x)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("S", [256, 40])
def test_train_forward_and_gradients_match_reference(ref, S):
    """S = 256 runs two chunks of 128; S = 40 falls back to one chunk."""
    s = _setup(ref)
    u = _u(S, s.jcfg.d_model)
    c = np.random.default_rng(2).standard_normal((B, S, s.jcfg.d_model)).astype(np.float32)
    jc = ref.jnp.asarray(c)

    def jloss(p, x):
        return (ref.m.mamba_apply(p, s.jcfg, x)[0] * jc).sum()

    jout, jcache = ref.jax.jit(lambda p, x: ref.m.mamba_apply(p, s.jcfg, x))(s.jp, u)
    jgp, jgu = ref.jax.jit(ref.jax.grad(jloss, argnums=(0, 1)))(s.jp, ref.jnp.asarray(u))
    for leaf in tree_leaves(s.tp):
        leaf.requires_grad_(True)
    tu = torch.from_numpy(u).requires_grad_(True)
    tout, tcache = mamba2.mamba_apply(s.tp, s.tcfg, tu)
    assert jcache is None and tcache is None
    _close(tout, jout)
    (tout * torch.from_numpy(c)).sum().backward()
    _close(tu.grad, jgu)
    jgrads = dict(tree_flatten_with_path(ref.jax.tree.map(np.asarray, jgp)))
    for path, leaf in tree_flatten_with_path(s.tp):
        _close(leaf.grad, jgrads[path])


@pytest.mark.parametrize("S", [256, 40])
def test_prefill_cache_and_three_decode_steps_match_reference(ref, S):
    """Prefill from a (nonzero) cache starts from zero as the reference does;
    its state and conv tail, then three decode steps' outputs and caches."""
    s = _setup(ref)
    d = s.jcfg.d_model
    jcache0 = ref.m.mamba_cache_init(s.jcfg, B, s.jdt)
    tcache0 = mamba2.mamba_cache_init(s.tcfg, B, s.tdt, torch.device("cpu"))
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in sorted(tcache0.items())] == \
        [(k, tuple(v.shape), "torch." + str(v.dtype)) for k, v in sorted(jcache0.items())]
    tcache0 = {k: v + 1 for k, v in tcache0.items()}       # ignored by prefill
    u = _u(S, d)
    japply = ref.jax.jit(lambda p, x, c: ref.m.mamba_apply(p, s.jcfg, x, cache=c))
    jdec = ref.jax.jit(lambda p, x, c: ref.m.mamba_apply(p, s.jcfg, x, cache=c, decode=True))
    jout, jc = japply(s.jp, u, jcache0)
    with torch.no_grad():
        tout, tc = mamba2.mamba_apply(s.tp, s.tcfg, torch.from_numpy(u), cache=tcache0)
        _close(tout, jout)
        _close(tc["state"], jc["state"])
        _close(tc["conv"], jc["conv"])
        for step in range(3):
            x = _u(1, d, seed=10 + step)
            jo, jc = jdec(s.jp, x, jc)
            to, tc = mamba2.mamba_apply(s.tp, s.tcfg, torch.from_numpy(x), cache=tc, decode=True)
            _close(to, jo)
            _close(tc["state"], jc["state"])
            _close(tc["conv"], jc["conv"])


def test_bf16_matches_reference_by_tolerance(ref):
    s = _setup(ref, dtype="bfloat16")
    u = _u(256, s.jcfg.d_model)
    jout, _ = ref.jax.jit(lambda p, x: ref.m.mamba_apply(p, s.jcfg, x))(
        s.jp, ref.jnp.asarray(u).astype(s.jdt))
    with torch.no_grad():
        tout, _ = mamba2.mamba_apply(s.tp, s.tcfg, torch.from_numpy(u).to(torch.bfloat16))
    assert tout.dtype == torch.bfloat16
    _close(tout, jout, tol=2e-2)
