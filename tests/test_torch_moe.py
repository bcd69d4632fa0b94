"""The port's MoE ffn (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``, on carried weights and the same numpy inputs.

Both dispatch paths: full (no-drop) capacity where ``T * top_k <= 8192``,
and the capacity-factor path past it, where tokens are dropped.  Tolerances,
float32: the output within 1e-5 of its largest magnitude, the aux loss within
1e-6 relative, every gradient (input, router, experts) within 1e-5 of its
largest magnitude; bf16 (torch rounds after each op where XLA keeps float32
across a fused chain): output within 2e-2 of its largest magnitude, the aux
loss within 1e-3 relative.  Observed errors are in ``PERF.md`` §6.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import moe

#: (batch, seq) of each path: 2 x 24 x top-2 = 96 assignments (no drop);
#: 4 x 1040 x top-2 = 8,320 > 8,192 (capacity path, tokens dropped)
SHAPES = {"no_drop": (2, 24), "capacity": (4, 1040)}
#: reduced mixtral (8 experts, top 2), and a qwen3-like 16 experts, top 4
CONFIGS = {"mixtral": ("mixtral-8x22b", {}),
           "qwen3": ("qwen3-moe-235b-a22b", {"n_experts": 16, "top_k": 4})}


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
    from repro.models import moe as jmoe

    return SimpleNamespace(jax=jax, jnp=jnp, configs=configs, moe=jmoe)


def _cfgs(ref, name: str, dtype: str):
    arch, over = CONFIGS[name]
    jcfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS[arch]), dtype=dtype, **over)
    tcfg = dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype, **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def runs() -> dict:
    """:func:`_run`'s results, kept for the module."""
    return {}


def _run(ref, runs: dict, name: str, path: str, dtype: str = "float32"):
    """Both packages' forward on one carried init, computed once a module."""
    key = (name, path, dtype)
    if key not in runs:
        runs[key] = _forward(ref, name, path, dtype)
    return runs[key]


def _forward(ref, name: str, path: str, dtype: str):
    jnp = ref.jnp
    jcfg, tcfg = _cfgs(ref, name, dtype)
    jdt = jnp.dtype(dtype)
    jp = ref.jax.jit(lambda k: ref.moe.moe_init(k, jcfg, jdt))(ref.jax.random.PRNGKey(3))
    params = ref.jax.tree.map(np.asarray, jp)
    B, S = SHAPES[path]
    rng = np.random.default_rng(5)
    # a component every token shares skews the router, so that the capacity
    # path overflows some experts and drops their extra assignments
    x = (rng.standard_normal((B, S, jcfg.d_model))
         + 1.5 * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    # jitted: one compile costs less here than the first eager dispatch of each op
    jout, jaux = ref.jax.jit(lambda p, x: ref.moe.moe_apply(p, jcfg, x))(jp, jx)
    tp = interop.params_from_numpy(params, device="cpu")
    for leaf in tp.values():
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    tout, taux = moe.moe_apply(tp, tcfg, tx)
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, jx=jx, jout=jout, jaux=jaux, tp=tp,
                           tx=tx, tout=tout, taux=taux, T=B * S)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(np.asarray(x).astype(np.float32))


def _rel_max(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("path", list(SHAPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_output_and_aux_match_reference(ref, runs, name, path):
    r = _run(ref, runs, name, path)
    assert tuple(r.tout.shape) == tuple(r.jout.shape) and r.tout.dtype == torch.float32
    assert _rel_max(_f32(r.tout), _f32(r.jout)) <= 1e-5
    assert abs(float(r.taux.detach()) - float(r.jaux)) <= 1e-6 * abs(float(r.jaux))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_capacity_switch_and_drops(ref, runs, name):
    """The capacity switch at 8,192 assignments with the reference's
    precedence, and the capacity path really dropping tokens."""
    _, tcfg = _cfgs(ref, name, "float32")
    K, E = tcfg.top_k, tcfg.n_experts
    assert moe.capacity(tcfg, 8192 // K) == 8192
    T = 8192 // K + 1
    assert moe.capacity(tcfg, T) == int(T * K // E * tcfg.capacity_factor) + 1
    r = _run(ref, runs, name, "capacity")
    with torch.no_grad():
        probs = torch.softmax(r.tx.float().reshape(-1, tcfg.d_model) @ r.tp["router"], -1)
        counts = torch.bincount(torch.topk(probs, K, -1).indices.reshape(-1), minlength=E)
    assert int(counts.max()) > moe.capacity(tcfg, r.T)   # some assignment is dropped


@pytest.mark.parametrize("path", list(SHAPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_moe_gradients_through_dispatch_match_reference(ref, runs, name, path):
    """d(sum(out * c) + aux)/d(x, router, wg, wu, wd) for a fixed random c."""
    r = _run(ref, runs, name, path)
    c = np.random.default_rng(7).standard_normal(r.jout.shape).astype(np.float32)
    jc = ref.jnp.asarray(c)

    def jloss(p, x):
        out, aux = ref.moe.moe_apply(p, r.jcfg, x)
        return (out * jc).sum() + aux

    jgp, jgx = ref.jax.jit(ref.jax.grad(jloss, argnums=(0, 1)))(r.jp, r.jx)
    ((r.tout * torch.from_numpy(c)).sum() + r.taux).backward()
    assert _rel_max(_f32(r.tx.grad), _f32(jgx)) <= 1e-5
    for key in ("router", "wg", "wu", "wd"):
        assert _rel_max(_f32(r.tp[key].grad), _f32(jgp[key])) <= 1e-5, key


@pytest.mark.parametrize("path", list(SHAPES))
def test_moe_bf16_matches_reference_by_tolerance(ref, runs, path):
    r = _run(ref, runs, "mixtral", path, dtype="bfloat16")
    assert r.tout.dtype == torch.bfloat16 and r.taux.dtype == torch.float32
    assert _rel_max(_f32(r.tout), _f32(r.jout)) <= 2e-2
    assert abs(float(r.taux.detach()) - float(r.jaux)) <= 1e-3 * abs(float(r.jaux))
