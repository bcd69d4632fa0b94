"""Training the new families in the port against the JAX package: the
``Trainer`` resumed from a reference checkpoint, checkpoints of the new trees
both ways, and the train and serve CLIs, for one MoE (mixtral-8x22b), the
hybrid (zamba2-7b) and the ssm config (xlstm-1.3b), at their reduced sizes.

The trainer test follows ``tests/test_torch_training.py``: both
packages' ``Trainer`` resume from one reference step-0 checkpoint (stored
raw, so the step costs no GBDI fit) and train two float32 steps.  Bounds:
losses within 1e-5 relative; every moment leaf at cosine >= 0.999 to the
reference's; parameters within twice the learning-rate budget, at most 1 %
of a leaf's elements past 1 % of the budget.  The first step's gradients
agree to 1e-4 (``tests/test_torch_families.py``), but AdamW's first update
is ``sign(g)`` times the rate, so an element whose gradient is float32 noise
moves by the rate in opposite directions in the two packages; the second
step's gradient is then taken at slightly different weights, which the
xLSTM's gates amplify (its first moments differ by up to 2 % of their
scale after two steps).  The port's final checkpoint (the
shared block, the float32 ``router``/``A_log``/``D``/``dt_bias``/``wif``/``w``/
``r`` leaves, stacked periods) loads in the reference bit for bit; the final
checkpoints are GBDI-compressed for zamba2-7b, whose tree holds the shared
block and float32 leaves, and raw for the other two.  Observed
errors are in ``PERF.md`` §6.
"""
import dataclasses
import functools
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import path_str, tree_flatten_with_path, tree_map
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

#: one MoE, the hybrid and the ssm config
TOKEN_TRIO = ("mixtral-8x22b", "zamba2-7b", "xlstm-1.3b")
ACFG = dict(lr=1e-3, warmup_steps=2, total_steps=12)
TRAIN_STEPS = 2
#: the config whose final checkpoints are GBDI-compressed in both trainers:
#: the shared block, the float32 SSM leaves and stacked periods in one tree
GBDI_ARCH = "zamba2-7b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")

    from repro import configs
    from repro.checkpoint import ckpt as jckpt
    from repro.data.pipeline import PipelineConfig as JPipelineConfig
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    from repro.models.api import build_model as jbuild
    from repro.optim import adamw as jadamw
    from repro.training import trainer as jtrainer

    return SimpleNamespace(jax=jax, configs=configs, ckpt=jckpt,
                           build=jbuild, adamw=jadamw, trainer=jtrainer,
                           pipe=lambda cfg: JTokenPipeline(JPipelineConfig(**cfg)))


def _jpaths(ref, tree) -> dict:
    return {path_str(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p)): v
            for p, v in ref.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pipe_cfg(cfg) -> dict:
    return dict(vocab_size=cfg.vocab_size, seq_len=32, batch_per_host=2, seed=3)


def _raw_saves(monkeypatch, *mods) -> None:
    """Checkpoints through these ``ckpt`` modules stored raw (the GBDI fit
    and encode of a tree cost seconds on the CPU)."""
    for mod in mods:
        monkeypatch.setattr(mod, "save", functools.partial(mod.save, compress=False))


@pytest.mark.parametrize("arch", TOKEN_TRIO)
def test_trainer_resumed_from_reference_checkpoint(ref, arch, tmp_path, monkeypatch):
    jcfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS[arch]), dtype="float32")
    jm = ref.build(jcfg)
    params = ref.jax.jit(jm.init)(ref.jax.random.PRNGKey(0))
    ref.ckpt.save(tmp_path / "step0", 0, {"params": params, "opt": ref.adamw.init_state(params)},
                  compress=False)
    if arch != GBDI_ARCH:
        _raw_saves(monkeypatch, ref.ckpt, ckpt)
    for side in ("ref", "port"):
        shutil.copytree(tmp_path / "step0", tmp_path / side)
    tc = dict(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS, log_every=1)
    jtr = ref.trainer.Trainer(jm, ref.adamw.AdamWConfig(**ACFG), ref.pipe(_pipe_cfg(jcfg)),
                              ref.trainer.TrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tc))
    jparams, jopt = jtr.run()
    tm = build_model(dataclasses.replace(reduced(ARCHS[arch]), dtype="float32"), "cpu")
    ttr = Trainer(tm, adamw.AdamWConfig(**ACFG), TokenPipeline(PipelineConfig(**_pipe_cfg(jcfg))),
                  TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tc))
    tparams, topt = ttr.run()
    assert ttr.history[0]["step"] == 0
    jl = [h["loss"] for h in jtr.history if "loss" in h]
    tl = [h["loss"] for h in ttr.history if "loss" in h]
    assert len(tl) == len(jl) == TRAIN_STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    cfg = adamw.AdamWConfig(**ACFG)
    budget = sum(float(adamw.schedule(cfg, torch.tensor(s))) for s in range(1, TRAIN_STEPS + 1))
    want = {k: np.asarray(v, np.float64)
            for k, v in _jpaths(ref, {"params": jparams, "opt": jopt}).items()}
    got = {path_str(p): v.detach().double().numpy()
           for p, v in tree_flatten_with_path({"params": tparams, "opt": topt})}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        if k.startswith("params/"):
            assert float(diff.max()) <= 2 * budget, k
            assert float((diff > 1e-2 * budget).mean()) <= 1e-2, k
        elif w.ndim:
            cos = (got[k] * w).sum() / np.sqrt((got[k] ** 2).sum() * (w ** 2).sum() + 1e-300)
            assert cos >= 0.999 or not np.abs(w).max(), (k, cos)
        else:
            assert got[k] == w, k
    # the port's final checkpoint (GBDI for GBDI_ARCH) in the reference, bit for bit
    assert ckpt.latest_step(tmp_path / "port") == TRAIN_STEPS
    template = interop.params_to_numpy({"params": tparams, "opt": topt})
    step, back = ref.ckpt.load(tmp_path / "port", template)
    assert step == TRAIN_STEPS
    flat = {path_str(p): v for p, v in tree_flatten_with_path(template)}
    for k, v in _jpaths(ref, back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    ratios = [[h["ckpt_ratio"] for h in tr.history if "ckpt_ratio" in h] for tr in (ttr, jtr)]
    np.testing.assert_allclose(ratios[0], ratios[1], rtol=0.02)


@pytest.mark.parametrize("arch", TOKEN_TRIO)
def test_serve_cli_serves_the_new_families(arch, capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-new", "3", "--max-len", "32"])
    assert [r.rid for r in done] == [0, 1, 2]
    assert all(r.done and len(r.out) == 3 for r in done)
    assert capsys.readouterr().out.splitlines() == [f"req {r.rid}: {r.out}" for r in done]


@pytest.mark.parametrize("arch", TOKEN_TRIO)
def test_train_cli_trains_the_new_families(arch, tmp_path, capsys, monkeypatch):
    """Two steps and a checkpoint (stored raw: the trainer test holds the
    GBDI checkpoint of these trees)."""
    from repro_torch.launch import train

    _raw_saves(monkeypatch, ckpt)

    tr = train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
                     "--ckpt-every", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert ckpt.latest_step(tmp_path) == 2
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert losses and np.isfinite(losses).all()
    assert "ckpt GBDI ratio" in capsys.readouterr().out


def test_in_place_adamw_in_slices_matches_reference(ref, monkeypatch):
    """The in-place AdamW step on a tree with a shared block and float32
    and bf16 leaves: two steps cut into slices of 4,099 elements equal two
    unsliced steps bit for bit, and the float32 copy's two steps give the
    reference's parameters, moments and metrics within 1e-6 relative.  The
    gradients' global norm is 0.5, under the clip, so the clip scale is 1 in
    both packages and the elementwise update is what is compared."""
    tm = build_model(reduced(ARCHS["zamba2-7b"]), "cpu")
    params = tree_map(torch.Tensor.detach, tm.init(torch.Generator().manual_seed(2)))
    gen = torch.Generator().manual_seed(3)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    norm = float(adamw.global_norm(grads))
    grads = tree_map(lambda g, p: (g * (0.5 / norm)).to(p.dtype), grads, params)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def two_steps(tree, grads):
        tree = tree_map(torch.clone, tree)
        state = adamw.init_state(tree)
        for _ in range(2):
            tree, state, metrics = adamw.apply_updates(cfg, tree, grads, state)
        return {"p": tree, "m": state["m"], "v": state["v"], **metrics}, state

    whole, _ = two_steps(params, grads)
    monkeypatch.setattr(adamw, "SLICE", 4099)
    sliced, _ = two_steps(params, grads)
    for a, b in zip(*(tree_flatten_with_path(t) for t in (sliced, whole))):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype and torch.equal(a[1], b[1]), a[0]
    f32 = lambda t: tree_map(lambda x: x.float(), t)  # noqa: E731
    got, state = two_steps(f32(params), f32(grads))
    assert int(state["step"]) == 2
    np32 = lambda t: tree_map(lambda x: x.detach().float().numpy(), t)  # noqa: E731
    jcfg = ref.adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jp, jg = np32(params), np32(grads)
    jstate = ref.adamw.init_state(jp)
    jstep = ref.jax.jit(ref.adamw.apply_updates, static_argnums=0)
    for _ in range(2):
        jp, jstate, jm = jstep(jcfg, jp, jg, jstate)
    want = {"p": jp, "m": jstate["m"], "v": jstate["v"], **jm}
    for key in ("grad_norm", "lr"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-6 * abs(float(want[key]))
    for key in ("p", "m", "v"):
        w = {k: np.asarray(v) for k, v in _jpaths(ref, want[key]).items()}
        g = {path_str(p): v.numpy() for p, v in tree_flatten_with_path(got[key])}
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= 1e-6 * np.abs(w[k]).max(), (key, k)
