"""The port's train step and trainer (``repro_torch.training``) against the
JAX package, on the reduced deepseek-7b.

The two packages draw initial weights from different generators, so parity
starts from a step-0 checkpoint the reference writes: both packages'
``Trainer`` resume from it and train 6 steps in float32.  XLA fuses and
orders float32 sums differently, so equality is not expected; the bounds,
set from float32 rounding and AdamW's update size: the loss history within
1e-5 relative, every moment leaf within 1e-5 of its largest magnitude (the
first moment holds the gradients to that bound), and every parameter within
the learning-rate budget, the sum of the schedule's rates over the steps,
with at most 0.1 % of a leaf's elements past 1 % of it.  AdamW moves an
element by about the rate a step, and its update ``m / (sqrt(v) + eps)`` is
sign-like where a gradient element is near ``eps``: a float32 gradient sum
that cancels to near zero can move that element by a share of the rate in
one package and not in the other.  Observed on the CPU: loss within 1.5e-7
relative, moments within 4.0e-6; parameters within 0.27 % of the budget
after 6 steps, and 9.4 % for the worst element after the one micro-batched
step.  Crash and resume is held bit for
bit within the port, as ``tests/test_substrate.py`` holds it for the
reference.  The FR base refit is held exactly on carried bf16 parameters.
"""
import dataclasses
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import path_str, tree_flatten_with_path, tree_leaves
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import SimulatedFailure, Trainer, TrainerConfig

#: float32 parity bounds (module docstring)
LOSS_RTOL, MOMENT_TOL, PARAM_TIGHT_FRAC, PARAM_TIGHT_SHARE = 1e-5, 1e-5, 1e-2, 1e-3
ACFG = dict(lr=1e-3, warmup_steps=2, total_steps=12)


def _lr_budget(acfg: dict, steps: int) -> float:
    cfg = adamw.AdamWConfig(**acfg)
    return sum(float(adamw.schedule(cfg, torch.tensor(s))) for s in range(1, steps + 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the models and pages here are small, and on a
    host shared with other test workers torch's thread pool spends more time
    contending than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs
    from repro.checkpoint import ckpt as jckpt
    from repro.data.pipeline import PipelineConfig as JPipelineConfig
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    from repro.models.api import build_model as jbuild
    from repro.optim import adamw as jadamw
    from repro.training import train_step as jstep
    from repro.training import trainer as jtrainer

    return SimpleNamespace(jax=jax, jnp=jnp, configs=configs, ckpt=jckpt, build=jbuild,
                           adamw=jadamw, step=jstep, trainer=jtrainer,
                           pipe=lambda cfg: JTokenPipeline(JPipelineConfig(**cfg)))


def _cfg(dtype: str = "float32"):
    return dataclasses.replace(reduced(ARCHS["deepseek-7b"]), dtype=dtype)


def _pipe_cfg(cfg) -> dict:
    return dict(vocab_size=cfg.vocab_size, seq_len=32, batch_per_host=2, seed=3)


def _port_trainer(ckpt_dir, total: int = 6, fail_at: int = -1, **tc) -> Trainer:
    cfg = _cfg()
    model = build_model(cfg, "cpu")
    pipe = TokenPipeline(PipelineConfig(**_pipe_cfg(cfg)))
    return Trainer(model, adamw.AdamWConfig(**ACFG), pipe,
                   TrainerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                                 fail_at_step=fail_at, **{"ckpt_every": 5, "log_every": 1, **tc}))


def _leaves(tree) -> dict[str, np.ndarray]:
    return {path_str(p): interop.params_to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for p, v in tree_flatten_with_path(tree)}


def _jleaves(ref, tree) -> dict[str, np.ndarray]:
    return {path_str(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p)): np.asarray(v)
            for p, v in ref.jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close_trees(got: dict, want: dict, lr_budget: float) -> None:
    """Parameters (keys under ``params/``) within the learning-rate budget,
    all but :data:`PARAM_TIGHT_SHARE` of each leaf within
    :data:`PARAM_TIGHT_FRAC` of it; everything else within
    :data:`MOMENT_TOL` of its scale."""
    assert sorted(got) == sorted(want)
    for k in want:
        diff = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
        if k.startswith("params/"):
            assert float(diff.max()) <= lr_budget, k
            assert float((diff > PARAM_TIGHT_FRAC * lr_budget).mean()) <= PARAM_TIGHT_SHARE, k
        else:
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            assert float(diff.max()) <= MOMENT_TOL * scale, k


@pytest.fixture(scope="module")
def resumed(ref, tmp_path_factory):
    """Both trainers resumed from one reference step-0 checkpoint, 6 steps."""
    root = tmp_path_factory.mktemp("carried")
    jcfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS["deepseek-7b"]),
                               dtype="float32")
    jm = ref.build(jcfg)
    params = jm.init(ref.jax.random.PRNGKey(0))
    ref.ckpt.save(root / "step0", 0, {"params": params, "opt": ref.adamw.init_state(params)})
    shutil.copytree(root / "step0", root / "ref")
    shutil.copytree(root / "step0", root / "port")
    jtr = ref.trainer.Trainer(jm, ref.adamw.AdamWConfig(**ACFG), ref.pipe(_pipe_cfg(jcfg)),
                              ref.trainer.TrainerConfig(total_steps=6, ckpt_every=6, log_every=1,
                                                        ckpt_dir=str(root / "ref")))
    jparams, jopt = jtr.run()
    ttr = _port_trainer(root / "port", ckpt_every=6)
    tparams, topt = ttr.run()
    return SimpleNamespace(jtr=jtr, ttr=ttr, jtree=_jleaves(ref, {"params": jparams, "opt": jopt}),
                           ttree=_leaves({"params": tparams, "opt": topt}), root=root)


def test_resumed_trainer_loss_history_matches_reference(resumed):
    jl = [(h["step"], h["loss"]) for h in resumed.jtr.history if "loss" in h]
    tl = [(h["step"], h["loss"]) for h in resumed.ttr.history if "loss" in h]
    assert [s for s, _ in tl] == [s for s, _ in jl] == list(range(6))
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl], rtol=LOSS_RTOL)
    keys = lambda h: sorted(k for k in h if k != "wall")  # noqa: E731
    assert [keys(h) for h in resumed.ttr.history] == [keys(h) for h in resumed.jtr.history]


def test_resumed_trainer_parameters_match_reference(resumed):
    _assert_close_trees(resumed.ttree, resumed.jtree, _lr_budget(ACFG, 6))


def test_resumed_checkpoints_match_reference_layout(resumed):
    assert ckpt.latest_step(resumed.root / "port") == 6
    ratios = [h["ckpt_ratio"] for h in resumed.ttr.history if "ckpt_ratio" in h]
    jratios = [h["ckpt_ratio"] for h in resumed.jtr.history if "ckpt_ratio" in h]
    assert len(ratios) == len(jratios) == 1
    np.testing.assert_allclose(ratios, jratios, rtol=0.02)
    assert sorted(p.name for p in (resumed.root / "port").iterdir()) == \
        sorted(p.name for p in (resumed.root / "ref").iterdir())


def test_failure_recovery_bit_exact(tmp_path):
    """Crash at step 8, restart, final state == an uninterrupted 12-step run."""
    want_p, want_o = _port_trainer(tmp_path / "ref", total=12).run()
    with pytest.raises(SimulatedFailure):
        _port_trainer(tmp_path / "crash", total=12, fail_at=8).run()
    assert ckpt.latest_step(tmp_path / "crash") == 5
    resumed = _port_trainer(tmp_path / "crash", total=12)
    got_p, got_o = resumed.run()
    assert resumed.history[0]["step"] == 5
    for a, b in zip(tree_leaves({"p": got_p, "o": got_o}), tree_leaves({"p": want_p, "o": want_o})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_microbatched_step_matches_reference(ref):
    jcfg = dataclasses.replace(ref.configs.reduced(ref.configs.ARCHS["deepseek-7b"]),
                               dtype="float32")
    jm = ref.build(jcfg)
    jp = jm.init(ref.jax.random.PRNGKey(1))
    jstate = ref.adamw.init_state(jp)
    batch = {"tokens": TokenPipeline(PipelineConfig(jcfg.vocab_size, 32, 4, seed=1))
             .batch_at(0)["tokens"]}
    acfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jnew, jst, jm_ = ref.step.make_train_step(jm, ref.adamw.AdamWConfig(**acfg), n_micro=2)(
        jp, jstate, {"tokens": ref.jnp.asarray(batch["tokens"])})
    tm = build_model(_cfg(), "cpu")
    tp = interop.params_from_numpy(ref.jax.tree.map(np.asarray, jp), device="cpu")
    tnew, tst, tm_ = make_train_step(tm, adamw.AdamWConfig(**acfg), n_micro=2)(
        tp, adamw.init_state(tp), batch)
    assert sorted(tm_) == sorted(jm_)
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-4)
    _assert_close_trees(_leaves({"params": tnew, "m": tst["m"], "v": tst["v"]}),
                        _jleaves(ref, {"params": jnew, "m": jst["m"], "v": jst["v"]}),
                        _lr_budget(acfg, 1))


def test_compressed_step_in_a_world_of_one_is_the_plain_step():
    """No process group: the compressed cross-pod mean returns the
    gradients unchanged and encodes nothing, so the step equals the plain one."""
    cfg = _cfg()
    batch = TokenPipeline(PipelineConfig(cfg.vocab_size, 32, 2, seed=2)).batch_at(0)
    outs = []
    for compress in (False, True):
        model = build_model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(4))
        step = make_train_step(model, adamw.AdamWConfig(), compress_grads=compress,
                               fr_bases=torch.arange(14, dtype=torch.int32))
        outs.append(step(params, adamw.init_state(params), batch))
    for a, b in zip(tree_leaves(outs[0][:2]), tree_leaves(outs[1][:2])):
        assert torch.equal(a, b)


def test_refit_fr_bases_match_reference(ref):
    jcfg = ref.configs.reduced(ref.configs.ARCHS["deepseek-7b"])
    jm = ref.build(jcfg)
    jp = jm.init(ref.jax.random.PRNGKey(2))
    jtr = ref.trainer.Trainer(jm, ref.adamw.AdamWConfig(), ref.pipe(_pipe_cfg(jcfg)),
                              ref.trainer.TrainerConfig())
    jtr._refit_fr(jp)
    tm = build_model(reduced(ARCHS["deepseek-7b"]), "cpu")
    ttr = Trainer(tm, adamw.AdamWConfig(), TokenPipeline(PipelineConfig(**_pipe_cfg(jcfg))),
                  TrainerConfig())
    ttr._refit_fr(interop.params_from_numpy(ref.jax.tree.map(np.asarray, jp), device="cpu"))
    np.testing.assert_array_equal(ttr.fr_bases.bases.numpy(), np.asarray(jtr.fr_bases.bases))
    np.testing.assert_array_equal(ttr.fr_bases.widths.numpy(), np.asarray(jtr.fr_bases.widths))


def test_trainer_refits_during_run_and_logs_reference_keys(tmp_path):
    tr = _port_trainer(tmp_path, total=4, ckpt_every=4, refit_fr_every=2, log_every=2)
    tr.model = build_model(dataclasses.replace(_cfg(), dtype="bfloat16"), "cpu")
    tr.step_fn = make_train_step(tr.model, tr.opt_cfg)
    tr.run()
    assert tr.fr_bases is not None and tr.fr_bases.bases.shape == (14,)
    assert [sorted(h) for h in tr.history] == [
        ["grad_norm", "loss", "lr", "step", "wall"], ["grad_norm", "loss", "lr", "step", "wall"],
        ["grad_norm", "loss", "lr", "step", "wall"], ["ckpt_ratio", "step"]]


# ---------------------------------------------------------------------------
# the train CLI and the example script
# ---------------------------------------------------------------------------

def test_train_cli_resumes_after_a_rerun(tmp_path, capsys):
    from repro_torch.launch import train

    args = ["--reduced", "--steps", "2", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = train.main(args)
    assert ckpt.latest_step(tmp_path) == 2 and first.history[0]["step"] == 0
    args[2] = "3"
    again = train.main(args)
    assert again.history[0]["step"] == 2 and ckpt.latest_step(tmp_path) == 3
    out = capsys.readouterr().out
    assert "loss" in out and "ckpt GBDI ratio" in out


@pytest.mark.parametrize("arch,error", [("paligemma-3b", SystemExit),
                                        ("musicgen-large", SystemExit)])
def test_train_cli_refuses_families(tmp_path, arch, error):
    """The stub-frontend families are refused as in the reference (the MoE,
    hybrid and ssm families train in ``tests/test_torch_zoo_training.py``)."""
    from repro_torch.launch import train

    with pytest.raises(error):
        train.main(["--arch", arch, "--reduced", "--steps", "1", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])


def test_train_lm_example_resumes(tmp_path):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.PRESETS["2m"] == (128, 4, 4, 512, 2048, 128, 8)
    tr = mod.main(["--steps", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert ckpt.latest_step(tmp_path) == 1
    assert np.isfinite(tr.history[0]["loss"]) and tr.history[-1]["ckpt_ratio"] > 1.0
    # a rerun resumes from the step-1 checkpoint (the CLI test checks the rest)
    again = mod.Trainer(tr.model, tr.opt_cfg, tr.pipe, dataclasses.replace(tr.tc, total_steps=1))
    assert again.init_or_resume()[0] == 1
