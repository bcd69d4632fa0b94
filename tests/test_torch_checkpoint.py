"""The port's GBDI checkpoints (``repro_torch.checkpoint.ckpt``) against the
JAX package's on-disk format.

A checkpoint the reference writes loads in the port and one the port writes
loads in the reference, bit for bit, over bf16, float32, int and scalar
leaves; on one tree both packages choose the same codec per leaf and store
the same number of bytes (their GBDI fits and bit streams are equal on the
CPU), in the same ``step_N`` / ``LATEST`` layout.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.api import build_model
from repro_torch.optim import adamw


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
    import ml_dtypes

    from repro.checkpoint import ckpt as jckpt

    return SimpleNamespace(jax=jax, bf16=ml_dtypes.bfloat16, ckpt=jckpt)


def _tree(ref) -> dict:
    """A tree of numpy leaves: bf16 (compressible and not), float32, int and scalar."""
    rng = np.random.default_rng(5)
    w = (rng.normal(0, 0.02, (64, 96))).astype(ref.bf16)
    return {
        "params": {"w": w, "tiny": np.arange(10, dtype=np.float32).astype(ref.bf16),
                   "scale": np.ones(3000, np.float32)},
        "opt": {"m": np.zeros((50, 40), np.float32),
                "v": (rng.random((40, 50)) * 1e-4).astype(np.float32),
                "step": np.array(7, np.int32)},
        "ids": rng.integers(-9, 9, 3000).astype(np.int32),
        "noise": rng.integers(0, 1 << 31, 2000).astype(np.int32),
    }


def _to_port(tree: dict) -> dict:
    def leaf(x: np.ndarray) -> torch.Tensor:
        if x.dtype.name == "bfloat16":
            return interop.params_from_numpy(x.view(np.uint16), device="cpu")
        return torch.from_numpy(np.array(x))
    return {k: _to_port(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return interop.params_to_numpy(x).reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _assert_same_bits(a, b) -> None:
    la, lb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=str(path))
        assert tuple(np.shape(x)) == tuple(y.shape), path


def test_reference_checkpoint_loads_in_the_port(ref, tmp_path):
    tree = _tree(ref)
    stats = ref.ckpt.save(tmp_path, 3, tree)
    assert stats["ratio"] > 1.0
    step, got = ckpt.load(tmp_path, _to_port(tree))
    assert step == 3
    _assert_same_bits(tree, got)
    assert got["params"]["w"].dtype == torch.bfloat16 and got["opt"]["step"].shape == ()


def test_port_checkpoint_loads_in_the_reference(ref, tmp_path):
    tree = _tree(ref)
    stats = ckpt.save(tmp_path, 4, _to_port(tree))
    assert stats["ratio"] > 1.0
    step, got = ref.ckpt.load(tmp_path, tree)
    assert step == 4
    flat = tree_flatten_with_path(tree)
    jflat = ref.jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(jflat)
    for (path, want), (_, have) in zip(flat, jflat):
        have = np.asarray(have)
        assert have.dtype == want.dtype and have.shape == want.shape, path
        np.testing.assert_array_equal(_bits(have), _bits(want), err_msg=str(path))


def test_manifest_codecs_and_bytes_equal_the_reference(ref, tmp_path):
    tree = _tree(ref)
    jstats = ref.ckpt.save(tmp_path / "ref", 2, tree)
    tstats = ckpt.save(tmp_path / "port", 2, _to_port(tree))
    assert tstats == jstats
    jman = json.loads((tmp_path / "ref" / "step_2" / "manifest.json").read_text())
    tman = json.loads((tmp_path / "port" / "step_2" / "manifest.json").read_text())
    assert tman == jman
    codecs = {k: e["codec"] for k, e in tman["leaves"].items()}
    assert "gbdi" in codecs.values() and "raw" in codecs.values()
    for d in ("ref", "port"):
        assert (tmp_path / d / "LATEST").read_text() == "2"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir()) == ["LATEST", "step_2"]
    assert sorted(p.name for p in (tmp_path / "port" / "step_2").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref" / "step_2").iterdir())
    # the stored arrays themselves: same streams, bases and meta
    for e in tman["leaves"].values():
        with np.load(tmp_path / "ref" / "step_2" / e["file"]) as zj, \
                np.load(tmp_path / "port" / "step_2" / e["file"]) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for f in zj.files:
                np.testing.assert_array_equal(zt[f].astype(np.int64), zj[f].astype(np.int64))


def test_latest_and_atomic_layout(tmp_path):
    tree = {"a": torch.arange(5000, dtype=torch.float32), "b": torch.zeros(3, dtype=torch.int32)}
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load(tmp_path, tree)
    ckpt.save(tmp_path, 1, tree)
    ckpt.save(tmp_path, 5, {"a": tree["a"] * 2, "b": tree["b"] + 1})
    assert ckpt.latest_step(tmp_path) == 5
    assert not any(p.name.startswith("tmp.") for p in tmp_path.iterdir())
    step, got = ckpt.load(tmp_path, tree, step=1)
    assert step == 1 and torch.equal(got["a"], tree["a"]) and torch.equal(got["b"], tree["b"])
    (tmp_path / "step_5" / "manifest.json").unlink()      # a half-written step
    assert ckpt.latest_step(tmp_path) is None


def test_load_places_leaves_on_the_devices_asked(tmp_path):
    tree = {"a": torch.randn(4000), "b": {"c": torch.ones(2, 3, dtype=torch.bfloat16)}}
    ckpt.save(tmp_path, 0, tree)
    for shardings in ("cpu", torch.device("cpu"),
                      {"a": "cpu", "b": {"c": torch.device("cpu")}}):
        _, got = ckpt.load(tmp_path, tree, shardings=shardings)
        assert all(t.device.type == "cpu" for t in tree_leaves(got))
        assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["c"], tree["b"]["c"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.int64,
                                   torch.int8, torch.bool])
def test_leaf_words_frame_as_the_reference_to_words(dtype):
    from repro_torch.core import gbdi

    t = (torch.arange(-700, 2301) * 37).to(dtype)
    arr = t.view(torch.int16).numpy() if dtype == torch.bfloat16 else t.numpy()
    for wb in (16, 32):
        want = gbdi.words_to_signed(gbdi.to_words(arr, wb), wb)
        np.testing.assert_array_equal(ckpt.leaf_words(t, wb).numpy(), want)
        back = ckpt._words_to_leaf(ckpt.leaf_words(t, wb), wb, dtype, tuple(t.shape))
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


def test_fresh_reduced_model_checkpoint_ratio(tmp_path):
    """Optimizer float32 moments of a fresh model are zeros-heavy: CR >> 1
    (``tests/test_substrate.py``'s bound)."""
    model = build_model(reduced(ARCHS["deepseek-7b"]), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    stats = ckpt.save(tmp_path / "ck", 0, {"params": params, "opt": adamw.init_state(params)})
    assert stats["ratio"] > 1.5, stats
