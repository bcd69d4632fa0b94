"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's ``repro.distributed.sharding``, and their DTensor form.

Specs are compared leaf for leaf on the full-width trees of all ten
configs (the port's under ``FakeTensorMode``, the reference's through
``jax.eval_shape``) against the reference's ``PartitionSpec`` on an
``AbstractMesh`` of each production mesh, so no device is needed.  One
spawn of four gloo ranks then places a reduced tree with
``distribute_tree`` and ``ckpt.load(..., shardings=(mesh, specs))`` (on a
checkpoint the reference wrote) on the
sub-meshes of two (pod, data, model) meshes, (2, 1, 2) and (2, 2, 1):
each pod's (data, model) mesh is a (1, 2) or a (2, 1) mesh, and (pod,
data) splits the batch dim over two axes.  Each rank's local shard is held
to the slice JAX computes for the same device of the same mesh (an
``AbstractMesh``, its devices in row-major order, as ``init_device_mesh``
lays out the ranks).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import production_axis_sizes
from repro_torch.models.api import build_model
from repro_torch.models.config import SHAPES

MESHES = {"pod": False, "multipod": True}
#: the spawned world: two 3-axis meshes whose pods hold (1, 2) and (2, 1) meshes
WORLD = 4
SUB_MESHES = ((2, 1, 2), (2, 2, 1))
SMALL_ARCH = "mixtral-8x22b"


@pytest.fixture(scope="module")
def ref():
    import jax
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as rshd
    from repro.launch import specs as rspecs
    from repro.models.api import build_model as rbuild

    @functools.lru_cache(maxsize=None)
    def params(arch):
        return rspecs.params_specs(rbuild(_ref_cfg(arch)))

    def mesh(multi_pod):
        sizes = production_axis_sizes(multi_pod)
        return AbstractMesh(tuple(sizes.values()), tuple(sizes))

    return SimpleNamespace(jax=jax, shd=rshd, specs=rspecs, build=rbuild, params=params,
                           mesh=mesh)


def _ref_cfg(arch):
    from repro.configs import get_config

    return get_config(arch)


@functools.lru_cache(maxsize=None)
def port_params(arch):
    """The full-width fake parameter tree, built once a config."""
    return specs.params_specs(build_model(ARCHS[arch], "cpu"))


def _ref_leaves(ref, tree, shardings):
    flat = ref.jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(_key(k) for k in path), tuple(leaf.shape), s)
            for (path, leaf), s in zip(flat, ref.jax.tree.leaves(shardings))]


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _port_leaves(tree, spec_tree):
    return [(tuple(str(k) for k in path), tuple(leaf.shape), s)
            for (path, leaf), s in zip(tree_flatten_with_path(tree), shd.spec_leaves(spec_tree))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(ref, arch, mesh):
    axes = production_axis_sizes(MESHES[mesh])
    rp = ref.params(arch)
    want = _ref_leaves(ref, rp, ref.shd.params_shardings(ref.mesh(MESHES[mesh]), rp))
    tree = port_params(arch)
    got = _port_leaves(tree, shd.params_specs(tree, axes))
    assert [(p, s) for p, s, _ in got] == [(p, s) for p, s, _ in want]
    assert [spec for _, _, spec in got] == [tuple(s.spec) for _, _, s in want]
    # one device's bytes, as NamedSharding.shard_shape gives them
    shard_bytes = sum(int(np.prod(s.shard_shape(shape))) * np.dtype(leaf.dtype).itemsize
                      for (_, shape, s), leaf in zip(want, ref.jax.tree.leaves(rp)))
    assert shd.per_device_bytes(tree, shd.params_specs(tree, axes), axes) == shard_bytes


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(ref, arch, shape):
    sc = SHAPES[shape]
    rc = ref.specs.cache_specs(ref.build(_ref_cfg(arch)), sc.global_batch, sc.seq_len)
    model = build_model(ARCHS[arch], "cpu")
    tree = specs.cache_specs(model, sc.global_batch, sc.seq_len)
    for multi_pod in MESHES.values():
        axes = production_axis_sizes(multi_pod)
        want = _ref_leaves(ref, rc, ref.shd.cache_shardings(ref.mesh(multi_pod), rc))
        got = _port_leaves(tree, shd.cache_specs(tree, axes))
        assert [(p, s, spec) for p, s, spec in got] == [
            (p, s, tuple(r.spec)) for p, s, r in want]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_batch_specs_match_reference(ref, shape):
    sc = SHAPES[shape]
    fn = {"train": "train_batch_specs", "prefill": "prefill_batch_specs",
          "decode": "decode_step_specs"}[sc.kind]
    for arch in sorted(ARCHS):
        rb = getattr(ref.specs, fn)(_ref_cfg(arch), sc)
        tree = getattr(specs, fn)(ARCHS[arch], sc)
        for multi_pod in MESHES.values():
            axes = production_axis_sizes(multi_pod)
            want = _ref_leaves(ref, rb, ref.shd.batch_sharding(ref.mesh(multi_pod), rb))
            got = _port_leaves(tree, shd.batch_specs(tree, axes))
            assert [(p, s, spec) for p, s, spec in got] == [
                (p, s, tuple(r.spec)) for p, s, r in want], (arch, multi_pod)


def test_production_mesh_needs_a_world_of_its_size():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="world of 256"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="world of 512"):
        make_production_mesh(multi_pod=True)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert shd.to_placements((("pod", "data"), None), names) == [Shard(0), Shard(0), Replicate()]
    assert shd.to_placements((None, "model", "data"), names) == [Replicate(), Shard(2), Shard(1)]
    assert shd.to_placements((), names) == [Replicate()] * 3
    with pytest.raises(ValueError):
        shd.to_placements((("data", "pod"),), names)


# ---------------------------------------------------------------------------
# DTensor placement on four gloo ranks
# ---------------------------------------------------------------------------

def _rank_placements(rank: int, world: int, payload: dict) -> dict:
    """Every rank's local shards on the two meshes' (data, model) sub-meshes
    and the (pod, data) batch split, each against the slice JAX gives this
    rank's device; runs in a spawned process."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import ckpt

    names = ("pod", "data", "model")
    arrays = payload["params"]
    out = {"params": [], "ckpt": [], "batch": []}
    for shape, want in zip(payload["meshes"], payload["index"]):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        sub = mesh["data", "model"]
        axes = dict(zip(("data", "model"), shape[1:]))
        tree = interop.params_from_numpy(arrays, device="cpu")
        p_specs = shd.params_specs(tree, axes)
        placed = shd.distribute_tree(tree, sub, p_specs)
        _, loaded = ckpt.load(payload["ckpt"], tree, shardings=(sub, p_specs))
        for (_, leaf), dt, ld, idx in zip(tree_flatten_with_path(arrays), tree_leaves(placed),
                                          tree_leaves(loaded), want["params"]):
            ref_slice = _bits(np.asarray(leaf)[idx[rank]])
            out["params"].append(np.array_equal(interop.params_to_numpy(dt.to_local()), ref_slice))
            out["ckpt"].append(np.array_equal(interop.params_to_numpy(ld.to_local()), ref_slice))
        # the batch dim over (pod, data): two Shard(0) placements
        tokens = payload["tokens"]
        b_spec = shd.batch_spec(tokens, {"pod": shape[0], **axes})
        dt = shd.distribute_tree({"tokens": torch.from_numpy(tokens)}, mesh,
                                 {"tokens": b_spec})["tokens"]
        out["batch"].append((b_spec, np.array_equal(dt.to_local().numpy(),
                                                    tokens[want["batch"][rank]])))
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    """bf16 as its uint16 bit patterns (as ``params_to_numpy`` gives it)."""
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _ref_index(ref, sharding, shape) -> list:
    """The index of each device's block under a reference ``NamedSharding``
    on an abstract mesh, by device id (the mesh's devices in row-major
    order), as JAX computes it."""
    from jax._src import op_shardings

    hlo = sharding._to_xla_hlo_sharding(len(shape))
    return list(op_shardings.op_sharding_to_numpy_indices(hlo, shape, WORLD))


@pytest.fixture(scope="module")
def spawned(ref, tmp_path_factory):
    from jax.sharding import AbstractMesh

    from repro.checkpoint import ckpt as rckpt
    from repro_torch.distributed.spawn import run_ranks

    # the reduced tree's shapes and dtypes from the reference, its values
    # from a seeded numpy generator; the reference writes it raw
    shapes = ref.specs.params_specs(ref.build(reduced(_ref_cfg(SMALL_ARCH))))
    rng = np.random.default_rng(0)
    arrays = ref.jax.tree.map(
        lambda s: rng.standard_normal(s.shape, np.float32).astype(s.dtype), shapes)
    ck = tmp_path_factory.mktemp("ref_ckpt")
    rckpt.save(ck, 0, arrays, compress=False)
    tokens = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    index = []
    for shape in SUB_MESHES:
        amesh = AbstractMesh(shape, ("pod", "data", "model"))
        p_sh = ref.jax.tree.leaves(ref.shd.params_shardings(amesh, shapes))
        b_sh = ref.shd.batch_sharding(amesh, {"tokens": tokens})["tokens"]
        index.append({"params": [_ref_index(ref, s, leaf.shape)
                                 for s, leaf in zip(p_sh, ref.jax.tree.leaves(shapes))],
                      "batch": _ref_index(ref, b_sh, tokens.shape)})
    return run_ranks(_rank_placements, WORLD,
                     {"params": arrays, "ckpt": str(ck), "meshes": SUB_MESHES,
                      "index": index, "tokens": tokens},
                     init_dir=tmp_path_factory.mktemp("gloo"), timeout_s=600.0)


def test_distribute_tree_gives_each_rank_the_reference_slice(spawned):
    for rank, out in enumerate(spawned):
        assert out["params"] and all(out["params"]), rank


def test_ckpt_load_dtensor_form_on_a_reference_checkpoint(spawned):
    for rank, out in enumerate(spawned):
        assert out["ckpt"] and all(out["ckpt"]), rank


def test_batch_dim_over_pod_and_data_splits_pod_major(spawned):
    for rank, out in enumerate(spawned):
        specs_seen = [spec for spec, _ in out["batch"]]
        assert specs_seen == [(("pod", "data"), None)] * len(SUB_MESHES)
        assert all(ok for _, ok in out["batch"]), rank
