"""Logical-axis sharding rules with divisibility-aware fallback, as DTensor
placements.

PyTorch counterpart of :mod:`repro.distributed.sharding`, rule for rule.
Weights get TP on the contraction-adjacent dim (mesh axis ``model``) and an
FSDP-style spread over ``data`` on the other dim.  Every rule is a list of
candidate specs; the first one whose named axes all divide the corresponding
dims wins (mixtral's 8 experts cannot shard over model=16, so its expert
weights fall back to sharding d_ff instead).  The ``pod`` axis is pure DP:
only the batch (and optimizer state, via the same spec as params) names it.

The rules work on an axis-size mapping (``{"data": 16, "model": 16}``,
:func:`repro_torch.launch.mesh.production_axis_sizes`), so they need no
device.  A spec is a tuple with the reference's ``PartitionSpec`` structure:
one entry a leading dim, each an axis name, ``None``, or a tuple of names
(``("pod", "data")``, split pod-major as JAX splits it); ``()`` replicates.
:func:`to_placements` turns a spec into DTensor ``Shard``/``Replicate``
placements over a ``DeviceMesh``, and :func:`distribute_tree` places a tree.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map

AxisSizes = Mapping[str, int]
Spec = tuple


def _entry(name: Any) -> Any:
    """A 1-tuple of axis names is the name itself, as ``PartitionSpec``
    normalises it."""
    if isinstance(name, tuple) and len(name) == 1:
        return name[0]
    return name


def spec_axes(spec: Spec) -> set[str]:
    """Every axis name a spec uses."""
    return {n for e in spec for n in (e if isinstance(e, tuple) else (e,)) if n is not None}


def _axis_size(axis_sizes: AxisSizes, name: Any) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(axis_sizes[n] for n in name)
    return axis_sizes[name]


def _fits(axis_sizes: AxisSizes, shape: Sequence[int], spec: Spec) -> bool:
    for dim, name in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        size = _axis_size(axis_sizes, name)
        if size > 1 and dim % size != 0:
            return False
    return True


def pick_spec(axis_sizes: AxisSizes, shape: Sequence[int], candidates: Sequence[Spec]) -> Spec:
    for spec in candidates:
        spec = tuple(_entry(n) for n in spec)
        if _fits(axis_sizes, shape, spec):
            return spec
    return ()


# (parent, leaf) -> candidate specs for the *trailing* dims; leading stacked
# axes (layer periods) are padded with None automatically.
_RULES: dict[tuple[str, str], list[tuple]] = {
    ("attn", "wq"): [("data", "model"), (None, "model"), ()],
    ("attn", "wk"): [("data", "model"), ("data", None), ()],
    ("attn", "wv"): [("data", "model"), ("data", None), ()],
    ("attn", "wo"): [("model", "data"), ("model", None), ()],
    ("mlp", "wg"): [("data", "model"), (None, "model"), ()],
    ("mlp", "wu"): [("data", "model"), (None, "model"), ()],
    ("mlp", "wd"): [("model", "data"), ("model", None), ()],
    ("moe", "router"): [("data", "model"), ("data", None), ()],
    ("moe", "wg"): [("model", "data", None), (None, "data", "model"), ()],
    ("moe", "wu"): [("model", "data", None), (None, "data", "model"), ()],
    ("moe", "wd"): [("model", None, "data"), (None, "model", "data"), ()],
    ("mamba", "in_proj"): [("data", "model"), ("data", None), ()],
    ("mamba", "conv_w"): [(None, "model"), ()],
    ("mamba", "out_proj"): [("model", "data"), ("model", None), ()],
    ("mlstm", "up"): [("data", "model"), ()],
    ("mlstm", "wq"): [("data", "model"), ()],
    ("mlstm", "wk"): [("data", "model"), ()],
    ("mlstm", "wv"): [("data", "model"), ()],
    ("mlstm", "wif"): [("data", None), ()],
    ("mlstm", "down"): [("model", "data"), ()],
    ("slstm", "w"): [("data", "model"), ()],
    ("slstm", "r"): [()],
    ("slstm", "up"): [("data", "model"), ()],
    ("slstm", "down"): [("model", "data"), ()],
    ("", "embed"): [("model", "data"), ("model", None), ()],
    ("", "head"): [("data", "model"), (None, "model"), ()],
}


def param_spec(path: Sequence[Any], leaf: Any, axis_sizes: AxisSizes) -> Spec:
    """The spec of the parameter at ``path`` (dict keys and list indices
    from the root, as :func:`repro_torch._tree.tree_flatten_with_path` gives
    them); ``leaf`` needs only a ``shape``."""
    names = [str(p) for p in path]
    leaf_name = names[-1] if names else ""
    parent = ""
    for n in reversed(names[:-1]):
        if n in ("attn", "mlp", "moe", "mamba", "mlstm", "slstm"):
            parent = n
            break
    key = (parent, leaf_name)
    if key not in _RULES:
        if leaf_name in ("embed", "head"):
            key = ("", leaf_name)
        else:
            return ()  # norms, gates, scalars: replicated
    shape = tuple(leaf.shape)
    # pad candidates with leading Nones for stacked (period) axes
    padded = [(None,) * (len(shape) - len(c)) + tuple(c)
              for c in _RULES[key] if len(c) <= len(shape)]
    return pick_spec(axis_sizes, shape, padded)


def _with_path(fn: Any, tree: Any) -> Any:
    """``fn(path, leaf)`` over ``tree``, keeping its structure."""
    paths = iter(path for path, _ in tree_flatten_with_path(tree))
    return tree_map(lambda leaf: fn(next(paths), leaf), tree)


def params_specs(tree: Any, axis_sizes: AxisSizes) -> Any:
    """A spec for every parameter leaf (the reference's ``params_shardings``)."""
    return _with_path(lambda path, leaf: param_spec(path, leaf, axis_sizes), tree)


def batch_axes(axis_sizes: AxisSizes) -> tuple:
    return ("pod", "data") if "pod" in axis_sizes else ("data",)


def batch_spec(leaf: Any, axis_sizes: AxisSizes) -> Spec:
    """A batch leaf's leading (batch) dim over the DP axes where divisible."""
    dims = (batch_axes(axis_sizes),) + (None,) * (len(leaf.shape) - 1)
    return pick_spec(axis_sizes, leaf.shape, [dims, ()])


def batch_specs(tree: Any, axis_sizes: AxisSizes) -> Any:
    """The reference's ``batch_sharding``, as specs."""
    return tree_map(lambda leaf: batch_spec(leaf, axis_sizes), tree)


def cache_spec(path: Sequence[Any], leaf: Any, axis_sizes: AxisSizes) -> Spec:
    """KV/state caches: batch dim over DP axes, heads over model if they
    divide, else the sequence dim over model (B=1 long-context decode)."""
    ba = batch_axes(axis_sizes)
    leaf_name = str(path[-1]) if path else ""
    shape = tuple(leaf.shape)
    if leaf_name in ("k", "v"):
        # (periods?, B, S, Kv, hd)
        lead = (None,) * (len(shape) - 4)
        cands = [lead + (ba, None, "model", None), lead + (ba, "model", None, None),
                 lead + (ba, None, None, None), lead + (None, "model", None, None), ()]
    elif leaf_name in ("state", "C"):   # mamba / mlstm (periods?, B, H, ., .)
        lead = (None,) * (len(shape) - 4)
        cands = [lead + (ba, "model", None, None), lead + (ba, None, None, None), ()]
    elif leaf_name in ("n", "h", "c"):
        lead = (None,) * (len(shape) - 3)
        cands = [lead + (ba, "model", None), lead + (ba, None, None), ()]
    elif leaf_name == "conv":           # (periods?, B, w-1, ch)
        lead = (None,) * (len(shape) - 3)
        cands = [lead + (ba, None, "model"), lead + (ba, None, None), ()]
    else:
        cands = [()]
    return pick_spec(axis_sizes, shape, cands)


def cache_specs(tree: Any, axis_sizes: AxisSizes) -> Any:
    """The reference's ``cache_shardings``, as specs."""
    return _with_path(lambda path, leaf: cache_spec(path, leaf, axis_sizes), tree)


def shard_shape(shape: Sequence[int], spec: Spec, axis_sizes: AxisSizes) -> tuple[int, ...]:
    """One device's block of a leaf of ``shape`` under ``spec`` (the
    reference's ``NamedSharding.shard_shape``)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(dim) // _axis_size(axis_sizes, name))
                 for dim, name in zip(shape, entries))


def per_device_bytes(tree: Any, specs: Any, axis_sizes: AxisSizes) -> int:
    """Bytes one device holds of ``tree`` placed by ``specs`` (the
    counterpart of ``memory_analysis()``'s argument bytes)."""
    return sum(math.prod(shard_shape(leaf.shape, spec, axis_sizes)) * leaf.element_size()
               for leaf, spec in zip(tree_leaves(tree), spec_leaves(specs)))


def spec_leaves(specs: Any) -> list[Spec]:
    """The specs of a spec tree in leaf order (a spec is a tuple, not a
    subtree)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def to_placements(spec: Spec, mesh_dim_names: Sequence[str]) -> list:
    """DTensor placements, one a mesh dim: ``Shard(d)`` where the spec names
    that mesh axis on tensor dim ``d``, else ``Replicate()``.  A dim named by
    several axes is sharded over each in turn, in mesh-dim order, which
    splits it major-to-minor as JAX does when the names follow the mesh's
    order (``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard

    where: dict[str, int] = {}
    for d, name in enumerate(spec):
        for n in (name if isinstance(name, tuple) else (name,)):
            if n is not None:
                where[n] = d
    order = [n for n in mesh_dim_names if n in where]
    for name in spec:
        if isinstance(name, tuple) and [n for n in order if n in name] != list(name):
            raise ValueError(f"axes {name} are not in the mesh's order {tuple(mesh_dim_names)}")
    return [Shard(where[n]) if n in where else Replicate() for n in mesh_dim_names]


def distribute_tree(tree: Any, device_mesh: Any, specs: Any) -> Any:
    """Every leaf of ``tree`` as a DTensor on ``device_mesh``, placed by its
    spec in ``specs`` (``distribute_tensor``: rank 0's leaf is the source)."""
    from torch.distributed.tensor import distribute_tensor

    names = device_mesh.mesh_dim_names
    specs_it = iter(spec_leaves(specs))
    return tree_map(lambda leaf: distribute_tensor(
        leaf.detach(), device_mesh, to_placements(next(specs_it), names)), tree)


__all__ = ["batch_axes", "batch_spec", "batch_specs", "cache_spec", "cache_specs",
           "distribute_tree", "param_spec", "params_specs", "per_device_bytes",
           "pick_spec", "shard_shape", "spec_axes", "spec_leaves", "to_placements"]
