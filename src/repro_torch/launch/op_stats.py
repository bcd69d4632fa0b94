"""FLOPs, HBM bytes and collective wire bytes of an eager program, op by op.

The port's counterpart of :mod:`repro.launch.hlo_stats`, which walks the
compiled HLO of a jitted step.  Eager PyTorch has no HLO, so this module
takes its own name: :class:`OpCounter` is a ``TorchDispatchMode`` that sees
every aten op the program dispatches, forward and backward, on real tensors
or on the fake tensors of :mod:`repro_torch.launch.specs` (where nothing is
computed), and counts:

  * flops      - dot FLOPs (2 * result elems * contracted elems) from
                 ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
                 baddbmm, convolution, SDPA); elementwise math is excluded,
                 as the reference excludes it;
  * hbm_bytes  - every op's input and output bytes: an in-place op's operand
                 is read once and written once; ``copy_`` and the in-place
                 fills only write theirs; a gather reads its indices and the
                 rows it takes; a scatter in place reads its indices and
                 values and writes the values' size; a broadcast (stride 0)
                 dim is read once; views and metadata ops move nothing (the
                 reference's ``_NO_BYTES``).

Eager PyTorch fuses nothing, so the byte count is the eager program's own
traffic: what the port actually moves between ops, where the reference
counts bytes at XLA's fusion boundaries.

With ``watch`` (a parameter tree and its sharding specs) the counter also
sums the output bytes of every dot whose weight operand has its contracted
dim sharded over an axis: the activation a tensor-parallel program
all-reduces over that axis (:mod:`repro_torch.launch.dryrun`'s collective
model).  :func:`ring_wire_bytes` holds the reference's ring formulas.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch._tree import tree_leaves
from repro_torch.distributed.sharding import spec_leaves, spec_axes

_aten = torch.ops.aten

#: ops that move no data though their schema does not say they alias
_NO_BYTES = {
    _aten._unsafe_view, _aten.empty, _aten.empty_strided, _aten.empty_like,
    _aten.new_empty, _aten.new_empty_strided, _aten._local_scalar_dense,
}
#: queries that return no tensor (a fake tensor's ``.device`` is one)
_METADATA = {torch.ops.prim.device, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
             _aten.sym_storage_offset, _aten.is_contiguous}
#: reads its indices and the rows it takes, writes them
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
#: in place: reads indices and values, writes the values' size
_SCATTERS_IN_PLACE = {_aten.index_put_, _aten._index_put_impl_, _aten.scatter_,
                      _aten.scatter_add_, _aten.index_copy_, _aten.index_add_}
#: in place, written without being read
_WRITES_IN_PLACE = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.normal_, _aten.uniform_}
#: the contracted dims of (a, b) in ``a @ b``-shaped dot ops, by packet
_DOT_OPERANDS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2),
                 _aten.baddbmm: (1, 2)}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements, a broadcast (stride-0) dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def ring_wire_bytes(kind: str, operand_bytes: float, result_bytes: float, group: int) -> float:
    """Bytes one device sends for one collective over ``group`` devices, the
    ring model of the reference's ``hlo_stats``:

      all-gather          result * (P-1)/P
      reduce-scatter      operand * (P-1)/P
      all-reduce          2 * operand * (P-1)/P
      all-to-all          operand * (P-1)/P
      collective-permute  operand
    """
    ring = (group - 1) / max(group, 1)
    if kind == "all-gather":
        return result_bytes * ring
    if kind in ("reduce-scatter", "all-to-all"):
        return (operand_bytes or result_bytes) * ring
    if kind == "all-reduce":
        return 2 * (operand_bytes or result_bytes) * ring
    if kind == "collective-permute":
        return operand_bytes or result_bytes
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class OpStats:
    flops: int = 0
    hbm_bytes: int = 0
    #: output bytes of dots that contract a weight dim sharded over the
    #: watched axis (the activations a TP program all-reduces)
    tp_allreduce_bytes: int = 0
    #: op name -> [calls, flops, bytes]
    by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(lambda: [0, 0, 0]))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Watched:
    """A parameter leaf: its sizes and contiguous strides, and the leaf dims
    sharded over the watched axis."""

    def __init__(self, leaf: torch.Tensor, spec: tuple, axis: str):
        self.shape = tuple(leaf.shape)
        self.strides = tuple(leaf.stride())
        self.sharded = {d for d, name in enumerate(spec) if axis in spec_axes((name,))}

    def leaf_dims(self, size: int, stride: int) -> set[int]:
        """The leaf dims one dim (``size``, ``stride``) of a view spans;
        empty where the view splits a leaf dim or does not map onto it."""
        if size == 1:
            return set()
        for j in range(len(self.shape) - 1, -1, -1):
            if self.strides[j] == stride and self.shape[j] > 1:
                n = 1
                for k in range(j, -1, -1):
                    n *= self.shape[k]
                    if n >= size:
                        return set(range(k, j + 1)) if n == size else set()
                return set()
        return set()


class OpCounter(TorchDispatchMode):
    """Counts every dispatched aten op into :attr:`stats`.

    ``watch``: ``(params, specs, axis)`` with ``params`` a tree of the
    parameter tensors the program reads (or views of them) and ``specs``
    their specs (:mod:`repro_torch.distributed.sharding`), to sum
    :attr:`OpStats.tp_allreduce_bytes` over ``axis``.
    """

    def __init__(self, watch: tuple[Any, Any, str] | None = None):
        super().__init__()
        self.stats = OpStats()
        self._watched: dict[int, _Watched] = {}
        if watch is not None:
            params, specs, axis = watch
            for leaf, spec in zip(tree_leaves(params), spec_leaves(specs)):
                w = _Watched(leaf, spec, axis)
                if w.sharded:
                    self._watched[_storage_key(leaf)] = w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _METADATA:
            return out
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            if self._watched and packet in _DOT_OPERANDS and self._contracts_watched(packet, args):
                self.stats.tp_allreduce_bytes += tensor_bytes(out)
        nbytes = self._bytes(func, packet, args, kwargs, out)
        self.stats.flops += flops
        self.stats.hbm_bytes += nbytes
        row = self.stats.by_op[str(packet)]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    def _contracts_watched(self, packet, args) -> bool:
        """True when a dot's weight operand is a view of a watched leaf whose
        contracted dims include one sharded over the watched axis."""
        ia, ib = _DOT_OPERANDS[packet]
        a, b = args[ia], args[ib]
        # the contracted dim is a's last and b's second to last
        for t, dim in ((a, a.ndim - 1), (b, b.ndim - 2)):
            w = self._watched.get(_storage_key(t))
            if w is not None and w.leaf_dims(t.shape[dim], t.stride(dim)) & w.sharded:
                return True
        return False

    @staticmethod
    def _bytes(func, packet, args, kwargs, out) -> int:
        if packet in _NO_BYTES or func.is_view:
            return 0
        ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return 0
        if packet in _WRITES_IN_PLACE:
            return sum(tensor_bytes(t) for t in ins)
        if packet in _GATHERS:
            table = args[1] if packet is _aten.embedding else args[0]
            idx = sum(tensor_bytes(t) for t in ins if t is not table)
            return idx + 2 * sum(tensor_bytes(t) for t in outs)
        if packet in _SCATTERS_IN_PLACE:
            rest = [t for t in ins if t is not args[0]]
            return sum(tensor_bytes(t) for t in rest) + tensor_bytes(rest[-1])
        return sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)


def top_ops(stats: OpStats, n: int = 20) -> list[dict]:
    """The largest HBM-byte contributors, by op name (the reference's
    ``hlo_stats.top_ops``)."""
    rows = [{"op": name, "calls": c, "flops": f, "bytes": b}
            for name, (c, f, b) in stats.by_op.items() if b or f]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:n]


def count(fn: Any, *args: Any, watch: tuple[Any, Any, str] | None = None,
          **kwargs: Any) -> tuple[Any, OpStats]:
    """``(fn(*args, **kwargs), stats)`` with every op of the call counted."""
    counter = OpCounter(watch)
    with counter:
        result = fn(*args, **kwargs)
    return result, counter.stats


__all__ = ["OpCounter", "OpStats", "count", "ring_wire_bytes", "tensor_bytes", "top_ops"]
