"""Dataflow checkers: hazards that live across statements.

Port of ``src/repro/analysis/dataflow_checkers.py``.  The reference's
``use-after-donate`` tracks names bound to buffers a jitted call donated;
eager PyTorch donates nothing, and its cross-statement hazard is the side
stream instead.  ``stream-lifetime`` holds the two ways a tensor's life
outruns what its stream has done:

* (a) a ``with torch.cuda.stream(s):`` block reads a tensor made outside it
  (on another stream), in a function that never orders the two streams
  (``s.wait_stream(...)``, ``s.wait_event(...)``, an event recorded on
  ``s``) nor marks the tensor with ``record_stream(s)``: the caching
  allocator may hand the memory to another tensor while ``s`` still reads
  it, and the producer's writes may not have landed;
* (b) a device-to-host copy with ``non_blocking=True`` whose result the
  host reads (``.numpy()``, ``.tolist()``, ``int()``...) before any
  ``synchronize()`` in the same function: the host reads memory the copy
  has not written yet.

``unbounded-module-cache`` is copied unchanged: a module-level dict that
function bodies insert into must have an eviction path or a baseline
entry saying why it is bounded.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis import _ast_util as U
from repro_torch.analysis.base import register
from repro_torch.analysis.finding import Finding
from repro_torch.analysis.project import SourceFile

# --------------------------------------------------------------------------
# stream-lifetime
# --------------------------------------------------------------------------

#: host reads of a tensor's memory
_HOST_READS = {"numpy", "tolist", "item"}


def _stream_blocks(fn: U.FnDef) -> list[tuple[ast.With, str]]:
    """``with torch.cuda.stream(s):`` blocks of ``fn`` and their stream's
    dotted name ('' when it is not a plain name or attribute chain)."""
    out = []
    for node in U.own_nodes(fn):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            ce = item.context_expr
            if (isinstance(ce, ast.Call)
                    and U.dotted_name(ce.func) in ("torch.cuda.stream", "cuda.stream")
                    and ce.args):
                out.append((node, U.dotted_name(ce.args[0])))
    return out


def _orders_stream(fn: U.FnDef, stream: str) -> bool:
    """``fn`` orders ``stream`` against another one, or hands it tensors
    through ``record_stream``."""
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr, recv = node.func.attr, U.dotted_name(node.func.value)
        args = {U.dotted_name(a) for a in node.args}
        if attr == "wait_stream" and (not stream or stream in args | {recv}):
            return True
        if attr == "wait_event" and (not stream or recv == stream):
            return True
        if attr in ("record_stream", "record") and (not stream or stream in args):
            return True
    return False


def _bound_names(fn: U.FnDef, before: int) -> set[str]:
    """Parameters and names bound in ``fn`` before line ``before``."""
    out = set(U.param_names(fn)) - {"self", "cls"}
    for node in U.own_nodes(fn):
        if getattr(node, "lineno", before) >= before:
            continue
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _block_inputs(block: ast.With, bound: set[str]) -> list[str]:
    """Names the block reads that were bound before it, and not rebound by
    the block before their first read."""
    stored: set[str] = set()
    reads: list[str] = []
    for node in sorted((n for stmt in block.body for n in ast.walk(stmt)
                        if isinstance(n, ast.Name)),
                       key=lambda n: (n.lineno, n.col_offset)):
        if isinstance(node.ctx, ast.Store):
            stored.add(node.id)
        elif node.id in bound and node.id not in stored and node.id not in reads:
            reads.append(node.id)
    return reads


def _is_host_target(call: ast.Call) -> bool:
    """``.to("cpu", ...)``, ``.to(torch.device("cpu"))``, ``.to(device="cpu")``."""
    vals = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if (isinstance(v, ast.Call) and U.dotted_name(v.func) == "torch.device"
                and v.args and isinstance(v.args[0], ast.Constant) and v.args[0].value == "cpu"):
            return True
    return False


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _async_host_copies(fn: U.FnDef) -> list[tuple[str, int]]:
    """(host tensor name, line) of each non-blocking device-to-host copy:
    ``y = x.to("cpu", non_blocking=True)`` binds ``y``;
    ``y.copy_(x, non_blocking=True)`` writes ``y``."""
    out = []
    for node in U.own_nodes(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            if (isinstance(call.func, ast.Attribute) and call.func.attr == "to"
                    and _non_blocking(call) and _is_host_target(call)):
                out += [(t.id, node.lineno) for t in node.targets if isinstance(t, ast.Name)]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "copy_" and _non_blocking(node)):
            base = U.root_name(node.func.value)
            if base is not None:
                out.append((base, node.lineno))
    return out


def _host_read_lines(fn: U.FnDef, name: str) -> list[int]:
    out = []
    for node in U.own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_READS
                and U.root_name(node.func.value) == name):
            out.append(node.lineno)
        elif (U.dotted_name(node.func) in ("int", "float", "bool", "np.asarray", "np.array",
                                           "numpy.asarray", "numpy.array")
              and node.args and U.root_name(node.args[0]) == name):
            out.append(node.lineno)
    return sorted(out)


def _sync_lines(fn: U.FnDef) -> list[int]:
    return sorted(node.lineno for node in U.own_nodes(fn)
                  if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "synchronize")


@register(
    "stream-lifetime",
    "side-stream block reading a tensor made outside it with no wait_stream/"
    "wait_event/record_stream ordering, or a non_blocking device-to-host copy "
    "read on the host before a synchronize()",
)
def check_stream_lifetime(src: SourceFile) -> Iterator[Finding]:
    names = U.identifiers(src.tree)
    if src.is_test or not names & {"stream", "copy_", "to"}:
        return
    for ctx in U.walk_functions(src.tree, src.rel):
        fn = ctx.node
        for block, stream in _stream_blocks(fn):
            if _orders_stream(fn, stream):
                continue
            inputs = _block_inputs(block, _bound_names(fn, block.lineno))
            inputs = [n for n in inputs if n != stream.split(".")[0]]
            if inputs:
                yield Finding(
                    "stream-lifetime", src.rel, block.lineno, block.col_offset,
                    f"`{ctx.qualname}` runs work on stream `{stream or '<expr>'}` that "
                    f"reads {', '.join(inputs)} made outside the block, with no "
                    "wait_stream/wait_event ordering the streams and no "
                    "record_stream; the producer's writes may not have landed and "
                    "the allocator may reuse the memory while the stream reads it",
                    src.anchor(block.lineno))
        syncs = _sync_lines(fn)
        for name, line in _async_host_copies(fn):
            for read in _host_read_lines(fn, name):
                if read <= line:
                    continue
                if not any(line < s <= read for s in syncs):
                    yield Finding(
                        "stream-lifetime", src.rel, read, 0,
                        f"`{name}` is read on the host here, but its non_blocking "
                        f"device-to-host copy (line {line}) may still be in flight: "
                        "synchronize the copy's stream or an event recorded after it "
                        "first",
                        src.anchor(read))
                break


# --------------------------------------------------------------------------
# unbounded-module-cache
# --------------------------------------------------------------------------

#: container constructors that build a memo-shaped module global
_DICT_CTORS = {"dict", "OrderedDict", "defaultdict", "WeakValueDictionary"}
#: insertion mutations (growth); eviction ops are the bound evidence
_INSERTERS = {"setdefault", "update", "__setitem__"}
_EVICTORS = {"popitem", "pop", "clear", "__delitem__"}


def _module_dict_globals(tree: ast.Module) -> dict[str, int]:
    """Module-level names bound to dict-like containers -> def lineno."""
    out: dict[str, int] = {}
    for node in tree.body:
        targets: list[ast.expr] = []
        value: ast.expr | None = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        is_dict = isinstance(value, (ast.Dict, ast.DictComp))
        if isinstance(value, ast.Call):
            head = U.dotted_name(value.func).rsplit(".", 1)[-1]
            is_dict = head in _DICT_CTORS
        if not is_dict:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out[t.id] = node.lineno


    return out


def _cache_ops(tree: ast.Module, names: set[str]) -> tuple[dict[str, int], set[str]]:
    """(first in-function insertion lineno per name, names with eviction)."""
    inserts: dict[str, int] = {}
    evicts: set[str] = set()

    def in_function(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> bool:
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return True
        return False

    parents = U.build_parents(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in tgts:
                # constant-key stores are a fixed-schema record (counter
                # dicts like {"hits": 0}), not unbounded memo growth —
                # the statically-spelled key set bounds the dict itself
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id in names
                        and not isinstance(t.slice, ast.Constant)
                        and in_function(node, parents)):
                    inserts.setdefault(t.value.id, node.lineno)
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                    and fn.value.id in names):
                if (fn.attr in _INSERTERS and in_function(node, parents)
                        and not (fn.attr == "setdefault" and node.args
                                 and isinstance(node.args[0], ast.Constant))):
                    inserts.setdefault(fn.value.id, node.lineno)
                elif fn.attr in _EVICTORS:
                    evicts.add(fn.value.id)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in names):
                    evicts.add(t.value.id)
    return inserts, evicts


def _unbounded_lru_decorators(tree: ast.Module) -> Iterator[tuple[str, int]]:
    """``@functools.cache`` / ``@lru_cache(maxsize=None)`` decorators —
    memo containers with no eviction bound, same hazard as a bare dict."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            head = U.dotted_name(dec.func if isinstance(dec, ast.Call) else dec)
            tail = head.rsplit(".", 1)[-1]
            if tail == "cache" and head in ("functools.cache", "cache"):
                yield node.name, dec.lineno
            elif tail == "lru_cache" and isinstance(dec, ast.Call):
                sized = [a for a in (dec.args + [k.value for k in dec.keywords
                                                 if k.arg == "maxsize"])]
                for a in sized:
                    if isinstance(a, ast.Constant) and a.value is None:
                        yield node.name, dec.lineno


@register(
    "unbounded-module-cache",
    "module-level memo with no eviction bound: a dict grown from function "
    "bodies with no popitem/pop/del/clear, or lru_cache(maxsize=None)/"
    "functools.cache — leaks across long sweeps",
)
def check_unbounded_module_cache(src: SourceFile) -> Iterator[Finding]:
    if src.is_test:
        return
    for fn_name, lineno in _unbounded_lru_decorators(src.tree):
        yield Finding(
            "unbounded-module-cache", src.rel, lineno, 0,
            f"`{fn_name}` memoizes with no eviction bound "
            "(lru_cache(maxsize=None) / functools.cache); every distinct "
            "key pins its value — jitted closures especially — forever; "
            "give it a maxsize",
            src.anchor(lineno))
    containers = _module_dict_globals(src.tree)
    if not containers:
        return
    inserts, evicts = _cache_ops(src.tree, set(containers))
    for name, lineno in sorted(inserts.items(), key=lambda kv: kv[1]):
        if name in evicts:
            continue
        yield Finding(
            "unbounded-module-cache", src.rel, lineno, 0,
            f"module-level dict `{name}` (defined line {containers[name]}) "
            "grows here with no eviction path anywhere in the module; bound "
            "it (`while len(c) > CAP: c.popitem(last=False)`), use "
            "functools.lru_cache(maxsize=...), or baseline with the reason "
            "it cannot grow unboundedly",
            src.anchor(lineno))
