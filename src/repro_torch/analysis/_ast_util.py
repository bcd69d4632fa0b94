"""Shared AST helpers: dotted names, host parameters, the hot context.

Port of ``src/repro/analysis/_ast_util.py``.  The reference's "device
context" is code that runs under a trace.  Eager PyTorch has no trace, so
the port's counterpart is *hot* code: code on a path where a host sync
stalls the card's queue, or breaks a CUDA graph that captures it.  A
function is a hot entry when it

* launches a library kernel: it calls ``<lib>.<name>_launch(...)`` on a
  handle from ``_build.load(...)`` (or ``load(...)``) or a module's
  ``_lib()``;
* is a ``@triton.jit`` body;
* is compiled: decorated with ``@torch.compile`` or passed to
  ``torch.compile(f)``;
* is captured: called inside ``with torch.cuda.graph(...)`` or passed to
  ``torch.cuda.make_graphed_callables``;
* is named in :data:`HOT_ENTRIES` (``path::qualname``): the serving tick's
  methods, the targets of the CUDA-graph item of ``ROADMAP.md`` §2.

A function nested in a hot one is hot too.  :mod:`repro_torch.analysis.
callgraph` propagates the context to module-local helpers.  Host code is
free to call ``.item()`` or branch on values.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import re
from typing import Iterator

#: attribute reads and methods that give a tensor's metadata, not its values
STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "device", "numel", "is_cuda", "dim",
    "stride", "is_contiguous", "element_size", "layout", "is_pinned",
    "requires_grad", "data_ptr",
}

#: parameter names that conventionally carry host configuration
CONFIG_PARAM_NAMES = {"cfg", "config", "spec", "backend", "mode", "device", "dev",
                      "dtype", "interpret"}

#: the hot entries no decorator or call marks: ``path::qualname``
HOT_ENTRIES = (
    "src/repro_torch/serving/engine.py::KVSession.append",
    "src/repro_torch/serving/engine.py::KVSession.step",
    "src/repro_torch/serving/engine.py::Engine.tick",
    "src/repro_torch/models/api.py::Model.decode_step",
)

#: scalar and metadata annotations that mark a parameter as host data
_HOST_ANN = re.compile(
    r"(^|\.)(int|bool|str|float|bytes|device|dtype)$|(Config|Spec)\b"
)

#: container heads: host data only if every element type is
_CONTAINER_ANN = re.compile(
    r"(^|\.)(tuple|Tuple|list|List|Sequence|Mapping|dict|Dict|frozenset|FrozenSet|set|Set)$"
)

#: callables whose result is a library handle (``_build.load(name)``, ``_lib()``)
_LIB_LOADERS = {"load", "_lib"}

FnDef = ast.FunctionDef | ast.AsyncFunctionDef


def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.synchronize``-style dotted name of a Name/Attribute
    chain, else ''."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def root_name(node: ast.AST) -> str | None:
    """The name an expression hangs off: ``x`` of ``x``, ``x[k]``, ``x.a.b``,
    ``x[k].a``; None for calls and literals."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def annotation_is_host(ann: ast.expr | None) -> bool:
    """True when the annotation names host data: a scalar, a device or
    dtype, a config or spec, or a container of only those."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            return annotation_is_host(ast.parse(ann.value, mode="eval").body)
        except SyntaxError:
            return bool(_HOST_ANN.search(ann.value))
    if isinstance(ann, ast.Subscript):      # tuple[int, ...], dict[str, Tensor]
        head = dotted_name(ann.value)
        if head and _CONTAINER_ANN.search(head):
            elts = ann.slice.elts if isinstance(ann.slice, ast.Tuple) else [ann.slice]
            return all(
                (isinstance(e, ast.Constant) and e.value is Ellipsis)
                or annotation_is_host(e)
                for e in elts
            )
        return annotation_is_host(ann.value)
    if isinstance(ann, ast.BinOp):          # PEP 604 unions: host if every arm is
        return all(annotation_is_host(a) or _is_none(a) for a in (ann.left, ann.right))
    name = dotted_name(ann)
    return bool(name and _HOST_ANN.search(name))


def _is_none(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def param_names(fn: FnDef) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def positional_param_names(fn: FnDef) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


def host_params(fn: FnDef) -> set[str]:
    """Parameters of ``fn`` that hold host data: ``self``/``cls``, the
    conventional config names, and those annotated with a host type."""
    out: set[str] = {"self", "cls"} | CONFIG_PARAM_NAMES
    a = fn.args
    for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
        if annotation_is_host(p.annotation):
            out.add(p.arg)
    return out


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node of ``fn``'s body, not descending into nested defs or
    lambdas (those are functions of their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


@functools.lru_cache(maxsize=512)
def identifiers(tree: ast.Module) -> frozenset[str]:
    """Every name and attribute a module spells: a cheap test that lets a
    rule skip a module that cannot match it."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return frozenset(out)


def _is_lib_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and dotted_name(node.func).rsplit(".", 1)[-1] in _LIB_LOADERS)


def launch_calls(fn: FnDef) -> list[ast.Call]:
    """``<lib>.<name>_launch(...)`` calls in ``fn``'s own body, where
    ``<lib>`` is a loader call or a name bound to one in ``fn``."""
    handles = set()
    calls = []
    for node in own_nodes(fn):
        if isinstance(node, ast.Assign) and _is_lib_call(node.value):
            handles |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.endswith("_launch")):
            calls.append(node)
    out = [c for c in calls if _is_lib_call(c.func.value)           # type: ignore[attr-defined]
           or (isinstance(c.func.value, ast.Name)                    # type: ignore[attr-defined]
               and c.func.value.id in handles)]                      # type: ignore[attr-defined]
    return sorted(out, key=lambda n: (n.lineno, n.col_offset))


def _decorator_kind(dec: ast.expr) -> str | None:
    head = dotted_name(dec.func if isinstance(dec, ast.Call) else dec)
    if head in ("triton.jit", "triton.autotune", "triton.heuristics"):
        return "@triton.jit"
    if head == "torch.compile":
        return "torch.compile"
    return None


def is_graph_with(node: ast.AST) -> bool:
    """``with torch.cuda.graph(g):`` (a CUDA-graph capture block)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    return any(isinstance(item.context_expr, ast.Call)
               and dotted_name(item.context_expr.func) in ("torch.cuda.graph", "cuda.graph")
               for item in node.items)


def call_form_entries(tree: ast.Module) -> dict[str, str]:
    """Bare function names a module hands to a compiler or a graph capture,
    with the reason: ``torch.compile(f)``, ``make_graphed_callables(f, ...)``
    and functions called inside ``with torch.cuda.graph(...)``."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            head = dotted_name(node.func)
            tail = head.rsplit(".", 1)[-1]
            if head == "torch.compile":
                why = "torch.compile"
            elif tail == "make_graphed_callables":
                why = "CUDA graph"
            else:
                continue
            for arg in node.args[:1]:
                elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
                for el in elts:
                    if isinstance(el, ast.Name):
                        out.setdefault(el.id, why)
        elif is_graph_with(node):
            for stmt in node.body:          # type: ignore[attr-defined]
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        out.setdefault(sub.func.id, "CUDA graph")
    return out


@dataclasses.dataclass
class FnContext:
    node: FnDef
    qualname: str                  # lexical dotted path, classes included
    hot: bool                      # a hot entry, or nested in one
    entry: bool                    # the hot entry itself (not nested)
    why: str | None                # what makes it hot (entry or its outermost hot parent)


def entry_reason(fn: FnDef, qualname: str, rel: str,
                 call_entries: dict[str, str], may_launch: bool = True) -> str | None:
    """Why ``fn`` is a hot entry on its own, or None (``may_launch``: the
    module's text spells a ``_launch(`` call at all)."""
    for dec in fn.decorator_list:
        kind = _decorator_kind(dec)
        if kind is not None:
            return kind
    if may_launch and launch_calls(fn):
        return "launches a kernel"
    if f"{rel}::{qualname}" in HOT_ENTRIES:
        return "HOT_ENTRIES"
    if "." not in qualname and qualname in call_entries:
        return call_entries[qualname]
    return None


def walk_functions(tree: ast.Module, rel: str = "") -> Iterator[FnContext]:
    """Yield every function with its qualname and hot classification, in
    document order, nested functions after their parent."""
    yield from _function_contexts(tree, rel)


@functools.lru_cache(maxsize=512)
def _function_contexts(tree: ast.Module, rel: str) -> tuple[FnContext, ...]:
    """:func:`walk_functions`, once a parsed module: every checker walks the
    same trees (keyed by the tree object, which the cache holds alive)."""
    return tuple(_walk(tree, rel))


def _walk(tree: ast.Module, rel: str) -> Iterator[FnContext]:
    names = identifiers(tree)
    call_entries = (call_form_entries(tree)
                    if names & {"compile", "graph", "make_graphed_callables"} else {})
    may_launch = any(n.endswith("_launch") for n in names)

    def visit(node: ast.AST, prefix: str, hot_why: str | None) -> Iterator[FnContext]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                why = entry_reason(child, qual, rel, call_entries, may_launch)
                entry = why is not None and hot_why is None
                inherited = hot_why or why
                yield FnContext(node=child, qualname=qual, hot=inherited is not None,
                                entry=entry, why=inherited)
                yield from visit(child, qual + ".", inherited)
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.", hot_why)
            else:
                yield from visit(child, prefix, hot_why)

    yield from visit(tree, "", None)


def build_parents(root: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def call_name_of(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> str | None:
    """If ``node`` sits (transitively) inside a Call's arguments, the
    dotted name of the *innermost* enclosing call, else None."""
    cur = node
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, ast.Call) and cur is not parent.func:
            return dotted_name(parent.func)
        cur = parent
    return None
