"""Module-local call graph with hot-context propagation.

Port of ``src/repro/analysis/callgraph.py``.  The lexical rules of
:mod:`repro_torch.analysis._ast_util` mark a function hot only when it is
an entry (it launches a kernel, is compiled or captured, or is named in
``HOT_ENTRIES``) or is nested in one.  Real wrapper code factors its work
into module-level helpers (``_launch_plan`` and ``_table_ptrs`` of
``kernels/gbdi_paged_attn.py`` under ``paged_attention_decode``), and a
``.item()`` in such a helper stalls the queue exactly as hard as one
written inline.

This module builds the call graph among functions *defined in the same
file* and propagates the hot context along its edges: a function is
*trace-reachable* (the reference's word, kept) when a caller chain from a
hot entry reaches it.  A bare call ``helper(...)`` resolves to the
module-level ``helper``, and, beyond the reference, ``self.m(...)`` or
``cls.m(...)`` inside a method of class ``C`` resolves to ``C.m``, so a hot
method's helpers on its own class are held to its rules.  Imports stay
opaque: a helper in another module is not followed, which errs on silence.

A function that asks whether it runs under a compiler or a capture
(``torch.compiler.is_compiling()``, ``torch.jit.is_tracing()``,
``torch.cuda.is_current_stream_capturing()``) is a *boundary*, the
counterpart of the reference's ``Tracer`` guard: it is checked itself but
does not pass the hot context on, because it already takes another path
under the compiler or the capture.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
from typing import Iterator

from repro_torch.analysis import _ast_util as U

#: calls by which a function tells a compiled or captured run from an eager one
_BOUNDARY_CALLS = {"is_compiling", "is_tracing", "is_scripting",
                   "is_current_stream_capturing"}


@dataclasses.dataclass
class FnNode:
    """One function definition in the module call graph."""

    qualname: str
    node: U.FnDef
    ctx: U.FnContext                       # lexical hot classification
    callees: set[str] = dataclasses.field(default_factory=set)
    boundary: bool = False                 # eager/compiled dispatcher


@dataclasses.dataclass
class CallGraph:
    """Module-local call graph + the trace-reachable closure."""

    nodes: dict[str, FnNode]               # qualname -> node
    hot: set[str]                          # trace-reachable qualnames

    def is_hot(self, qualname: str) -> bool:
        return qualname in self.hot


def _callee_names(fn: U.FnDef, klass: str | None) -> set[str]:
    """Qualnames (unresolved) this function calls or hands on as a
    function-valued argument: bare names, and ``self.m``/``cls.m`` as
    ``<klass>.m`` inside a method of ``klass``."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            out.add(func.id)
        elif (klass is not None and isinstance(func, ast.Attribute)
              and isinstance(func.value, ast.Name) and func.value.id in ("self", "cls")):
            out.add(f"{klass}.{func.attr}")
        for arg in node.args:
            if isinstance(arg, ast.Name):
                out.add(arg.id)
    return out


def _is_boundary(fn: U.FnDef) -> bool:
    return any(isinstance(n, ast.Call)
               and U.dotted_name(n.func).rsplit(".", 1)[-1] in _BOUNDARY_CALLS
               for n in ast.walk(fn))


def _enclosing_class(qualname: str, classes: set[str]) -> str | None:
    head = qualname.rsplit(".", 1)[0] if "." in qualname else None
    return head if head in classes else None


@functools.lru_cache(maxsize=512)
def build_callgraph(tree: ast.Module, rel: str = "") -> CallGraph:
    """Build the module call graph (once a parsed module; callers do not
    mutate it) and propagate the hot context from the
    lexical entries to a fixed point.  A nested function's calls resolve
    like its enclosing function's (both reach only module-level names and
    their class's methods)."""
    classes = {q for q in _class_names(tree)}
    may_bound = bool(U.identifiers(tree) & _BOUNDARY_CALLS)
    nodes: dict[str, FnNode] = {}
    for ctx in U.walk_functions(tree, rel):
        nodes[ctx.qualname] = FnNode(qualname=ctx.qualname, node=ctx.node, ctx=ctx,
                                     boundary=may_bound and _is_boundary(ctx.node))
    if not any(n.ctx.hot for n in nodes.values()):
        return CallGraph(nodes=nodes, hot=set())
    for node in nodes.values():
        klass = _enclosing_class(node.qualname, classes)
        for name in _callee_names(node.node, klass):
            if name in nodes and name != node.qualname and (
                    "." not in name or name.rsplit(".", 1)[0] in classes):
                node.callees.add(name)

    hot = {q for q, n in nodes.items() if n.ctx.hot}
    frontier = list(hot)
    while frontier:
        q = frontier.pop()
        if nodes[q].boundary and not nodes[q].ctx.hot:
            continue  # eager/compiled dispatcher: checked itself, not a conduit
        for callee in nodes[q].callees:
            if callee not in hot:
                hot.add(callee)
                # nested defs of a newly-hot function inherit the context
                for sub in nodes:
                    if sub.startswith(callee + ".") and sub not in hot:
                        hot.add(sub)
                        frontier.append(sub)
                frontier.append(callee)
    return CallGraph(nodes=nodes, hot=hot)


def _class_names(tree: ast.Module) -> Iterator[str]:
    def visit(node: ast.AST, prefix: str) -> Iterator[str]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield prefix + child.name
                yield from visit(child, prefix + child.name + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from visit(child, prefix + child.name + ".")

    yield from visit(tree, "")


def hot_callers(graph: CallGraph, qualname: str) -> list[str]:
    """Lexically hot functions that (transitively) call ``qualname``, to
    name the entry in propagated findings."""
    return sorted(q for q, n in graph.nodes.items()
                  if n.ctx.hot and q != qualname and _reaches(graph, q, qualname))


def _reaches(graph: CallGraph, src: str, dst: str) -> bool:
    seen: set[str] = set()
    stack = [src]
    while stack:
        q = stack.pop()
        if q == dst:
            return True
        if q in seen or q not in graph.nodes:
            continue
        seen.add(q)
        stack.extend(graph.nodes[q].callees)
    return False
