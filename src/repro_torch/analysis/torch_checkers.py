"""Torch/CUDA hot-path hazard checkers.

Port of the reference's trace-hazard module (``src/repro/analysis/``, the
checkers ``jit-host-sync``, ``traced-branch``, ``jit-static-args``,
``unseeded-random`` and ``jit-closure-capture``), each rule recast for
eager PyTorch and hand-written CUDA kernels bound with ``ctypes``:

* ``cuda-host-sync``: a host<->device sync in hot code (``.item()``,
  ``.cpu()``, ``torch.cuda.synchronize()``, a Python scalar of a tensor...)
  stalls the launch queue, and breaks a CUDA graph that captures it;
* ``tensor-branch``: a Python ``if``/``while`` on a tensor's value is the
  same sync, implicit;
* ``launch-contract``: a raw ``data_ptr()`` handed to a kernel launch must
  come from a tensor whose dtype, shape and contiguity the wrapper checked
  (the kernel reads the memory as it is told to), and the launch's return
  code must be tested;
* ``unseeded-random``: the reference's numpy and stdlib rules, plus torch
  samplers without ``generator=`` and process-global torch seeding;
* ``graph-capture-global``: a compiled or captured function that reads a
  module-level container mutated elsewhere sees the value of capture time.

Context comes from :mod:`repro_torch.analysis._ast_util` (the hot entries)
and :mod:`repro_torch.analysis.callgraph` (their module-local helpers).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis import _ast_util as U
from repro_torch.analysis import callgraph as CG
from repro_torch.analysis.base import register
from repro_torch.analysis.finding import Finding
from repro_torch.analysis.project import SourceFile

# --------------------------------------------------------------------------
# cuda-host-sync
# --------------------------------------------------------------------------

#: tensor methods that copy to the host and wait for the card
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: numpy entry points that materialise a tensor on the host
_NUMPY_MATERIALISERS = {"asarray", "array"}
_NUMPY_MODULES = {"np", "numpy"}
#: builtins that turn a one-element tensor into a Python scalar
_SCALAR_BUILTINS = {"float", "int", "bool"}


def _is_constant_like(node: ast.expr) -> bool:
    """Literal-ish argument: ``float("inf")``, ``int(0x10)`` are host math."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _is_constant_like(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_constant_like(node.left) and _is_constant_like(node.right)
    return False


def _is_host_scalar_arg(node: ast.expr, host: set[str]) -> bool:
    """An argument of ``int()``/``float()``/``bool()`` that is host data: a
    constant, a host parameter, ``len(...)``, or tensor metadata
    (``x.shape[0]``, ``x.numel()``)."""
    if _is_constant_like(node):
        return True
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, ast.Call) and U.dotted_name(node.func) == "len":
        return True
    cur: ast.AST = node
    while isinstance(cur, (ast.Subscript, ast.Call, ast.Attribute)):
        if isinstance(cur, ast.Attribute) and cur.attr in U.STATIC_ATTRS:
            return True
        cur = cur.func if isinstance(cur, ast.Call) else cur.value
    return False


def _sync_message(node: ast.Call, host: set[str]) -> str | None:
    fn = node.func
    name = U.dotted_name(fn)
    if name in ("torch.cuda.synchronize", "cuda.synchronize"):
        return ("torch.cuda.synchronize() in hot code waits for the whole card; "
                "order work with streams and events instead")
    if isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
        return (f"{name or '<expr>'}() blocks the host until the stream or event "
                "completes; wait on the device side (wait_event/wait_stream)")
    if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS:
        if (isinstance(fn.value, ast.Call) and isinstance(fn.value.func, ast.Attribute)
                and fn.value.func.attr in _SYNC_METHODS):
            return None                 # `x.cpu().numpy()`: one copy, flagged at `.cpu()`
        return (f".{fn.attr}() copies to the host and waits for the card; keep the "
                "value on the device or read it once outside the hot path")
    if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
            and fn.value.id in _NUMPY_MODULES and fn.attr in _NUMPY_MATERIALISERS
            and node.args and not _is_constant_like(node.args[0])
            and not isinstance(node.args[0], (ast.List, ast.Tuple))):
        return (f"{fn.value.id}.{fn.attr}() of a tensor copies it to the host and "
                "waits for the card")
    if (isinstance(fn, ast.Name) and fn.id in _SCALAR_BUILTINS and node.args
            and not all(_is_host_scalar_arg(a, host) for a in node.args)):
        return (f"{fn.id}() of a tensor reads its value on the host (a sync); "
                "keep it a tensor or pass the scalar in as an int/float parameter")
    return None


def _graph_regions(fn: U.FnDef) -> list[ast.stmt]:
    """Statements of ``fn`` inside ``with torch.cuda.graph(...)`` blocks."""
    out: list[ast.stmt] = []
    for node in U.own_nodes(fn):
        if U.is_graph_with(node):
            out.extend(node.body)           # type: ignore[attr-defined]
    return out


@register(
    "cuda-host-sync",
    "host<->device sync (.item()/.cpu()/synchronize()/float() of a tensor) in a "
    "kernel launcher, a compiled or captured function, or a hot entry",
)
def check_host_sync(src: SourceFile) -> Iterator[Finding]:
    if src.is_test:
        return
    graph = CG.build_callgraph(src.tree, src.rel)
    may_capture = "graph" in U.identifiers(src.tree)
    for qualname, fnode in graph.nodes.items():
        ctx = fnode.ctx
        if graph.is_hot(qualname):
            scan: list[ast.AST] = [ctx.node]
        else:
            scan = list(_graph_regions(ctx.node)) if may_capture else []
            if not scan:
                continue
        propagated = graph.is_hot(qualname) and not ctx.hot
        host = U.host_params(ctx.node)
        seen: set[int] = set()
        for region in scan:
            nodes = U.own_nodes(region) if region is ctx.node else ast.walk(region)
            for node in nodes:
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                msg = _sync_message(node, host)
                if msg is None:
                    continue
                if propagated:
                    entries = CG.hot_callers(graph, qualname)
                    via = ", ".join(f"`{e}`" for e in entries) or "a hot entry"
                    msg += (f" — `{qualname}` is not a hot entry itself but is "
                            f"trace-reachable (called from {via} in this module)")
                elif not graph.is_hot(qualname):
                    msg += " — inside a torch.cuda.graph capture"
                yield Finding("cuda-host-sync", src.rel, node.lineno, node.col_offset,
                              msg, src.anchor(node.lineno))


# --------------------------------------------------------------------------
# tensor-branch
# --------------------------------------------------------------------------


def _name_use_is_safe(name: ast.Name, parents: dict[ast.AST, ast.AST]) -> bool:
    """True when this use of a (possibly tensor) name reads no tensor
    value: metadata, ``len``/``isinstance``, ``is None``."""
    parent = parents.get(name)
    if isinstance(parent, ast.Attribute) and parent.attr in U.STATIC_ATTRS:
        return True
    if (isinstance(parent, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops)):
        return True
    call = U.call_name_of(name, parents)
    if call in ("len", "isinstance", "type", "hasattr", "callable"):
        return True
    return False


@register(
    "tensor-branch",
    "Python if/while on a tensor's value in hot code (an implicit sync; a "
    "capture error inside a CUDA graph): use torch.where or decide on the host",
)
def check_tensor_branch(src: SourceFile) -> Iterator[Finding]:
    if src.is_test:
        return
    for ctx in U.walk_functions(src.tree, src.rel):
        if not ctx.hot:
            continue
        host = U.host_params(ctx.node)
        dynamic = {p for p in U.param_names(ctx.node) if p not in host}
        if not dynamic:
            continue
        parents = U.build_parents(ctx.node)
        for node in U.own_nodes(ctx.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            hits = [
                n for n in ast.walk(node.test)
                if isinstance(n, ast.Name) and n.id in dynamic
                and not _name_use_is_safe(n, parents)
            ]
            if hits:
                kw = "while" if isinstance(node, ast.While) else "if"
                names = ", ".join(sorted({n.id for n in hits}))
                yield Finding(
                    "tensor-branch", src.rel, node.lineno, node.col_offset,
                    f"Python `{kw}` on possibly-tensor value(s) {names} in hot code "
                    f"(`{ctx.qualname}`, {ctx.why}) waits for the card, and raises "
                    "inside a CUDA-graph capture; use torch.where, or take the "
                    "decision from host data (annotate a host parameter int/bool)",
                    src.anchor(node.lineno))


# --------------------------------------------------------------------------
# launch-contract
# --------------------------------------------------------------------------

#: calls whose result is a fresh tensor, contiguous, of the dtype asked for
_ALLOCATORS = {"empty", "zeros", "ones", "full", "empty_like", "zeros_like",
               "ones_like", "full_like", "arange", "tensor"}
#: the wrappers' input checks (dtype, shape and contiguity at once):
#: ``check_cuda_input(t, ...)``, and ``check_prepared(prep, cfg)`` over a
#: prepared table's three tensors
_INPUT_CHECKS = {"check_cuda_input", "check_prepared"}


def _is_allocation(node: ast.expr | None, factories: set[str]) -> bool:
    """A fresh tensor: ``torch.empty(...)``-style, a ``.contiguous()`` (the
    caller's shape check aside, contiguity is the kernel's layout), a local
    factory returning one, or a container or generator of only those."""
    if node is None:
        return False
    if isinstance(node, ast.Call):
        head = U.dotted_name(node.func)
        if head.startswith("torch.") and head.rsplit(".", 1)[-1] in _ALLOCATORS:
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr == "contiguous":
            return True
        return isinstance(node.func, ast.Name) and node.func.id in factories
    if isinstance(node, (ast.Tuple, ast.List)):
        return bool(node.elts) and all(_is_allocation(e, factories) for e in node.elts)
    if isinstance(node, ast.Dict):
        return bool(node.values) and all(_is_allocation(v, factories) for v in node.values)
    if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
        return _is_allocation(node.elt, factories)
    if isinstance(node, ast.Starred):
        return _is_allocation(node.value, factories)
    return False


def _local_factories(fn: U.FnDef) -> set[str]:
    """Nested defs of ``fn`` whose every return is an allocation."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            rets = [r for r in ast.walk(node) if isinstance(r, ast.Return)]
            if rets and all(_is_allocation(r.value, set()) for r in rets):
                out.add(node.name)
    return out


def _targets(t: ast.expr) -> list[ast.expr]:
    return list(t.elts) if isinstance(t, (ast.Tuple, ast.List)) else [t]


def _bindings(fn: U.FnDef) -> Iterator[tuple[str, ast.expr]]:
    """(name, value) of each plain assignment in ``fn``: ``a, b = x, y``
    pairs element by element, ``a, b = gen`` binds both names to ``gen``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            val = node.value
            if (isinstance(tgt, (ast.Tuple, ast.List)) and isinstance(val, (ast.Tuple, ast.List))
                    and len(tgt.elts) == len(val.elts)):
                pairs = list(zip(tgt.elts, val.elts))
            else:
                pairs = [(t, val) for t in _targets(tgt)]
            for t, v in pairs:
                if isinstance(t, ast.Name):
                    yield t.id, v


def _checked_names(fn: U.FnDef, helpers: dict[str, set[int]]) -> set[str]:
    """Names whose tensors ``fn`` checks or allocates itself.

    A name is checked when it (or ``name[...]``) is passed to an input
    check, when a loop binds the checked name over a container that lists
    it, when it is handed to a module-local helper at a position that helper
    checks, when it is bound to an allocation, and when it is bound to a
    checked name's field or item (``bases = prep.bases``).
    """
    factories = _local_factories(fn)
    bindings = list(_bindings(fn))
    out = {name for name, val in bindings if _is_allocation(val, factories)}
    loops: dict[str, set[str]] = {}
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.comprehension)):
            listed = {n.id for n in ast.walk(node.iter) if isinstance(n, ast.Name)}
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    loops.setdefault(t.id, set()).update(listed)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        head = U.dotted_name(node.func).rsplit(".", 1)[-1]
        if head in _INPUT_CHECKS and node.args:
            base = U.root_name(node.args[0])
            if base is not None:
                out.add(base)
                out |= loops.get(base, set())
        elif isinstance(node.func, ast.Name) and node.func.id in helpers:
            for i in helpers[node.func.id]:
                if i < len(node.args):
                    base = U.root_name(node.args[i])
                    if base is not None:
                        out.add(base)
    out |= {name for name, listed in loops.items() if listed and listed <= out}
    out |= {name for name, val in bindings
            if isinstance(val, (ast.Attribute, ast.Subscript)) and U.root_name(val) in out}
    return out


def _helper_checks(tree: ast.Module) -> dict[str, set[int]]:
    """Module-level functions -> positional parameter indices they check
    with ``check_cuda_input`` (directly or through a loop over them)."""
    out: dict[str, set[int]] = {}
    for fn in tree.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        pos = U.positional_param_names(fn)
        checked = _checked_names(fn, {})
        idx = {i for i, p in enumerate(pos) if p in checked}
        if idx and any(isinstance(n, ast.Call)
                       and U.dotted_name(n.func).rsplit(".", 1)[-1] in _INPUT_CHECKS
                       for n in ast.walk(fn)):
            out[fn.name] = idx
    return out


def _data_ptr_roots(fn: U.FnDef) -> dict[str, int]:
    """Root names of ``X.data_ptr()`` receivers in ``fn`` -> first line."""
    out: dict[str, int] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "data_ptr"):
            base = U.root_name(node.func.value)
            if base is not None:
                out.setdefault(base, node.lineno)
    return out


def _rc_tested(fn: U.FnDef, call: ast.Call, parents: dict[ast.AST, ast.AST]) -> bool:
    """The launch's return code reaches a test, an assert or a return."""
    cur: ast.AST = call
    while cur in parents and not isinstance(cur, ast.stmt):
        if isinstance(parents[cur], (ast.Compare, ast.If, ast.IfExp, ast.Assert)):
            return True
        cur = parents[cur]
    if isinstance(cur, ast.Return):
        return True
    if not isinstance(cur, ast.Assign):
        return False
    names = {t.id for tgt in cur.targets for t in _targets(tgt) if isinstance(t, ast.Name)}
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.Return, ast.IfExp)):
            test = node.value if isinstance(node, ast.Return) else node.test
            if test is not None and any(isinstance(n, ast.Name) and n.id in names
                                        for n in ast.walk(test)):
                return True
    return False


@register(
    "launch-contract",
    "data_ptr() handed to a kernel launch from a tensor the wrapper never "
    "checked (dtype, shape, contiguity) or allocated, or a launch whose return "
    "code is never tested",
)
def check_launch_contract(src: SourceFile) -> Iterator[Finding]:
    if src.is_test or not any(n.endswith("_launch") for n in U.identifiers(src.tree)):
        return
    graph = CG.build_callgraph(src.tree, src.rel)
    helpers = _helper_checks(src.tree)
    seen: set[tuple[str, int]] = set()
    for qualname, fnode in graph.nodes.items():
        fn = fnode.node
        launches = U.launch_calls(fn)
        if not launches:
            continue
        parents = U.build_parents(fn)
        for call in launches:
            if not _rc_tested(fn, call, parents):
                yield Finding(
                    "launch-contract", src.rel, call.lineno, call.col_offset,
                    f"`{qualname}` drops the return code of {call.func.attr}(); "  # type: ignore[attr-defined]
                    "a failed launch (bad shared-memory size, bad shape) then "
                    "passes silently — test it and raise",
                    src.anchor(call.lineno))
        # this function and the module-local helpers it calls hand pointers on
        scope = [qualname] + sorted(c for c in fnode.callees if c in graph.nodes)
        caller_checked = _checked_names(fn, helpers)
        for q in scope:
            helper = graph.nodes[q].node
            checked = _checked_names(helper, helpers)
            if q != qualname:           # a helper's parameters come checked by the caller
                checked |= {p for p in U.param_names(helper)
                            if _passed_checked(fn, q, p, helper, caller_checked)}
            bad: dict[int, list[str]] = {}
            for base, line in _data_ptr_roots(helper).items():
                if base not in checked:
                    bad.setdefault(line, []).append(base)
            for line, names in sorted(bad.items()):
                if (q, line) in seen:
                    continue
                seen.add((q, line))
                yield Finding(
                    "launch-contract", src.rel, line, 0,
                    f"`{q}` hands the data_ptr() of {', '.join(sorted(names))} to "
                    f"a kernel launch in `{qualname}` without checking dtype, shape "
                    "and contiguity (check_cuda_input) or allocating it; the "
                    "kernel reads whatever memory the pointer names",
                    src.anchor(line))


def _passed_checked(caller: U.FnDef, callee: str, param: str, helper: U.FnDef,
                    caller_checked: set[str]) -> bool:
    """Every call of ``callee`` in ``caller`` passes a checked name as
    ``param``."""
    pos = U.positional_param_names(helper)
    calls = [n for n in ast.walk(caller) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == callee]
    if not calls:
        return False
    for call in calls:
        arg: ast.expr | None = None
        if param in pos and pos.index(param) < len(call.args):
            arg = call.args[pos.index(param)]
        for kw in call.keywords:
            if kw.arg == param:
                arg = kw.value
        base = U.root_name(arg) if arg is not None else None
        if base is None or base not in caller_checked:
            return False
    return True


# --------------------------------------------------------------------------
# unseeded-random
# --------------------------------------------------------------------------

_NP_LEGACY = {
    "seed", "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "beta", "binomial", "poisson", "exponential",
}
_STDLIB_RANDOM = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "getrandbits", "seed",
}
#: torch samplers that take ``generator=``
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                   "multinomial", "poisson"}
#: torch samplers with no ``generator=`` at all
_TORCH_LIKE_SAMPLERS = {"rand_like", "randn_like", "randint_like"}
#: in-place tensor samplers that take ``generator=``
_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_", "exponential_",
                     "geometric_", "log_normal_", "cauchy_"}
#: ``nn.init`` functions that draw no random numbers
_INIT_DETERMINISTIC = {"zeros_", "ones_", "constant_", "eye_", "dirac_",
                       "calculate_gain"}
#: process-global torch seeding
_TORCH_SEEDERS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                  "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                  "torch.cuda.seed", "torch.cuda.seed_all"}


def _has_generator(node: ast.Call) -> bool:
    """``generator=`` among the call's keywords (on any line of the call), or
    a ``**kwargs`` that may carry it."""
    return any(kw.arg in ("generator", None) for kw in node.keywords)


def _random_message(node: ast.Call) -> str | None:
    name = U.dotted_name(node.func)
    if name.startswith("np.random.") or name.startswith("numpy.random."):
        attr = name.rsplit(".", 1)[1]
        if attr in _NP_LEGACY:
            return (f"{name}() uses the legacy global NumPy RNG; pass an "
                    "explicit np.random.default_rng(seed) Generator")
        if attr == "default_rng" and not node.args and not node.keywords:
            return ("np.random.default_rng() without a seed is "
                    "non-reproducible; thread a seed through")
        return None
    if name.startswith("random.") and name.split(".", 1)[1] in _STDLIB_RANDOM:
        return (f"{name}() draws from the unseeded process-global RNG; "
                "use random.Random(seed) or numpy's seeded Generator")
    if name in _TORCH_SEEDERS:
        return (f"{name}() seeds torch's process-global generator, which every "
                "caller in the process shares; thread a torch.Generator(...)"
                ".manual_seed(seed) through instead")
    tail = name.rsplit(".", 1)[-1]
    if name == f"torch.{tail}" and tail in _TORCH_LIKE_SAMPLERS:
        return (f"{name}() takes no generator= and draws from the global "
                f"generator; use torch.{tail[:-5]}(x.shape, generator=g, ...)")
    if name == f"torch.{tail}" and tail in _TORCH_SAMPLERS and not _has_generator(node):
        return (f"{name}() without generator= draws from torch's process-global "
                "generator; pass a seeded torch.Generator")
    if (name.startswith(("torch.nn.init.", "nn.init.", "init.")) and tail.endswith("_")
            and tail not in _INIT_DETERMINISTIC and not _has_generator(node)):
        return (f"{name}() without generator= draws from torch's process-global "
                "generator; pass a seeded torch.Generator")
    if (isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_SAMPLERS
            and not name.startswith(("torch.nn.init.", "nn.init.", "init."))
            and not _has_generator(node)):
        return (f".{node.func.attr}() without generator= draws from torch's "
                "process-global generator; pass a seeded torch.Generator")
    return None


@register(
    "unseeded-random",
    "legacy/unseeded RNG (np.random.*, random.*, torch samplers without "
    "generator=, torch.manual_seed) outside tests breaks reproducibility",
)
def check_unseeded_random(src: SourceFile) -> Iterator[Finding]:
    if src.is_test:
        return
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        msg = _random_message(node)
        if msg is not None:
            yield Finding("unseeded-random", src.rel, node.lineno,
                          node.col_offset, msg, src.anchor(node.lineno))


# --------------------------------------------------------------------------
# graph-capture-global
# --------------------------------------------------------------------------

#: the hot reasons under which a function's body is compiled or replayed
_CAPTURED = {"torch.compile", "CUDA graph", "HOT_ENTRIES"}
_MUTATORS = {"update", "append", "extend", "add", "pop", "popitem",
             "clear", "setdefault", "insert", "remove", "discard"}


def _module_mutated_containers(tree: ast.Module) -> set[str]:
    """Module-level dict/list/set displays mutated somewhere in the module."""
    containers: set[str] = set()
    for node in tree.body:
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                              ast.ListComp, ast.SetComp)):
            containers |= {t.id for t in targets if isinstance(t, ast.Name)}
    mutated: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, (ast.Assign, ast.Delete))
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id in containers):
                    mutated.add(t.value.id)
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS
                    and isinstance(fn.value, ast.Name) and fn.value.id in containers):
                mutated.add(fn.value.id)
    return mutated


@register(
    "graph-capture-global",
    "compiled or CUDA-graph-captured code reading a module-level container "
    "mutated elsewhere (a stale capture), or torch.compile on a bare lambda",
)
def check_graph_capture_global(src: SourceFile) -> Iterator[Finding]:
    if src.is_test:
        return
    mutated = _module_mutated_containers(src.tree) if any(
        c.why in _CAPTURED for c in U.walk_functions(src.tree, src.rel)) else set()
    for ctx in U.walk_functions(src.tree, src.rel):
        if not mutated or ctx.why not in _CAPTURED:
            continue
        local_names = set(U.param_names(ctx.node))
        for node in U.own_nodes(ctx.node):
            if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                    and node.id in mutated and node.id not in local_names):
                yield Finding(
                    "graph-capture-global", src.rel, node.lineno, node.col_offset,
                    f"`{ctx.qualname}` ({ctx.why}) reads module-level container "
                    f"`{node.id}` that is mutated elsewhere in this module; a "
                    "compiled graph guards on it or a CUDA graph replays the "
                    "capture-time value — pass it as an argument",
                    src.anchor(node.lineno))
                break  # one finding per function is enough
    for node in ast.walk(src.tree):
        if (isinstance(node, ast.Call)
                and (U.dotted_name(node.func) == "torch.compile"
                     or U.dotted_name(node.func).endswith("make_graphed_callables"))
                and node.args and isinstance(node.args[0], ast.Lambda)):
            yield Finding(
                "graph-capture-global", src.rel, node.lineno, node.col_offset,
                f"{U.dotted_name(node.func)} on a bare lambda: every evaluation "
                "builds a new function object and a new compile; def a named fn once",
                src.anchor(node.lineno))
