"""Tests for repro_torch.analysis, the port's static-analysis gate.

Three groups: the rules the port keeps from ``repro.analysis`` held against
the reference on the same fixture sources (findings key for key, the
baseline, the schema-drift diff, the CLI's exit codes); each port checker
firing and staying silent on its fixtures; and the Hopper shared-memory
model's report against the kernel modules' own formulas.  Fixtures are
in-memory projects (``ast.parse``, no files) unless a rule reads files.
"""
import ast
import json
import re
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_an
import repro_torch.analysis as an
from repro.analysis.cli import main as ref_cli_main
from repro.analysis.engine import findings_of as ref_findings_of
from repro_torch.analysis import smem_cost
from repro_torch.analysis.cli import default_paths
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.engine import findings_of
from repro_torch.analysis.project import load_project

REPO = Path(__file__).resolve().parent.parent
PORT_IDS = {"backend-parity", "cuda-host-sync", "format-magic-literal", "format-schema-drift",
            "graph-capture-global", "launch-contract", "smem-over-budget", "stream-lifetime",
            "tensor-branch", "unbounded-module-cache", "unseeded-random"}


def make_project(files, root=Path("/proj"), pkg=an):
    mod = pkg.project
    srcs = []
    for rel, text in files.items():
        text = textwrap.dedent(text)
        srcs.append(mod.SourceFile(path=root / rel, rel=rel, text=text, tree=ast.parse(text)))
    return mod.Project(root=root, files=srcs)


def checks_of(files, check_id, root=Path("/proj")):
    return findings_of(make_project(files, root), [check_id])


def both(files, check_id, root=Path("/proj")):
    """(reference findings, port findings) of one checker on the same files."""
    ref = ref_findings_of(make_project(files, root, ref_an), [check_id])
    port = findings_of(make_project(files, root, an), [check_id])
    return ref, port


def keys(fs):
    return [(f.key, f.line, f.col) for f in fs]


# --------------------------------------------------------------------------
# held against repro.analysis on shared inputs
# --------------------------------------------------------------------------

_CACHE_FIXTURES = {
    "dict memo": """
        _MEMO = {}

        def get(k):
            if k not in _MEMO:
                _MEMO[k] = k * 2
            return _MEMO[k]
    """,
    "unbounded lru": """
        import functools

        @functools.lru_cache(maxsize=None)
        def f(x):
            return x

        @functools.cache
        def g(x):
            return x
    """,
    "bounded and fixed-schema": """
        import collections
        import functools

        _C = collections.OrderedDict()
        _STATS = {"hits": 0}

        def put(k, v):
            _C[k] = v
            _STATS["hits"] += 1
            while len(_C) > 8:
                _C.popitem(last=False)

        @functools.lru_cache(maxsize=64)
        def h(x):
            return x
    """,
    "setdefault grows": """
        _REG = dict()

        def add(name, fn):
            _REG.setdefault(name, fn)
    """,
}


@pytest.mark.parametrize("name", sorted(_CACHE_FIXTURES))
def test_unbounded_module_cache_matches_reference(name):
    ref, port = both({"src/a.py": _CACHE_FIXTURES[name]}, "unbounded-module-cache")
    assert keys(port) == keys(ref)
    assert bool(port) == (name != "bounded and fixed-schema")


_RANDOM_FIXTURES = {
    "legacy numpy": """
        import numpy as np

        a = np.random.rand(3)
        np.random.seed(0)
        b = np.random.default_rng()
    """,
    "stdlib": """
        import random

        x = random.random()
        random.shuffle([1, 2])
    """,
    "seeded": """
        import numpy as np
        import random

        rng = np.random.default_rng(0)
        a = rng.normal(size=3)
        r = random.Random(1).random()
    """,
    "duplicate lines": """
        import numpy as np

        def f():
            x = np.random.rand(3)
            return x

        def g():
            x = np.random.rand(3)
            return x
    """,
}


@pytest.mark.parametrize("name", sorted(_RANDOM_FIXTURES))
def test_unseeded_random_numpy_and_stdlib_match_reference(name):
    ref, port = both({"src/a.py": _RANDOM_FIXTURES[name]}, "unseeded-random")
    assert keys(port) == keys(ref)
    assert bool(port) == (name != "seeded")


def test_unseeded_random_skips_tests_in_both():
    files = {"tests/test_a.py": _RANDOM_FIXTURES["legacy numpy"]}
    ref, port = both(files, "unseeded-random")
    assert ref == port == []


def test_baseline_loads_reference_file_and_suppresses_the_same(tmp_path):
    src = {"src/a.py": _RANDOM_FIXTURES["duplicate lines"]}
    anchor = "x = np.random.rand(3)"
    (tmp_path / "b.json").write_text(json.dumps({"entries": [
        {"check": "unseeded-random", "path": "src/a.py", "anchor": anchor,
         "justification": "fixture", "occurrence": 1}]}))
    ref_bl = ref_an.Baseline.load(tmp_path / "b.json")
    port_bl = an.Baseline.load(tmp_path / "b.json")
    assert [e.key for e in port_bl.entries] == [e.key for e in ref_bl.entries]
    ref_rep = ref_an.run_analysis(make_project(src, pkg=ref_an),
                                  checks=[ref_an.get_check("unseeded-random")], baseline=ref_bl)
    port_rep = an.run_analysis(make_project(src), checks=[an.get_check("unseeded-random")],
                               baseline=port_bl)
    assert [f.key for f, _ in port_rep.suppressed] == [f.key for f, _ in ref_rep.suppressed]
    assert [f.key for f in port_rep.new] == [f.key for f in ref_rep.new]
    assert [f.occurrence for f in port_rep.new] == [0]
    assert port_rep.stale == ref_rep.stale == []


def test_baseline_reads_the_reference_baseline_file():
    ref_bl = ref_an.Baseline.load(REPO / "analysis-baseline.json")
    port_bl = an.Baseline.load(REPO / "analysis-baseline.json")
    assert [e.to_json() for e in port_bl.entries] == [e.to_json() for e in ref_bl.entries]


@pytest.mark.parametrize("body,err", [
    ({"entries": [{"check": "c", "path": "p", "anchor": "a", "justification": " "}]},
     "justification"),
    ({"entries": [{"check": "c", "path": "p"}]}, "missing field"),
    ({"entries": [{"check": "c", "path": "p", "anchor": "a", "justification": "j",
                   "occurrence": -1}]}, "occurrence"),
    ({"entries": [{"check": "c", "path": "p", "anchor": "a", "justification": "j"}] * 2},
     "duplicate"),
])
def test_baseline_errors_match_reference(tmp_path, body, err):
    p = tmp_path / "b.json"
    p.write_text(json.dumps(body))
    with pytest.raises(ref_an.BaselineError, match=err):
        ref_an.Baseline.load(p)
    with pytest.raises(an.BaselineError, match=err):
        an.Baseline.load(p)


def _drift_files(pkg_dir: str) -> dict:
    return {f"src/{pkg_dir}/core/format_doc.py":
            (REPO / "src" / pkg_dir / "core" / "format_doc.py").read_text(),
            f"src/{pkg_dir}/kernels/gbdi_encode.py":
            (REPO / "src" / pkg_dir / "kernels" / "gbdi_encode.py").read_text()}


def _drift_both(root: Path):
    ref = ref_findings_of(make_project(_drift_files("repro"), root, ref_an),
                          ["format-schema-drift"])
    port = findings_of(make_project(_drift_files("repro_torch"), root, an),
                       ["format-schema-drift"])
    return ref, port


def test_schema_drift_silent_in_both_on_the_real_format_doc():
    ref, port = _drift_both(REPO)
    assert ref == port == []


def test_schema_drift_port_layout_equals_reference_layout():
    from repro.analysis.format_checkers import _serializer_layout as ref_layout
    from repro_torch.analysis.format_checkers import _serializer_layout as port_layout

    ref_src = make_project(_drift_files("repro"), pkg=ref_an).files[0]
    port_src = make_project(_drift_files("repro_torch")).files[0]
    assert port_layout(port_src) == ref_layout(ref_src)
    assert port_layout(port_src) == [("profile", 1), ("ptrs", 4), ("deltas", 4),
                                     ("out_vals", "word"), ("out_idx", 2), ("n_out", 4)]


def test_schema_drift_fires_in_both_at_the_same_doc_line(tmp_path):
    doc = (REPO / "docs" / "FORMAT.md").read_text()
    a = "out_vals     : outlier_cap · word_bits/8 bytes (word-sized unsigned LE)"
    b = "out_idx      : outlier_cap · 2 bytes (uint16 LE page positions)"
    assert a in doc and b in doc
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "FORMAT.md").write_text(
        doc.replace(a, "@@A@@").replace(b, a).replace("@@A@@", b))
    ref, port = _drift_both(tmp_path)
    assert len(ref) == len(port) == 1
    assert (port[0].path, port[0].line, port[0].anchor) == (ref[0].path, ref[0].line,
                                                            ref[0].anchor)
    assert "diverges from format_doc.serialize_page" in port[0].message


def _write_tree(root: Path, files: dict):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


@pytest.mark.parametrize("case", ["clean", "finding", "baselined", "stale", "bad-baseline",
                                  "syntax-error", "unknown-check"])
def test_cli_exit_codes_match_reference(tmp_path, case, capsys):
    files = {"src/a.py": "x = 1\n"}
    if case in ("finding", "baselined"):
        files = {"src/a.py": "import numpy as np\n\na = np.random.rand(3)\n"}
    if case == "syntax-error":
        files = {"src/a.py": "def f(:\n"}
    _write_tree(tmp_path, files)
    argv = [str(tmp_path / "src"), "--root", str(tmp_path)]
    if case in ("baselined", "stale", "bad-baseline"):
        bl = tmp_path / "b.json"
        bl.write_text("{not json" if case == "bad-baseline" else json.dumps({"entries": [{
            "check": "unseeded-random", "path": "src/a.py", "anchor": "a = np.random.rand(3)",
            "justification": "fixture"}]}))
        argv += ["--baseline", str(bl)]
    if case == "unknown-check":
        argv += ["--checks", "no-such-check"]
    rc_ref = ref_cli_main(argv)
    rc_port = cli_main(argv)
    assert rc_port == rc_ref == {"clean": 0, "finding": 1, "baselined": 0, "stale": 1,
                                 "bad-baseline": 2, "syntax-error": 2,
                                 "unknown-check": 2}[case]
    if case == "clean":
        assert "repro_torch.analysis: 0 finding(s)" in capsys.readouterr().out


def test_cli_json_report(tmp_path):
    _write_tree(tmp_path, {"src/a.py": "import torch\n\nx = torch.randn(3)\n"})
    out = tmp_path / "r.json"
    assert cli_main([str(tmp_path / "src"), "--root", str(tmp_path), "--json", str(out)]) == 1
    report = json.loads(out.read_text())
    assert not report["ok"] and report["new"][0]["check"] == "unseeded-random"


# --------------------------------------------------------------------------
# cuda-host-sync
# --------------------------------------------------------------------------

_LAUNCHER = """
    import numpy as np
    import torch
    from repro_torch.kernels import _build

    def run(x, pos: int, cfg):
        n = x.item()
        torch.cuda.synchronize()
        a = float(x)
        b = np.asarray(x)
        c = int(pos) + int(x.shape[0]) + int(len(cfg)) + int(x.numel())
        rc = _build.load("k").k_launch(x.data_ptr(), n)
        if rc != 0:
            raise RuntimeError(rc)
"""


def test_host_sync_fires_in_a_kernel_launcher():
    fs = checks_of({"src/repro_torch/kernels/k.py": _LAUNCHER}, "cuda-host-sync")
    lines = sorted(f.line for f in fs)
    assert lines == [7, 8, 9, 10]           # item, synchronize, float(x), np.asarray(x)


def test_host_sync_propagates_through_module_helper():
    fs = checks_of({"src/repro_torch/kernels/k.py": """
        def _plan(x):
            return x.tolist()

        def host_only(x):
            return x.cpu().numpy()

        def run(x):
            plan = _plan(x)
            rc = _lib().k_launch(plan)
            if rc:
                raise RuntimeError(rc)
    """}, "cuda-host-sync")
    assert len(fs) == 1 and fs[0].line == 3
    assert "trace-reachable" in fs[0].message and "`run`" in fs[0].message


def test_host_sync_in_compiled_captured_and_hot_entry_code():
    fs = checks_of({"src/repro_torch/serving/engine.py": """
        import torch

        @torch.compile
        def fused(x):
            return x.sum().item()

        def body(x):
            return float(x)

        def capture(g, x):
            y = x.cpu()
            with torch.cuda.graph(g):
                z = body(x)
                w = x.tolist()
            return y, z, w

        class Engine:
            def tick(self, logits):
                return self._next(logits)

            def _next(self, logits):
                return logits.argmax(-1).cpu()

            def admit(self, logits):
                return logits.cpu()
    """}, "cuda-host-sync")
    lines = sorted(f.line for f in fs)
    # fused .item(); body's float() (called in a capture); .tolist() in the
    # capture block; Engine._next reached from Engine.tick (HOT_ENTRIES)
    assert lines == [6, 9, 15, 23]
    assert any("torch.cuda.graph capture" in f.message for f in fs)
    assert all(f.line != 12 and f.line != 26 for f in fs)


def test_host_sync_silent_on_host_code_tests_and_boundaries():
    files = {
        "src/repro_torch/eval/run.py": """
            def report(x):
                return x.item(), float(x), x.cpu().numpy()
        """,
        "tests/test_torch_x.py": _LAUNCHER,
        "src/repro_torch/kernels/k.py": """
            import torch

            def _dispatch(x):
                if torch.compiler.is_compiling():
                    return x
                return _host(x)

            def _host(x):
                return x.item()

            def run(x):
                y = _dispatch(x)
                rc = _lib().k_launch(y)
                assert rc == 0
        """,
    }
    assert checks_of(files, "cuda-host-sync") == []


# --------------------------------------------------------------------------
# tensor-branch
# --------------------------------------------------------------------------


def test_tensor_branch_fires_on_value_tests():
    fs = checks_of({"src/repro_torch/kernels/k.py": """
        def run(x, y):
            if x.sum() > 0:
                pass
            while y:
                break
            rc = _lib().k_launch(x, y)
            if rc:
                raise RuntimeError(rc)
    """}, "tensor-branch")
    assert [f.line for f in fs] == [3, 5]
    assert "x" in fs[0].message and "launches a kernel" in fs[0].message


def test_tensor_branch_silent_on_metadata_none_and_host_params():
    fs = checks_of({"src/repro_torch/kernels/k.py": """
        def run(x, q, n: int, flag: bool, cfg, table=None):
            if x.shape[0] == 0 or x.numel() == 0 or x.dim() > 2:
                return
            if x.device.type == "cpu" or not x.is_contiguous():
                return
            if table is None or isinstance(q, dict) or len(q) > 3:
                return
            if n > 0 and flag and cfg.word_bits == 16:
                pass
            rc = _lib().k_launch(x)
            if rc:
                raise RuntimeError(rc)
    """}, "tensor-branch")
    assert fs == []


# --------------------------------------------------------------------------
# launch-contract
# --------------------------------------------------------------------------


def test_launch_contract_fires_on_unchecked_pointer_and_dropped_code():
    fs = checks_of({"src/repro_torch/kernels/k.py": """
        import torch
        from repro_torch.kernels import _build

        def run(x, table):
            out = torch.empty(4)
            lib = _build.load("k")
            lib.k_launch(_build.ptr_array([x.data_ptr(), table.data_ptr(), out.data_ptr()]))
    """}, "launch-contract")
    msgs = sorted(f.message for f in fs)
    assert len(fs) == 2
    assert any("drops the return code" in m for m in msgs)
    assert any("data_ptr() of table, x" in m for m in msgs)


def test_launch_contract_silent_when_checked_allocated_or_helper_checked():
    fs = checks_of({"src/repro_torch/kernels/k.py": """
        import torch
        from repro_torch.kernels import _build
        from repro_torch.kernels.gbdi_encode import check_cuda_input, check_prepared

        def _check_pages(cfg, pages_k, pages_v):
            for side, pages in (("k", pages_k), ("v", pages_v)):
                check_cuda_input(pages["ptrs"], side, (1,))

        def _ptrs(pages):
            return [pages[k].data_ptr() for k in ("ptrs",)]

        def run(x, q, pages_k, pages_v, prep, cfg):
            check_cuda_input(x, "x", (4,))
            q = q.float().contiguous()
            _check_pages(cfg, pages_k, pages_v)
            check_prepared(prep, cfg)
            bases, cls = prep.bases, prep.cls

            def f32(*shape):
                return torch.empty(shape)

            acc, m = f32(4), f32(2)
            outs = (torch.empty(3) for _ in "kv")
            blob = {"a": f32(1), "b": f32(2)}
            ptrs = [x.data_ptr(), q.data_ptr(), *_ptrs(pages_k), *_ptrs(pages_v),
                    bases.data_ptr(), cls.data_ptr(), acc.data_ptr(), m.data_ptr(),
                    *(o.data_ptr() for o in outs), *(blob[k].data_ptr() for k in blob)]
            rc = _build.load("k").k_launch(ptrs)
            if rc != 0:
                raise RuntimeError(rc)
    """}, "launch-contract")
    assert fs == []


def test_launch_contract_flags_helper_pointer_of_an_unchecked_argument():
    fs = checks_of({"src/repro_torch/kernels/k.py": """
        def _ptrs(pages):
            return [pages[k].data_ptr() for k in ("ptrs",)]

        def run(pages):
            rc = _lib().k_launch(_ptrs(pages))
            if rc:
                raise RuntimeError(rc)
    """}, "launch-contract")
    assert len(fs) == 1 and fs[0].line == 3 and "`_ptrs`" in fs[0].message


# --------------------------------------------------------------------------
# unseeded-random (the torch rules)
# --------------------------------------------------------------------------


def test_unseeded_random_fires_on_torch_samplers_and_global_seeding():
    fs = checks_of({"src/a.py": """
        import torch
        from torch import nn

        a = torch.randn(3)
        b = torch.randint(0, 4, (2,))
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        w = torch.empty(3).normal_()
        nn.init.normal_(w)
        torch.nn.init.kaiming_uniform_(w)
        c = torch.rand_like(w)
        d = torch.multinomial(w, 1)
    """}, "unseeded-random")
    assert [f.line for f in fs] == [5, 6, 7, 8, 9, 10, 11, 12, 13]


def test_unseeded_random_reads_keywords_not_lines():
    fs = checks_of({"src/a.py": """
        import torch
        from torch import nn

        gen = torch.Generator().manual_seed(12)
        a = torch.randint(0, 7, (4, 32),
                          generator=gen, device="cpu")
        b = torch.randn(
            3,
            generator=gen,
        )
        w = torch.empty(3).uniform_(generator=gen)
        nn.init.normal_(w, generator=gen)
        nn.init.zeros_(w)
        c = torch.rand(3, **{"generator": gen})
        g2 = torch.Generator(device="cpu").manual_seed(0)
    """}, "unseeded-random")
    assert fs == []


def test_unseeded_random_real_generator_continuation_lines_stay_silent():
    src = (REPO / "chip_smoke.py").read_text()
    lines = src.splitlines()
    hits = [i + 1 for i, line in enumerate(lines)
            if "torch.randint(" in line and "generator=" not in line]
    assert hits, "chip_smoke.py passes generator= on a continuation line somewhere"
    fs = findings_of(make_project({"chip_smoke.py": src}), ["unseeded-random"])
    assert fs == []


# --------------------------------------------------------------------------
# graph-capture-global
# --------------------------------------------------------------------------


def test_graph_capture_global_fires_on_mutated_global_and_lambda():
    fs = checks_of({"src/a.py": """
        import torch

        _TABLE = {}

        def register(k, v):
            _TABLE[k] = v

        @torch.compile
        def f(x):
            return x * _TABLE["scale"]

        def g(x):
            return x + _TABLE["bias"]

        def capture(graph, x):
            with torch.cuda.graph(graph):
                y = g(x)
            return y

        h = torch.compile(lambda x: x + 1)
    """}, "graph-capture-global")
    assert sorted(f.line for f in fs) == [11, 14, 21]


def test_graph_capture_global_silent_on_read_only_globals_and_eager_code():
    fs = checks_of({"src/a.py": """
        import torch

        _TABLE = {"scale": 2}
        _SEEN = []

        def note(x):
            _SEEN.append(x)
            return x * _TABLE["scale"]

        @torch.compile
        def f(x):
            return x * _TABLE["scale"]

        h = torch.compile(f)
    """}, "graph-capture-global")
    assert fs == []


# --------------------------------------------------------------------------
# stream-lifetime
# --------------------------------------------------------------------------


def test_stream_lifetime_fires_on_unordered_side_stream_and_early_host_read():
    fs = checks_of({"src/a.py": """
        import torch

        def copy_on_side(x, out):
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                out.copy_(x, non_blocking=True)
            return out

        def fetch(x):
            y = x.to("cpu", non_blocking=True)
            return y.numpy()
    """}, "stream-lifetime")
    assert [f.line for f in fs] == [6, 12]
    assert "reads out, x" in fs[0].message and "non_blocking" in fs[1].message


def test_stream_lifetime_silent_when_ordered_or_synchronised():
    fs = checks_of({"src/a.py": """
        import torch

        def ordered(x, out):
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                out.copy_(x, non_blocking=True)

        def recorded(x):
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                y = x * 2
            x.record_stream(s)
            return y

        def fresh():
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                z = torch.zeros(3)
            return z

        def fetch(x):
            y = x.to("cpu", non_blocking=True)
            torch.cuda.current_stream().synchronize()
            return y.numpy()
    """}, "stream-lifetime")
    assert fs == []


def test_stream_lifetime_holds_the_front_end_stager_on_its_orderings():
    """``_Stager.put`` is clean because it orders its copy stream (a
    ``wait_stream``, a ``wait_event``, an event recorded on it); with those
    three lines gone from an in-memory copy, its side-stream block is flagged."""
    rel = "src/repro_torch/kernels/pipeline.py"
    text = (REPO / rel).read_text()
    assert findings_of(make_project({rel: text}), ["stream-lifetime"]) == []
    orderings = ["self.copy_stream.wait_stream(self.compute)",
                 "self.copy_stream.wait_event(self.consumed[slot])",
                 "self.copied[slot].record(self.copy_stream)"]
    for line in orderings:
        assert text.count(line) == 1
        text = text.replace(line, "pass")
    fs = findings_of(make_project({rel: text}), ["stream-lifetime"])
    assert len(fs) == 1 and "_Stager.put" in fs[0].message
    assert fs[0].anchor == "with torch.cuda.stream(self.copy_stream):"


# --------------------------------------------------------------------------
# format-magic-literal
# --------------------------------------------------------------------------


def test_magic_literal_fires_in_port_scoped_dirs():
    fs = checks_of({"src/repro_torch/serving/k.py": """
        from repro_torch.core.gbdi_fr import FRConfig

        def f(v):
            return ((v + (1 << 15)) & 0xFFFF) - (1 << 15)

        CFG = FRConfig(word_bits=16, page_words=2048)
    """}, "format-magic-literal")
    assert len(fs) == 4
    assert all("repro_torch.core.format" in f.message for f in fs)


def test_magic_literal_silent_outside_scope_and_with_constants():
    fs = checks_of({
        "src/repro_torch/core/format.py": "WORD16_MASK = 0xFFFF\n",
        "src/repro/kernels/k.py": "M = 0xFFFF\n",
        "src/repro_torch/kernels/k.py": """
            from repro_torch.core.format import WORD16_MASK, word_mask

            def f(v, cfg):
                return v & WORD16_MASK, v & word_mask(cfg.word_bits)
        """,
    }, "format-magic-literal")
    assert fs == []


# --------------------------------------------------------------------------
# backend-parity
# --------------------------------------------------------------------------

_PARITY = {
    "src/repro_torch/kernels/ref.py": "def encode_ref(x, table, cfg):\n    return x\n",
    "src/repro_torch/kernels/_build.py": 'KERNELS = ("gbdi_encode",)\n',
    "src/repro_torch/kernels/gbdi_encode.py": """
        def gbdi_encode_plain(x, table, cfg):
            return x

        def gbdi_encode(x, table, cfg):
            return x

        def smem_bytes(cfg):
            return 0
    """,
}
_CU = """
extern "C" long long gbdi_encode_smem_bytes(const int* ip) { return 0; }
extern "C" int gbdi_encode_blocks_per_sm(const int* ip) { return 1; }
extern "C" int gbdi_encode_launch(const long long* ptr, const int* ip, void* stream) {
  return 0;
}
"""


def _parity_tree(tmp_path, files=None, cu=_CU):
    csrc = tmp_path / "src/repro_torch/kernels/csrc"
    csrc.mkdir(parents=True)
    if cu is not None:
        (csrc / "gbdi_encode.cu").write_text(cu)
    return make_project(files or _PARITY, root=tmp_path)


def test_backend_parity_silent_when_every_twin_exists(tmp_path):
    assert findings_of(_parity_tree(tmp_path), ["backend-parity"]) == []


@pytest.mark.parametrize("break_it,expect", [
    ("plain", "gbdi_encode_plain"),
    ("ref", "kernels/ref.py `encode` oracle"),
    ("extern", "gbdi_encode_blocks_per_sm"),
    ("cu", "csrc/gbdi_encode.cu"),
    ("build", "_build.KERNELS"),
])
def test_backend_parity_fires_on_each_missing_twin(tmp_path, break_it, expect):
    files = dict(_PARITY)
    cu = _CU
    if break_it == "plain":
        files["src/repro_torch/kernels/gbdi_encode.py"] = \
            "def gbdi_encode(x, table, cfg):\n    return x\n"
    elif break_it == "ref":
        files["src/repro_torch/kernels/ref.py"] = "def decode_ref(b, t, cfg):\n    return b\n"
    elif break_it == "extern":
        cu = _CU.replace('extern "C" int gbdi_encode_blocks_per_sm', "int gbdi_encode_blocks_per_sm")
    elif break_it == "cu":
        cu = None
    else:
        files["src/repro_torch/kernels/_build.py"] = "KERNELS = ()\n"
    fs = findings_of(_parity_tree(tmp_path, files, cu), ["backend-parity"])
    assert len(fs) == 1 and expect in fs[0].message


def test_backend_parity_on_the_tree_flags_only_the_baselined_ops():
    project = load_project([REPO / "src/repro_torch/kernels"], root=REPO)
    fs = findings_of(project, ["backend-parity"])
    assert sorted(f.anchor for f in fs) == ["def decode_pages(", "def paged_attention_decode(",
                                            "def paged_attention_decode_tail("]
    from repro_torch.analysis.format_checkers import c_entries

    for name in smem_cost.KERNEL_MODULES.values():
        got = c_entries(REPO / "src/repro_torch/kernels/csrc" / f"{name}.cu")
        assert {f"{name}_launch", f"{name}_smem_bytes", f"{name}_blocks_per_sm"} <= got


# --------------------------------------------------------------------------
# smem-over-budget: the static tie
# --------------------------------------------------------------------------

_TIED = """
    from repro_torch.kernels import _build

    def smem_bytes(cfg):
        return 1024

    def check_smem(cfg):
        if smem_bytes(cfg) > 232448:
            raise ValueError("too big")

    def run(x, cfg):
        check_smem(cfg)
        rc = _build.load("gbdi_decode").gbdi_decode_launch(x)
        if rc:
            raise RuntimeError(rc)
"""


def test_smem_tie_fires_on_untied_and_unregistered_modules():
    fs = checks_of({"src/repro_torch/kernels/custom.py": """
        from repro_torch.kernels import _build

        def run(x):
            rc = _build.load("custom").custom_launch(x)
            if rc:
                raise RuntimeError(rc)
    """}, "smem-over-budget")
    msgs = " | ".join(f.message for f in fs)
    assert len(fs) == 3
    assert "defines no smem_bytes" in msgs and "without calling check_smem" in msgs
    assert "not registered" in msgs


def test_smem_tie_fires_when_the_check_comes_after_the_launch():
    late = _TIED.replace("        check_smem(cfg)\n", "").replace(
        "        if rc:\n", "        check_smem(cfg)\n        if rc:\n")
    fs = checks_of({"src/repro_torch/kernels/gbdi_decode.py": late}, "smem-over-budget")
    assert len(fs) == 1 and "without calling check_smem first" in fs[0].message


def test_smem_tie_silent_on_a_tied_registered_module():
    fs = checks_of({"src/repro_torch/kernels/gbdi_decode.py": _TIED}, "smem-over-budget")
    assert fs == []


def test_smem_budget_fires_on_a_config_past_the_limit(monkeypatch):
    from repro_torch.core.gbdi_fr import FRConfig

    huge = FRConfig(word_bits=16, page_words=262144, width_set=(4, 8),
                    bucket_caps=(32768, 229376), outlier_cap=64)
    monkeypatch.setattr(smem_cost, "codec_configs", lambda: [("huge", huge)])
    fs = checks_of({"src/repro_torch/kernels/gbdi_decode.py": _TIED}, "smem-over-budget")
    assert len(fs) == 1
    assert "huge" in fs[0].message and "232448 B" in fs[0].message


# --------------------------------------------------------------------------
# the shared-memory report
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def report():
    return smem_cost.full_report()


def test_smem_report_rows_equal_the_kernel_modules_formulas(report):
    from repro_torch.kernels import gbdi_decode as dec
    from repro_torch.kernels import gbdi_encode as enc
    from repro_torch.kernels import gbdi_paged_attn as pa

    assert [r.kernel for r in report] == ["gbdi_encode", "gbdi_decode"] * 4 + ["gbdi_paged_attn"] * 7
    cfgs = dict(smem_cost.codec_configs())
    for r in report[:8]:
        cfg = cfgs[r.config]
        mod = enc if r.kernel == "gbdi_encode" else dec
        assert r.smem_bytes == mod.smem_bytes(cfg)
        assert r.threads == (enc.ENCODE_THREADS if mod is enc else 32 * dec.block_warps(cfg))
    geoms = {f"KV_FR x {label} (Kv {n_kv}, hd {hd}, G {g})": (cfg, n_kv, hd, g)
             for label, cfg, n_kv, hd, g in smem_cost.attn_geometries()}
    for r in report[8:]:
        cfg, n_kv, hd, g = geoms[r.config]
        assert r.pass_slots == pa.pass_slots(cfg, n_kv=n_kv, hd=hd, groups=g)
        assert r.smem_bytes == pa.smem_bytes(cfg, n_kv=n_kv, hd=hd, groups=g)
        assert r.max_slots_smem_bytes == pa.smem_bytes(cfg, n_kv=n_kv, hd=hd, groups=g,
                                                       n_slots=r.max_slots)
        assert r.threads == pa.ATTN_WARPS * 32 == 512
    assert all(r.ok for r in report), smem_cost.render(report)


def test_smem_report_pins_the_known_figures(report):
    by = {(r.kernel, r.config): r for r in report}
    assert by["gbdi_encode", "16-bit default"].smem_bytes == 2680
    assert by["gbdi_decode", "16-bit default"].smem_bytes == 16592
    llama = by["gbdi_paged_attn", "KV_FR x llama3-405b (Kv 8, hd 128, G 16)"]
    assert (llama.pass_slots, llama.smem_bytes) == (4, 162352)
    assert (llama.max_slots, llama.max_slots_smem_bytes) == (7, 230704)
    assert llama.limit_bytes == 232448
    mixtral = by["gbdi_paged_attn", "KV_FR x mixtral-8x22b (Kv 8, hd 128, G 6)"]
    assert mixtral.pass_slots == 8
    # a row over two page slots: the block of a page's 16 heads, as at Kv 16
    deepseek = by["gbdi_paged_attn", "KV_FR x deepseek-7b (Kv 32, hd 128, G 1)"]
    assert (deepseek.pass_slots, deepseek.smem_bytes) == (8, 191152)
    assert by["gbdi_paged_attn", "KV_FR x hd-512 head (Kv 1, hd 512, G 8)"].entry == \
        "attn_kernelILi8ELb1ELb0EE"
    assert by["gbdi_encode", "16-bit default"].entry == "encode_kernelILi8ELi1EE"


@pytest.mark.parametrize("smem,threads,blocks", [
    (2680, 256, 8), (16592, 128, 13), (162352, 512, 1), (230704, 512, 1), (0, 64, 32),
    (232448, 32, 1), (110000, 256, 2),
])
def test_blocks_by_smem_is_the_least_of_three(smem, threads, blocks):
    row = smem_cost.KernelCost(module="m", kernel="k", config="c", smem_bytes=smem,
                               threads=threads, limit_bytes=232448, iparams=[], entry="e")
    assert row.blocks_by_smem == blocks
    assert row.blocks_by_smem == min(233472 // (smem + 1024), 2048 // threads, 32)


def test_card_columns_gate_the_row():
    row = smem_cost.KernelCost(module="m", kernel="k", config="c", smem_bytes=16592,
                               threads=128, limit_bytes=232448, iparams=[], entry="e")
    row.lib_smem_bytes, row.runtime_blocks = 16592, 8
    assert row.ok
    row.runtime_blocks = 14
    assert not row.ok and "runtime's 14" in row.problems[0]
    row.runtime_blocks, row.lib_smem_bytes = 8, 16600
    assert not row.ok and "the library sizes 16600 B" in row.problems[0]


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__356b02de_14_gbdi_encode_cu_749f40ff13encode_kernelILi8ELi1EEEvNS_7EncArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__356b02de_14_gbdi_encode_cu_749f40ff13encode_kernelILi8ELi1EEEvNS_7EncArgsE
    24 bytes stack frame, 44 bytes spill stores, 104 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__356b02de_14_gbdi_encode_cu_749f40ff13encode_kernelILi4ELi1EEEvNS_7EncArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__356b02de_14_gbdi_encode_cu_749f40ff13encode_kernelILi4ELi1EEEvNS_7EncArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
"""


def test_parse_ptxas_maps_each_instantiation():
    got = smem_cost.parse_ptxas(_PTXAS)
    assert len(got) == 2
    [name] = [n for n in got if "encode_kernelILi8ELi1EE" in n]
    assert got[name] == {"registers": 48, "spill_stores": 44, "spill_loads": 104}


def test_on_card_raises_without_a_cuda_device(report, monkeypatch, tmp_path, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        smem_cost.on_card(report)
    rc = cli_main(["--root", str(REPO), "--checks", "tensor-branch", "--smem-report",
                   str(tmp_path / "s.json"), "--on-card"])
    assert rc == 2 and "CUDA device" in capsys.readouterr().err
    assert cli_main(["--on-card"]) == 2


def test_cli_smem_report_writes_every_row(tmp_path):
    out = tmp_path / "smem.json"
    rc = cli_main(["src/repro_torch/kernels", "--root", str(REPO), "--checks",
                   "smem-over-budget", "--smem-report", str(out)])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert payload["available"] and not payload["on_card"]
    assert len(payload["kernels"]) == 15 and all(k["ok"] for k in payload["kernels"])
    assert {k["kernel"] for k in payload["kernels"]} == set(smem_cost.KERNEL_MODULES.values())


@pytest.mark.cuda
def test_on_card_columns_hold_on_the_card(report):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the libraries' sizes and the runtime's occupancy")
    rows = smem_cost.on_card(smem_cost.full_report())
    assert all(r.ok for r in rows), smem_cost.render(rows)
    assert all(r.registers and r.runtime_blocks >= 1 for r in rows)


# --------------------------------------------------------------------------
# the gates over the tree, the catalog, the imports
# --------------------------------------------------------------------------


def test_port_tree_is_clean():
    project = load_project(default_paths(REPO), root=REPO)
    baseline = an.Baseline.load(REPO / "analysis-baseline-torch.json")
    report = an.run_analysis(project, baseline=baseline)
    assert report.ok, "\n" + report.render_text()
    assert report.stale == [], "\n" + report.render_text()
    assert all(e.justification for e in baseline.entries)
    rels = {f.rel for f in project.files}
    assert "chip_smoke.py" in rels and "tests/test_torch_analysis.py" in rels
    assert not any(r.startswith("src/repro/") or r == "tests/test_analysis.py" for r in rels)


def test_default_paths_are_the_ports_files():
    rels = {p.relative_to(REPO).as_posix() for p in default_paths(REPO)}
    assert "src/repro_torch" in rels and "chip_smoke.py" in rels
    others = rels - {"src/repro_torch", "chip_smoke.py"}
    assert others and all(re.search(r"(^tests/test_torch_\w+|_torch)\.py$", r) for r in others)


def test_registry_lists_every_port_checker(capsys):
    assert {c.id for c in an.all_checks()} == PORT_IDS
    assert {c.id for c in an.all_checks()} - {c.id for c in an.fast_checks()} == {
        "backend-parity", "format-schema-drift", "smem-over-budget"}
    assert cli_main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    assert all(cid in out for cid in PORT_IDS)
    with pytest.raises(KeyError, match="unknown checker"):
        an.get_check("jit-host-sync")


def test_checker_catalog_documented():
    doc = (REPO / "docs" / "ANALYSIS_TORCH.md").read_text()
    for c in an.all_checks():
        assert f"`{c.id}`" in doc, f"checker {c.id} missing from docs/ANALYSIS_TORCH.md"


def test_analysis_package_imports_neither_jax_nor_the_reference():
    pkg = REPO / "src/repro_torch/analysis"
    ref_files = sorted(p.name for p in (REPO / "src/repro/analysis").glob("*.py"))
    port_files = sorted(p.name for p in pkg.glob("*.py"))
    assert len(port_files) == len(ref_files) == 14
    for path in pkg.glob("*.py"):
        text = path.read_text()
        assert not re.search(r"jax|from repro\.|import repro\b", text), path.name
        for node in ast.walk(ast.parse(text)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("jax", "repro"), (path.name, m)
        doc = ast.get_docstring(ast.parse(text)) or ""
        assert "src/repro/analysis" in doc, f"{path.name} names no reference file"
