"""A configuration, a traffic mix and a per-layer metric are added as new
files, with no file of the benchmark edited, and the harness finds them by
the names in ``BENCHMARK.json``."""
from __future__ import annotations

import hashlib
import json
import shutil
import time

import torch

from bench import harness
from bench.trace import View, breakdown, marker_window

from bench.tests.tiny import REPO, TINY, TINY_FR


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_by_new_files(tmp_path):
    repo = tmp_path / "checkout"
    shutil.copytree(REPO / "bench", repo / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", repo)
    bench = repo / "bench"
    before = _digests(bench)

    config = json.loads((bench / "configs" / "mixtral-8x22b.json").read_text())
    config.update(TINY["mixtral-8x22b.decode-32k"][0], fr=TINY_FR,
                  table_fit={"iters": 8, "sample_words": 4096})
    (bench / "configs" / "tiny-model.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "decode-32k.json").read_text())
    traffic.update(TINY["mixtral-8x22b.decode-32k"][1], batch=3)
    (bench / "traffic" / "tiny-mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(view):\n    return len(view.steps) or None\n")
    spec = json.loads((repo / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-model.tiny-mix", "config": "tiny-model",
                              "traffic": "tiny-mix", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "decode_tok_s", "workloads": ["tiny-model.tiny-mix"]})
    for m in spec["end_to_end"]:
        if m["name"] == "decode_tok_s":
            m["workloads"].append("tiny-model.tiny-mix")
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("tiny-model.tiny-mix", repo, bench)
    assert cell.traffic["batch"] == 3 and cell.config["num_hidden_layers"] == 2
    assert [m["name"] for m in cell.per_layer] == ["steps_traced"]
    assert {m["name"] for m in cell.end_to_end} == {"decode_tok_s", "setup_s"}
    result = harness.run(cell, 2**31 + 3, 0.3, False, torch.device("cpu"),
                         time.perf_counter(), bench)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"decode_tok_s", "setup_s"}
    reader = harness.load_module(bench, "metrics", "steps_traced")
    view = View(cell, [("k", 0.0, 1.0)], [{"kind": "decode", "t0": 0.0, "t1": 2.0}], [], 2.0)
    assert reader.read(view) == 1
    after = _digests(bench)
    assert {p: d for p, d in after.items() if p in before} == before


def test_view_and_breakdown_arithmetic():
    """Busy time is the union of device intervals; idle time goes to the host
    span it fell in, and to the harness outside every span."""
    kernels = [("a", 0.0, 1.0), ("b", 0.5, 1.0), ("encode_kernel<8, 1>", 3.0, 1.0)]
    spans = [("attention_decode", 1.5, 2.5)]
    steps = [{"kind": "decode", "t0": 0.0, "t1": 2.0}, {"kind": "decode", "t0": 2.0, "t1": 5.0}]
    view = View(None, kernels, steps, spans, window_s=5.0)
    assert view.busy_s == 2.5
    assert view.busy_in([(0.0, 2.0)]) == 1.5
    assert view.kernel_s("A") == 1.0 and view.kernel_s("C") == 0.0
    b = breakdown(view)
    assert b["device_ops"][0][1] == 1.0 and len(b["device_ops"]) == 3
    assert dict(b["idle_gaps"]) == {"attention_decode": 1.0, "harness": 1.5}


def test_marker_window_matches_the_host_span():
    # five warm-up markers, the start at 1.0 s and the end at 9.0 s
    marks = [0.1, 0.2, 0.3, 0.4, 0.5, 1.0, 9.0]
    assert marker_window(marks, 8.0005) == (1.0, 9.0)
    assert marker_window([0.3, 1.0, 9.0], 8.0) == (1.0, 9.0)      # warm-ups lost
    assert marker_window([8.99, 9.0], 8.0) is None                # the start lost
    assert marker_window([9.0], 8.0) is None
