"""``benchmarks/roofline_torch.py`` and ``benchmarks/run_torch.py``, the
port's roofline table and benchmark driver.

The reference's five smoke tests of ``benchmarks/roofline.py`` run on the
port's table; its terms equal the reference's rescaled by the ratio of the
H100 constants to the TPU v5e ones; the driver runs its sections with each
stubbed and exits 1 when one raises.  Host arithmetic only.
"""
import importlib.util
import json
import math
import pathlib
import sys

import pytest

from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import SHAPES

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_bench_{name}",
                                                  _ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


roofline = _load("roofline_torch")


def _cell(arch="gemma3-12b", shape="decode_32k", mesh="pod", n_chips=16):
    return {
        "ok": True,
        "arch": arch,
        "shape": shape,
        "mesh": mesh,
        "n_chips": n_chips,
        "variant": "baseline",
        "roofline": {
            "compute_s": 0.010,
            "memory_s": 0.025,
            "collective_s": 0.004,
            "dominant": "memory",
            "useful_flops_ratio": 0.82,
        },
    }


def _write_cells(d, cells):
    d.mkdir(parents=True, exist_ok=True)
    for i, c in enumerate(cells):
        (d / f"cell{i}.json").write_text(json.dumps(c))


def test_peak_bytes_per_s_finite():
    peak = roofline.peak_bytes_per_s()
    assert isinstance(peak, float)
    assert math.isfinite(peak)
    assert peak > 0
    # it must be the mesh module's HBM constant, not a re-derived number
    assert peak == float(HBM_BW)


def test_ideal_step_terms_positive_and_finite():
    compute_s, memory_s = roofline.ideal_step_s("gemma3-12b", "decode_32k", 16)
    assert math.isfinite(compute_s) and compute_s > 0
    assert math.isfinite(memory_s) and memory_s > 0
    # train shapes pay the 20-byte/param optimizer traffic; decode does not
    tc, tm = roofline.ideal_step_s("gemma3-12b", "train_4k", 16)
    assert math.isfinite(tc) and math.isfinite(tm) and tm > 0


def test_rows_from_synthetic_cells(tmp_path):
    _write_cells(
        tmp_path,
        [
            _cell(),
            _cell(shape="train_4k"),
            {"ok": False, "arch": "broken"},          # dropped by load_cells
            {"ok": True, "skipped": True, "arch": "x"},  # dropped too
        ],
    )
    cells = roofline.load_cells(str(tmp_path))
    assert len(cells) == 2
    rs = roofline.rows(cells)
    assert len(rs) == 2
    for r in rs:
        assert math.isfinite(r["ideal_s"]) and r["ideal_s"] > 0
        assert math.isfinite(r["roofline_frac"]) and r["roofline_frac"] > 0
        assert r["dominant"] == "memory"


def test_main_smoke(tmp_path, capsys, monkeypatch):
    _write_cells(tmp_path, [_cell(), _cell(mesh="host")])  # host cell filtered
    monkeypatch.setattr(
        sys, "argv", ["roofline_torch.py", "--dir", str(tmp_path), "--mesh", "pod"]
    )
    roofline.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("arch,shape,")
    assert len(out) == 2  # header + the one pod cell
    assert out[1].startswith("gemma3-12b,decode_32k,")


def test_main_markdown_smoke(tmp_path, capsys, monkeypatch):
    _write_cells(tmp_path, [_cell()])
    monkeypatch.setattr(
        sys,
        "argv",
        ["roofline_torch.py", "--dir", str(tmp_path), "--mesh", "pod", "--markdown"],
    )
    roofline.main()
    out = capsys.readouterr().out
    assert "| arch |" in out and "| gemma3-12b |" in out


def test_terms_are_the_reference_terms_on_h100_constants():
    from repro.launch import mesh as rmesh

    ref = _load("roofline")
    for arch in sorted(ARCHS):
        for shape, sc in SHAPES.items():
            assert roofline._kv_bytes(ARCHS[arch], sc) == ref._kv_bytes(ref.get_config(arch), sc)
            for n_chips in (256, 512):
                c, m = roofline.ideal_step_s(arch, shape, n_chips)
                rc, rm = ref.ideal_step_s(arch, shape, n_chips)
                assert c == pytest.approx(rc * rmesh.PEAK_FLOPS_BF16 / PEAK_FLOPS_BF16, rel=1e-12)
                assert m == pytest.approx(rm * rmesh.HBM_BW / HBM_BW, rel=1e-12)


def test_run_torch_runs_every_section_and_fails_on_one(tmp_path, capsys, monkeypatch):
    run = _load("run_torch")
    called = []

    class Section:
        def __init__(self, name, fail=False):
            self.name, self.fail = name, fail

        def main(self, argv):
            called.append((self.name, argv))
            if self.fail:
                raise RuntimeError(f"{self.name} failed")

    monkeypatch.chdir(tmp_path)
    _write_cells(tmp_path / roofline.DRYRUN_DIR, [_cell(n_chips=256)])
    monkeypatch.setattr(run, "_load", lambda name: roofline if name == "roofline_torch"
                        else Section(name))
    run.main()
    assert called == [(name, []) for name in run.SECTIONS]
    assert "roofline/gemma3-12b__decode_32k,0,dom=memory" in capsys.readouterr().out

    called.clear()
    monkeypatch.setattr(run, "_load", lambda name: roofline if name == "roofline_torch"
                        else Section(name, fail=name == "bench_kmeans_torch"))
    with pytest.raises(SystemExit) as exc:
        run.main()
    assert exc.value.code == 1
    assert [name for name, _ in called] == list(run.SECTIONS)   # the others still ran
    assert "bench_kmeans_torch,0,ERROR" in capsys.readouterr().err
