"""The port's compression-ratio suite against the JAX package: ``evaluate``
over every family the port registers x {gbdi, bdi, fr}, the reporting
helpers, the CLI, throughput and the example and benchmark scripts (the FR config sweep is held
to the reference in ``test_torch_host_codecs.py``).

Streams are generated from a seed by both packages (byte-identical); each
side fits its own model on the CPU, which the port reproduces exactly, so
compression ratios, bits per word and verification must be equal.  Suites
are named explicitly and leave out the four model-backed ML families, whose
streams come from each package's own model initialisation
(``test_torch_models.py`` holds those on carried weights).  The JAX
reference is imported inside the ``ref`` fixture, so the card tests also
run where JAX is absent.
"""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.eval import codecs as t_codecs
from repro_torch.eval import run as t_run
from repro_torch.eval.registry import CodecRegistry
from repro_torch.eval.workloads import MODEL_FAMILIES
from repro_torch.eval.workloads import default_workloads as t_workloads

ROOT = Path(__file__).resolve().parent.parent
N_BYTES = 64 << 10
FAMILIES = [n for n in t_workloads("/no/such/dir").names() if n not in MODEL_FAMILIES]
SUITE = ",".join(FAMILIES)


def _load_script(rel: str):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The JAX reference eval harness (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    from repro.core import gbdi
    from repro.data import workloads as dumps
    from repro.eval import codecs, run
    from repro.eval.workloads import default_workloads

    return SimpleNamespace(codecs=codecs, run=run, workloads=default_workloads, gbdi=gbdi,
                           dumps=dumps)


@pytest.fixture(scope="module")
def suite_cells(ref):
    """(reference cells, port cells) of the whole suite at 64 KiB, seed 0."""
    jcells = ref.run.evaluate(ref.workloads(), ref.codecs.default_codecs(), suite=SUITE,
                              codecs="gbdi,bdi,fr", n_bytes=N_BYTES, repeats=1)
    tcells = t_run.evaluate(t_workloads(), t_codecs.default_codecs("cpu"), suite=SUITE,
                            codecs="gbdi,bdi,fr", n_bytes=N_BYTES, repeats=1)
    return jcells, tcells


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_port_registers_every_dump_family(ref):
    assert FAMILIES == list(ref.dumps.WORKLOADS) + ["ml_kvcache_bf16"]
    reg = t_workloads("/no/such/dir")
    for name, (kind, _fn) in ref.dumps.WORKLOADS.items():
        assert reg.get(name).kind == kind and reg.get(name).word_bits == 32
    assert len(reg.select("all")) == 17 and [w.name for w in reg.select("ml")] == [
        *MODEL_FAMILIES, "ml_kvcache_bf16"]
    assert reg.names() == ref.workloads("/no/such/dir").names()


@pytest.mark.parametrize("name", FAMILIES)
def test_evaluate_matches_reference(suite_cells, name):
    """CR, bits/word, exact fraction and verification equal for gbdi, bdi, fr."""
    jcells, tcells = suite_cells
    js = [c for c in jcells if c.workload == name]
    ts = [c for c in tcells if c.workload == name]
    assert [c.codec for c in ts] == [c.codec for c in js] == ["gbdi", "bdi", "fr"]
    for j, t in zip(js, ts):
        assert t.verified and j.verified, (t.codec, t.error, j.error)
        assert t.compression_ratio == j.compression_ratio, t.codec
        assert t.bits_per_word == j.bits_per_word, t.codec
        assert t.exact_frac == j.exact_frac and t.kind == j.kind, t.codec
        assert t.n_bytes == j.n_bytes and t.device == "cpu"


def test_table_geomeans_and_csv_match_reference(ref, suite_cells):
    jcells, tcells = suite_cells
    for codec in ("gbdi", "bdi", "fr"):
        for kind in ("C", "Java", "Column", "ML"):
            jv = ref.run.geomean(c.compression_ratio for c in jcells
                                 if c.codec == codec and c.kind == kind)
            tv = t_run.geomean(c.compression_ratio for c in tcells
                               if c.codec == codec and c.kind == kind)
            assert tv == jv
            assert f"{kind}={tv:.3f}" in t_run.format_table(tcells)
    assert t_run.geomean([]) == 0.0
    for jl, tl in zip(ref.run.csv_lines(jcells), t_run.csv_lines(tcells)):
        jname, _, jderived = jl.split(",", 2)
        tname, _, tderived = tl.split(",", 2)
        assert tname == jname and tderived.startswith(jderived + ";device=cpu")
    art = t_run.to_artifact(tcells, suite=SUITE, codecs="gbdi,bdi,fr", n_bytes=N_BYTES, seed=0)
    jart = ref.run.to_artifact(jcells, suite=SUITE, codecs="gbdi,bdi,fr", n_bytes=N_BYTES, seed=0)
    assert {k: v for k, v in art.items() if k != "rows"} == \
        {k: v for k, v in jart.items() if k != "rows"}
    assert len(art["rows"]) == 39


def test_cli_suite_codec_csv_json(tmp_path, capsys):
    out = tmp_path / "experiments" / "BENCH_eval.json"
    cells = t_run.main(["--device", "cpu", "--suite", "java,col_int_keys", "--codec", "gbdi,bdi",
                        "--bytes", str(N_BYTES), "--repeats", "1", "--csv", "--json", str(out)])
    assert [(c.workload, c.codec) for c in cells][:2] == [("java_trianglecount", "gbdi"),
                                                          ("java_trianglecount", "bdi")]
    assert len(cells) == 8 and all(c.verified for c in cells)
    text = capsys.readouterr().out
    assert "geomean CR [gbdi ] Column=" in text and text.count("eval/") == 8
    art = json.loads(out.read_text())
    assert art["bench"] == "eval" and len(art["rows"]) == 8
    assert (tmp_path / "BENCH_eval.json").read_text() == out.read_text()   # mirrored


def test_cli_sweep_on_cpu(capsys):
    assert t_run.main(["--device", "cpu", "--sweep", "--suite", "col_int_keys",
                       "--profile-sets", "adaptive2", "--bytes", str(N_BYTES)]) == []
    assert capsys.readouterr().out.count("+adaptive2") == 3


def test_cli_names_every_cell_that_failed(monkeypatch):
    """A cell that fails verification makes the run exit non-zero, named."""
    class Corrupt(t_codecs.BDICodec):
        def decode(self, blob):
            words = super().decode(blob).clone()
            words[0] ^= 1
            return words

    def codecs(device=None):
        reg = CodecRegistry()
        reg.register("bdi", lambda wb: Corrupt(word_bits=wb, device=device))
        return reg

    monkeypatch.setattr(t_codecs, "default_codecs", codecs)
    with pytest.raises(SystemExit, match="2 cells failed verification: 605.mcf_s/bdi .*"
                                         "col_int_keys/bdi"):
        t_run.main(["--device", "cpu", "--suite", "605.mcf_s,col_int_keys", "--codec", "bdi",
                    "--bytes", str(N_BYTES), "--repeats", "1"])


def test_throughput_refuses_the_host_and_records_the_row():
    rows = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        t_run.throughput(t_workloads(), t_codecs.default_codecs("cpu"), codecs="gbdi",
                         n_bytes=N_BYTES, rows=rows)
    assert rows[-1]["failed"] and rows[-1]["workload"] == t_run.THROUGHPUT_WORKLOADS[0]
    assert "FAILED" in t_run.format_throughput_table(rows)
    assert t_run.throughput_summary(rows) == []


def test_bench_compression_script_matches_reference(suite_cells):
    drv = _load_script("benchmarks/bench_compression_torch.py")
    cells = drv.run(n_bytes=N_BYTES, suite="c,java", device="cpu")
    jcells = [c for c in suite_cells[0] if c.codec in ("gbdi", "bdi") and c.kind in ("C", "Java")]
    assert [(c.workload, c.codec) for c in cells] == [(c.workload, c.codec) for c in jcells]
    assert [c.compression_ratio for c in cells] == [c.compression_ratio for c in jcells]
    s = drv.summarize(cells)
    gbdi = [c for c in jcells if c.codec == "gbdi"]
    assert s["cr_c_avg"] == t_run.geomean(c.compression_ratio for c in gbdi if c.kind == "C")
    assert s["cr_java_avg"] == t_run.geomean(c.compression_ratio for c in gbdi
                                             if c.kind == "Java")
    assert s["cr_bdi_avg"] == t_run.geomean(c.compression_ratio for c in jcells
                                            if c.codec == "bdi")
    assert s["paper_java"] == 1.55 and s["cr_java_avg"] > s["cr_bdi_avg"]


def test_bench_kmeans_script_matches_reference(ref, monkeypatch):
    from repro_torch.data import workloads as t_dumps

    drv = _load_script("benchmarks/bench_kmeans_torch.py")
    names = ("605.mcf_s", "col_decimal_prices")
    monkeypatch.setattr(t_dumps, "WORKLOADS", {n: t_dumps.WORKLOADS[n] for n in names})
    rows = drv.run(n_bytes=N_BYTES, device="cpu")
    for r in rows:
        data = ref.dumps.generate(r["workload"], n_bytes=N_BYTES, seed=0)
        for modified, key in ((True, "cr_modified"), (False, "cr_vanilla")):
            cfg = ref.gbdi.GBDIConfig(modified_kmeans=modified)
            want = ref.gbdi.compression_ratio(ref.gbdi.encode(data, ref.gbdi.fit(data, cfg)))
            assert r[key] == want, (r["workload"], key)
    assert [r["workload"] for r in rows] == list(names)


def test_quickstart_runs_on_cpu(capsys):
    _load_script("examples/quickstart_torch.py").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "GBDI compression ratio" in text and "geomean CR [gbdi ]" in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_suite_on_card(cuda_device):
    """Every family x {gbdi, bdi, fr} on the card with its own fit: verified,
    through kernels A and B, and near the CPU's ratio."""
    from repro_torch.kernels import gbdi_decode, gbdi_encode

    enc0, dec0 = gbdi_encode.launch_count, gbdi_decode.launch_count
    cells = t_run.evaluate(t_workloads(), t_codecs.default_codecs(), suite=SUITE,
                           codecs="gbdi,bdi,fr", n_bytes=1 << 20, repeats=1)
    cpu = t_run.evaluate(t_workloads(), t_codecs.default_codecs("cpu"), suite=SUITE,
                         codecs="gbdi,bdi,fr", n_bytes=1 << 20, repeats=1)
    assert len(cells) == 39 and all(c.verified for c in cells)
    assert all(c.device.startswith("NVIDIA") and c.power_limit for c in cells)
    assert gbdi_encode.launch_count > enc0 and gbdi_decode.launch_count > dec0
    for k, c in zip(cpu, cells):
        # the card's fit may differ in a float32 sum's last bit
        assert abs(c.bits_per_word - k.bits_per_word) <= 0.02 * k.bits_per_word


@pytest.mark.cuda
def test_throughput_on_card(cuda_device):
    rows = t_run.throughput(t_workloads(), t_codecs.default_codecs(), n_bytes=4 << 20, repeats=2)
    assert len(rows) == 3 * len(t_run.THROUGHPUT_WORKLOADS)
    assert all(r["enc_gib_s"] > 0 and r["dec_gib_s"] > 0 and r["device"].startswith("NVIDIA")
               for r in rows)
    art = t_run.throughput_artifact(rows, codecs=t_run.THROUGHPUT_CODECS, n_bytes=4 << 20,
                                    repeats=2, seed=0)
    assert art["complete"] and len(art["summary"]) == 12


@pytest.mark.cuda
def test_scripts_on_card(cuda_device, capsys):
    drv = _load_script("benchmarks/bench_compression_torch.py")
    cells, s = drv.main(["--bytes", str(1 << 20), "--suite", "java,c"])
    assert all(c.device.startswith("NVIDIA") for c in cells) and s["cr_java_avg"] > 1
    rows = _load_script("benchmarks/bench_kmeans_torch.py").run(n_bytes=1 << 20)
    assert len(rows) == 12 and all(r["device"].startswith("NVIDIA") for r in rows)
    _load_script("examples/quickstart_torch.py").main([])
    assert "device: cuda" in capsys.readouterr().out
    assert np.isfinite(rows[0]["cr_modified"])
