"""The port's compression-ratio suite against the JAX package: ``evaluate``
over every family the port registers x {gbdi, bdi, fr}, the reporting
helpers, the CLI, throughput and the example and benchmark scripts, among
them the serve CLI and the serving scripts (the FR config sweep is held to
the reference in ``test_torch_host_codecs.py``).

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
# the serve CLI and the serving scripts, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the serving scripts' tiny models: on a host
    shared with other test workers torch's thread pool contends more than
    it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_cli_on_cpu(capsys, one_thread):
    """More requests than slots: admission comes in waves, every request
    gets ``max_new`` tokens."""
    from repro_torch.launch import serve

    done = serve.main(["--reduced", "--device", "cpu", "--requests", "5", "--slots", "2",
                       "--max-new", "4", "--max-len", "64"])
    assert [r.rid for r in done] == list(range(5))
    assert all(r.done and len(r.out) == 4 for r in done)
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"req {r.rid}: {r.out}" for r in done]


@pytest.mark.parametrize("arch, error", [("paligemma-3b", SystemExit)])
def test_serve_cli_refuses_what_it_cannot_serve(arch, error):
    """The stub-frontend families are refused as in the reference (the
    families the port builds are served in ``tests/test_torch_zoo_training.py``)."""
    from repro_torch.launch import serve

    with pytest.raises(error):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "1"])


@pytest.mark.parametrize("entry, argv", [
    ("src/repro_torch/launch/serve.py", ["--reduced", "--requests", "1"]),
    ("benchmarks/serving_bench_torch.py", ["--quick", "--json", ""]),
    ("examples/serve_demo_torch.py", []),
    ("benchmarks/decode_microbench_torch.py", ["--quick", "--json", ""]),
    ("benchmarks/bench_kvcache_torch.py", []),
])
def test_serving_entry_points_default_to_the_card(entry, argv):
    """Without ``--device cpu`` every serving entry point asks for the card,
    and raises where there is none instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_script(entry).main(argv)


def test_serving_bench_on_cpu(tmp_path, capsys, one_thread):
    """``--quick`` writes the reference's artifact schema.  At its sizes the
    engine's slots bind in both modes (2 and 2 resident, in the reference
    too); at the default geometry the budget keeps 9 sequences resident
    under compressed accounting against 8 raw, the policy numbers of the
    reference's ``experiments/BENCH_serving.json`` at concurrency 12."""
    drv = _load_script("benchmarks/serving_bench_torch.py")
    out = tmp_path / "experiments" / "BENCH_serving_torch.json"
    art = drv.main(["--quick", "--device", "cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    assert (tmp_path / "BENCH_serving_torch.json").exists()            # mirrored
    want = json.loads((ROOT / "experiments" / "BENCH_serving.json").read_text())
    assert set(want) | {"device", "power_limit"} == set(art)
    assert art["devices"] == 1 and art["device"] == "cpu"
    assert [set(r) for r in art["rows"]] == [set(want["rows"][0])] * 4
    assert all(r["finished"] == r["concurrency"] and r["tokens"] == 4 * r["concurrency"]
               for r in art["rows"])
    assert art["summary"]["peak_resident"] == {"compressed": 2, "raw": 2}

    art = drv.main(["--concurrencies", "12", "--device", "cpu", "--json", ""])
    policy = ("bytes_per_seq", "capacity_seqs", "peak_resident", "resident_per_gib", "tokens",
              "queue_wait_ticks_mean", "queue_wait_ticks_max", "evictions", "finished")
    for got, ref in zip(art["rows"], [r for r in want["rows"] if r["concurrency"] == 12]):
        assert {k: got[k] for k in policy} == {k: ref[k] for k in policy}
    assert art["summary"]["peak_resident"] == {"compressed": 9, "raw": 8}
    assert art["spec"] == want["spec"] and art["byte_budget"] == want["byte_budget"]
    assert "serving/headline,0,budget=4194304;resident compressed=9 vs raw=8" \
        in capsys.readouterr().out


def test_serve_demo_on_cpu(capsys, one_thread):
    """The reference's sizes: six raw sequences fit the budget, seven under
    compressed accounting; the late priority-1 request evicts one sequence,
    which resumes and finishes."""
    counters = _load_script("examples/serve_demo_torch.py").main(["--device", "cpu"])
    assert counters["raw"]["peak_resident"] == 6
    assert counters["compressed"]["peak_resident"] == 7
    for c in counters.values():
        assert c["finished"] == 11 and c["tokens"] == 11 * 500
        assert c["evicted"] == c["resumed"] >= 1
    assert "x more of them fit one budget" in capsys.readouterr().out


def test_decode_microbench_on_cpu(tmp_path, one_thread):
    drv = _load_script("benchmarks/decode_microbench_torch.py")
    art = drv.main(["--quick", "--device", "cpu", "--json", ""])
    assert not list(tmp_path.iterdir())
    assert art["contexts"] == [64, 256] and art["repeats"] == 3 and art["devices"] == 1
    assert art["spec"] == {"n_kv": 4, "head_dim": 32, "page_words": 512, "page_tokens": 4}
    assert [(r["context"], r["mode"], r["n_pages"]) for r in art["rows"]] == [
        (64, "resident", 16), (64, "full", 16), (256, "resident", 64), (256, "full", 64)]
    assert all(r["us_best"] <= r["us_per_token"] for r in art["rows"])
    assert set(art["summary"]) == {"resident", "full"}


def test_bench_kvcache_matches_reference(one_thread):
    """The fidelity run's output equals, bit for bit, the reference's paged
    attention over its own pages of the same tokens (``fr_encode``, the
    Pallas kernel in interpret mode, the tail merge of
    ``src/repro/serving/kv_cache.py``), so its error is the reference's."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import gbdi_fr as jfr
    from repro.kernels import gbdi_paged_attn as jpa
    from repro.serving import kv_cache as jkvc

    got = _load_script("benchmarks/bench_kvcache_torch.py").run("cpu")
    spec = jkvc.KVSpec(n_kv=8, head_dim=128, max_len=32768)
    assert (got["raw"], got["compressed"]) == (spec.raw_bytes(4), spec.compressed_bytes(4))

    small = jkvc.KVSpec(n_kv=4, head_dim=32, max_len=128, fr=jfr.FRConfig(
        word_bits=16, page_words=128, delta_bits=8, num_bases=14, outlier_cap=16))
    rng = np.random.default_rng(0)
    n, pos = 96, 95
    ch = rng.normal(0, 1, (1, 1, 4, 32)) * 2
    ks = (ch + rng.normal(0, 0.1, (2, n, 4, 32))).astype(np.float32)
    vs = (ch + rng.normal(0, 0.1, (2, n, 4, 32))).astype(np.float32)

    def words(x):
        return jax.lax.bitcast_convert_type(jnp.asarray(x).astype(jnp.bfloat16),
                                            jnp.uint16).astype(jnp.int32)

    table = jfr.fit_fr_bases(words(np.concatenate([ks, vs], 1)).reshape(-1), small.fr)
    q = rng.normal(0, 1, (2, 1, 8, 32)).astype(np.float32)

    def pages(x):          # one token a page: tokens 0..95 fill slots 0..95
        blob = jfr.fr_encode(words(x).reshape(-1, 128), table, small.fr)
        out = {}
        for k, z in jkvc.init_compressed(small, 2, table)["k_pages"].items():
            z = np.array(z)
            z[:, :n] = np.asarray(blob[k]).reshape((2, n) + z.shape[2:])
            out[k] = jnp.asarray(z)
        return out

    qg = jnp.asarray(q).reshape(2, 4, 2, 32)
    acc, m, l = jpa.paged_attention_decode(qg, pages(ks), pages(vs), table, jnp.int32(pos),
                                           small.fr, n_kv=4, hd=32, groups=2, interpret=True)
    Kt, Vt = (jnp.asarray(x[:, pos:pos + 1]).astype(jnp.bfloat16).astype(jnp.float32)
              for x in (ks, vs))
    lg = jnp.einsum("bkgh,btkh->bkgt", qg, Kt) / jnp.sqrt(jnp.float32(32))
    m2 = lg.max(-1)
    p2 = jnp.exp(lg - m2[..., None])
    accm, _, lm = jpa.merge_softmax(acc, m, l, jnp.einsum("bkgt,btkh->bkgh", p2, Vt), m2,
                                    p2.sum(-1))
    out_c = (accm / lm[..., None]).reshape(2, 1, 256).astype(jnp.bfloat16)
    # the reference's error arithmetic (benchmarks/bench_kvcache.py)
    Kr, Vr = (jnp.asarray(x).astype(jnp.bfloat16) for x in (ks, vs))
    lg = jnp.einsum("bskgh,btkh->bkgst", jnp.asarray(q).reshape(2, 1, 4, 2, 32),
                    Kr).astype(jnp.float32) / np.sqrt(32)
    ref = jnp.einsum("bkgst,btkh->bskgh", jax.nn.softmax(lg, -1).astype(Vr.dtype),
                     Vr).reshape(2, 1, 256)
    err = float(jnp.abs(out_c - ref).max())
    np.testing.assert_array_equal(got["out"].view(torch.int16).numpy(),
                                  np.asarray(out_c).view(np.int16))
    np.testing.assert_array_equal(got["ref"].view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
    assert 0 < got["max_abs"] <= err
    assert got["max_rel"] == err / float(jnp.abs(ref).max())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_suite_on_card(cuda_device):
    """Every family x {gbdi, bdi, fr} on the card with its own fit: verified,
    through kernels A and B, and near the CPU's ratio."""
    from repro_torch import obs

    def launches():
        got = obs.snapshot(spans=False)["counters"]
        return got["launches.encode"], got["launches.decode"]

    enc0, dec0 = launches()
    cells = t_run.evaluate(t_workloads(), t_codecs.default_codecs(), suite=SUITE,
                           codecs="gbdi,bdi,fr", n_bytes=1 << 20, repeats=1)
    cpu = t_run.evaluate(t_workloads(), t_codecs.default_codecs("cpu"), suite=SUITE,
                         codecs="gbdi,bdi,fr", n_bytes=1 << 20, repeats=1)
    assert len(cells) == 39 and all(c.verified for c in cells)
    assert all(c.device.startswith("NVIDIA") and c.power_limit for c in cells)
    enc1, dec1 = launches()
    assert enc1 > enc0 and dec1 > dec0
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
