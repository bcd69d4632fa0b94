"""The port's slice end to end: FRCodec + evaluate_cell against the JAX eval
harness, the entry points' device rule, and the package boundary.  The JAX
reference is imported inside the tests that need it, so the card test also
runs where JAX is absent."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.gbdi_fr import FRConfig as TConfig
from repro_torch.eval import codecs as t_codecs
from repro_torch.eval import run as t_run
from repro_torch.eval.workloads import default_workloads as t_workloads

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    """The JAX reference eval harness (the test skips where JAX is not installed)."""
    pytest.importorskip("jax")
    from repro.core.gbdi_fr import FRConfig
    from repro.eval import codecs, run
    from repro.eval.workloads import default_workloads

    return SimpleNamespace(FRConfig=FRConfig, codecs=codecs, run=run,
                           workloads=default_workloads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["ml_kvcache_bf16", "605.mcf_s"])
def test_evaluate_cell_matches_reference(ref, name):
    """Same compression ratio, bits/word and drops as the JAX oracle codec."""
    n_bytes = 256 << 10
    jwl = ref.workloads().get(name)
    data = jwl.generate(n_bytes, 0)
    jcodec = ref.codecs.FRCodec(word_bits=jwl.word_bits, backend="ref")
    jcell = ref.run.evaluate_cell(jwl, jcodec, data, repeats=1)
    twl = t_workloads().get(name)
    tcodec = t_codecs.FRCodec(word_bits=twl.word_bits, device="cpu")
    tcell = t_run.evaluate_cell(twl, tcodec, data, repeats=1)
    assert tcell.verified and jcell.verified
    assert tcell.compression_ratio == jcell.compression_ratio
    assert tcell.bits_per_word == jcell.bits_per_word
    assert tcell.exact_frac == jcell.exact_frac
    assert tcell.device == "cpu"
    jblob = jcodec.encode(data, jcodec.fit(data))
    words = tcodec.stream(data)
    tblob = tcodec.encode(words, tcodec.fit(words))
    assert tcodec.dropped_words(tblob) == jcodec.dropped_words(jblob)
    assert tcodec.spilled_words(tblob) == jcodec.spilled_words(jblob)


def test_adaptive_size_and_profile_histogram_match(ref):
    kw = dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
              cap_profiles=((64, 192), (192, 64), (8, 8)), outlier_cap=16)
    data = t_workloads().get("ml_kvcache_bf16").generate(24 << 10, 1)
    jcodec = ref.codecs.FRCodec(word_bits=16, backend="ref", cfg=ref.FRConfig(**kw))
    tcodec = t_codecs.FRCodec(word_bits=16, device="cpu", cfg=TConfig(**kw))
    jblob = jcodec.encode(data, jcodec.fit(data))
    words = tcodec.stream(data)
    tblob = tcodec.encode(words, tcodec.fit(words))
    assert tcodec.size_bits(tblob) == jcodec.size_bits(jblob)
    assert tcodec.profile_histogram(tblob) == jcodec.profile_histogram(jblob)
    dec = tcodec.decode(tblob)
    assert dec.shape == words.shape
    assert int((dec != words).sum()) <= tcodec.dropped_words(tblob)
    np.testing.assert_array_equal(
        dec.numpy(), jcodec.decode(jblob).astype(np.int64).astype(np.int32))


def test_default_configs_match_reference(ref):
    for wb in (16, 32):
        jcfg = ref.codecs.FRCodec(word_bits=wb)._config()
        assert dataclasses.asdict(t_codecs.default_config(wb)) == dataclasses.asdict(jcfg)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_codecs.FRCodec(word_bits=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_run.main(["--suite", "605.mcf_s", "--bytes", "65536"])
    assert t_codecs.FRCodec(word_bits=16, device="cpu").torch_device.type == "cpu"


def test_throughput_refuses_the_host():
    wl = t_workloads().get("605.mcf_s")
    with pytest.raises(RuntimeError, match="CUDA card"):
        t_run.measure_throughput(wl, t_codecs.FRCodec(word_bits=32, device="cpu"),
                                 wl.generate(1 << 14, 0))


def test_peak_bandwidth_by_card_name():
    assert t_run.peak_bytes_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert t_run.peak_bytes_s("NVIDIA H100 PCIe") == 2.0e12
    assert t_run.peak_bytes_s("NVIDIA H200") == 4.8e12
    with pytest.raises(ValueError):
        t_run.peak_bytes_s("cpu")


def test_cli_on_cpu(tmp_path):
    out = tmp_path / "eval.json"
    cells = t_run.main(["--device", "cpu", "--suite", "605.mcf_s,col_int_keys",
                        "--bytes", str(64 << 10), "--repeats", "1", "--json", str(out)])
    assert [(c.workload, c.codec) for c in cells] == [
        (w, c) for w in ("605.mcf_s", "col_int_keys") for c in ("gbdi", "bdi", "fr")]
    assert all(c.verified and c.compression_ratio > 1 for c in cells)
    assert out.read_text().count('"workload"') == 6


ENTRY_SCRIPTS = ["examples/quickstart_torch.py", "benchmarks/bench_compression_torch.py",
                  "benchmarks/bench_kmeans_torch.py", "benchmarks/bench_throughput_torch.py",
                  "benchmarks/bench_gradcomp_torch.py", "examples/train_lm_torch.py",
                  "examples/gradient_compression_demo_torch.py"]


def test_port_imports_no_jax_and_no_reference():
    """The port's modules, its example and benchmark scripts and chip_smoke.py import neither
    jax, nor repro, nor ml_dtypes (the card's machine has none of them), in their source or when
    every module of the package is loaded."""
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py",
             *(ROOT / d for d in ENTRY_SCRIPTS)]
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.M)
    offenders = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
    code = ("import sys, runpy, importlib, pkgutil, repro_torch; "
            "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert {'repro_torch.eval.ingest.capture', 'repro_torch.models.api', "
            "'repro_torch.optim.adamw', 'repro_torch.configs.deepseek_7b'} <= set(mods), mods; "
            f"[runpy.run_path(p) for p in {[str(ROOT / d) for d in ENTRY_SCRIPTS]!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


@pytest.mark.cuda
def test_evaluate_cell_on_card(cuda_device):
    from repro_torch import obs

    def launches():
        got = obs.snapshot(spans=False)["counters"]
        return got["launches.encode"], got["launches.decode"]

    wl = t_workloads().get("ml_kvcache_bf16")
    data = wl.generate(1 << 20, 0)
    enc0, dec0 = launches()
    cell = t_run.evaluate_cell(wl, t_codecs.FRCodec(word_bits=16), data, repeats=2)
    cpu = t_run.evaluate_cell(wl, t_codecs.FRCodec(word_bits=16, device="cpu"), data, repeats=1)
    assert cell.verified and cell.device.startswith("NVIDIA")
    enc1, dec1 = launches()
    assert enc1 > enc0 and dec1 > dec0
    # the card's fit may differ in a float32 sum's last bit; the ratio is a
    # property of the table, so only hold it close
    assert abs(cell.bits_per_word - cpu.bits_per_word) <= 0.005 * cpu.bits_per_word
