"""The port's real-dump ingestion against the JAX package's: ELF cores,
tensor files and pickled trees read into equal images, containers that load
across the two packages both ways, equal page samples, ``capture_pytree``
names and bytes, the opt-in process capture, the ingest CLI, the
``dump:<name>`` families in the registry and their suite cells.

Inputs come from the miniature corpus of ``tests/ingest_corpus.py``, built
in the test (its bf16 ``.npy`` needs ``ml_dtypes``, which the JAX package
brings).  The reference is imported inside the ``ref`` fixture, so the card
test also runs where JAX is absent.
"""
import os
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ingest_corpus import build_bin, build_elf_core, build_npz, build_pytree_pickle  # noqa: E402

from repro_torch.eval import codecs as t_codecs  # noqa: E402
from repro_torch.eval import ingest as t_ingest  # noqa: E402
from repro_torch.eval import run as t_run  # noqa: E402
from repro_torch.eval.ingest.__main__ import main as t_main  # noqa: E402
from repro_torch.eval.registry import WorkloadRegistry  # noqa: E402
from repro_torch.eval.workloads import default_workloads as t_workloads  # noqa: E402

N_BYTES = 64 << 10
CORPUS = ("elf", "elf_be", "npy", "npz", "bin", "pytree")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's ingestion, registry and runner (skips without JAX)."""
    pytest.importorskip("jax")
    from repro.eval import codecs, ingest, run
    from repro.eval.ingest.__main__ import main
    from repro.eval.workloads import default_workloads

    return SimpleNamespace(ingest=ingest, main=main, codecs=codecs, run=run,
                           workloads=default_workloads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corpus(ref, tmp_path_factory):
    from ingest_corpus import build_corpus

    return build_corpus(tmp_path_factory.mktemp("corpus"), seed=0)


def _read(pkg, path):
    return (pkg.read_elf_core(path) if pkg.is_elf(path) else pkg.read_tensor_file(path))


def _image_fields(img) -> dict:
    return {"name": img.name, "word_bits": img.word_bits, "endian": img.endian,
            "n_bytes": img.n_bytes, "source": img.source, "meta": img.meta,
            "segments": [(s.name, s.vaddr, s.note, s.data.tobytes()) for s in img.segments]}


@pytest.fixture(scope="module")
def dump_dirs(ref, corpus, tmp_path_factory):
    """The whole corpus ingested by each package's CLI into its own dir."""
    jdir, tdir = tmp_path_factory.mktemp("jdumps"), tmp_path_factory.mktemp("tdumps")
    paths = [str(corpus[k]) for k in CORPUS]
    jfams = ref.main([*paths, "--dump-dir", str(jdir)])
    tfams = t_main([*paths, "--dump-dir", str(tdir)])
    assert tfams == jfams and len(tfams) == len(CORPUS)
    return jdir, tdir


# ---------------------------------------------------------------------------
# readers and the container
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", CORPUS)
def test_corpus_images_match_reference(ref, corpus, kind):
    """Every corpus file gives equal segments (bytes, names, vaddr, note),
    word_bits, endian, n_bytes and meta in both packages."""
    j, t = _read(ref.ingest, corpus[kind]), _read(t_ingest, corpus[kind])
    assert _image_fields(t) == _image_fields(j)
    for wb in (16, 32):
        np.testing.assert_array_equal(t.word_stream(wb), j.word_stream(wb))


def test_bf16_npy_frames_as_v2_at_16_bits(ref, corpus):
    """Without ml_dtypes a bf16 .npy loads as V2; both packages frame it at 16."""
    img = t_ingest.read_npy(corpus["npy"])
    assert img.segments[0].name == "arr@|V2" and img.word_bits == 16
    assert t_codecs.word_bits_for_dtype("V2") == ref.codecs.word_bits_for_dtype("V2") == 16
    assert t_codecs.word_bits_for_dtype(torch.bfloat16) == 16


def test_elf_limits_and_rejections_match_reference(ref, corpus, tmp_path):
    for pkg in (ref.ingest, t_ingest):
        assert pkg.read_elf_core(corpus["elf"], max_bytes=4096).n_bytes == 4096
    assert (_image_fields(t_ingest.read_elf_core(corpus["elf_be"], max_bytes=5000))
            == _image_fields(ref.ingest.read_elf_core(corpus["elf_be"], max_bytes=5000)))
    bad = tmp_path / "not_elf.bin"
    bad.write_bytes(b"definitely not an elf file")
    trunc = tmp_path / "trunc.elf"
    trunc.write_bytes(corpus["elf"].read_bytes()[: 64 + 56 * 3 + 100])
    for path, match in ((bad, "magic"), (trunc, "EOF")):
        for pkg in (ref.ingest, t_ingest):
            with pytest.raises(ValueError, match=match):
                pkg.read_elf_core(path)
    assert not t_ingest.is_elf(bad) and t_ingest.is_elf(corpus["elf"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_containers_load_across_packages(ref, corpus, tmp_path, writer):
    """A container either package writes, the other loads field for field."""
    wpkg, rpkg = (t_ingest, ref.ingest) if writer == "port" else (ref.ingest, t_ingest)
    for kind in CORPUS:
        img = _read(wpkg, corpus[kind])
        path = img.save(tmp_path / f"{img.name}.npz")
        back = rpkg.DumpImage.load(path)
        assert _image_fields(back) == _image_fields(img), kind
        assert rpkg.load_meta(path) == wpkg.load_meta(path)


@pytest.mark.parametrize("n_bytes,seed", [(4096, 0), (8192, 3), (10000, 7), (1 << 17, 1)])
def test_sample_stream_matches_reference(ref, corpus, n_bytes, seed):
    """crc32-seeded page subsets in address order, tiling and reframing: the
    same words for every image."""
    for kind in CORPUS:
        j, t = _read(ref.ingest, corpus[kind]), _read(t_ingest, corpus[kind])
        for wb in (None, 16, 32):
            a = ref.ingest.sample_stream(j, n_bytes, seed, word_bits=wb)
            b = t_ingest.sample_stream(t, n_bytes, seed, word_bits=wb)
            assert b.dtype == a.dtype, (kind, wb)
            np.testing.assert_array_equal(b, a, err_msg=f"{kind} wb={wb}")


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

def test_capture_pytree_matches_reference(ref):
    """Segment names (``key/key/idx@dtype``), order and bytes of a nested
    bf16/int32/float32 tree; a bf16 tensor is stored as its bit pattern."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    scale = rng.standard_normal(16).astype(np.float32)
    jtree = {"kv": {"v": jnp.asarray(w).astype(jnp.bfloat16),
                    "k": jnp.ones((8, 16), jnp.bfloat16)},
             "pos": jnp.asarray(pos),
             "layers": [{"scale": jnp.asarray(scale)}, (jnp.asarray(pos),)],
             "empty": jnp.zeros((0,), jnp.float32)}
    ttree = {"kv": {"v": torch.from_numpy(w).to(torch.bfloat16),
                    "k": torch.ones((8, 16), dtype=torch.bfloat16)},
             "pos": torch.from_numpy(pos), "layers": [{"scale": torch.from_numpy(scale)},
                                                      (torch.from_numpy(pos),)],
             "empty": torch.zeros(0)}
    j = ref.ingest.capture_pytree(jtree, "live")
    t = t_ingest.capture_pytree(ttree, "live")
    assert _image_fields(t) == _image_fields(j)
    assert [s.name for s in t.segments] == ["kv/k@bfloat16", "kv/v@bfloat16",
                                            "layers/0/scale@float32", "layers/1/0@int32",
                                            "pos@int32"]
    # numpy leaves (as a checkpoint would hold them) capture the same bytes
    assert _image_fields(t_ingest.capture_pytree(
        {"a": np.asarray(jtree["kv"]["v"]), "b": pos}, "np")) == _image_fields(
        ref.ingest.capture_pytree({"a": jtree["kv"]["v"], "b": jnp.asarray(pos)}, "np"))
    with pytest.raises(ValueError, match="no non-empty"):
        t_ingest.capture_pytree({"x": torch.zeros(0)}, "nothing")


def test_capture_process_is_opt_in(monkeypatch):
    monkeypatch.delenv("REPRO_ALLOW_PROC_CAPTURE", raising=False)
    with pytest.raises(PermissionError, match="opt-in"):
        t_ingest.capture_process(1)


def test_capture_own_process(tmp_path):
    if not Path("/proc/self/maps").exists():
        pytest.skip("no /proc (not Linux)")
    try:
        img = t_ingest.capture_process(os.getpid(), allow=True, max_bytes=1 << 20, name="self")
    except PermissionError:
        pytest.skip("ptrace over own pid denied in this sandbox")
    assert 0 < img.n_bytes <= 1 << 20 and img.meta["format"] == "proc"
    assert all(s.name.startswith("map") and "perms=" in s.note for s in img.segments)
    img.save(tmp_path / "self.npz")
    words = t_ingest.sample_stream(t_ingest.DumpImage.load(tmp_path / "self.npz"), 4096, 0)
    assert words.dtype == np.uint32 and words.size == 1024


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_ingest_list_and_force_match_reference(ref, corpus, tmp_path, capsys):
    outs = {}
    for label, main in (("ref", ref.main), ("port", t_main)):
        d = tmp_path / label
        fams = main([str(corpus["bin"]), str(corpus["npz"]), "--dump-dir", str(d)])
        assert fams == ["dump:counters", "dump:columns"]
        with pytest.raises(SystemExit, match="exists"):
            main([str(corpus["bin"]), "--dump-dir", str(d)])
        assert main([str(corpus["bin"]), "--dump-dir", str(d), "--force", "--name", "counters"]) \
            == ["dump:counters"]
        capsys.readouterr()
        assert main(["--list", "--dump-dir", str(d)]) == []
        outs[label] = capsys.readouterr().out.replace(str(d), "<dir>")
    assert outs["port"] == outs["ref"] and "dump:columns" in outs["port"]
    for stem in ("counters", "columns"):
        j = ref.ingest.DumpImage.load(tmp_path / "ref" / f"{stem}.npz")
        t = t_ingest.DumpImage.load(tmp_path / "port" / f"{stem}.npz")
        assert _image_fields(t) == _image_fields(j)
    reg = t_workloads(str(tmp_path / "port"))
    assert {"dump:counters", "dump:columns"} <= set(reg.names())


@pytest.mark.parametrize("bad", ["sub/run1", "../esc", "a,b", ".hidden"])
def test_dump_names_must_be_safe_slugs(ref, corpus, tmp_path, bad):
    """Names become filename stems and --suite tokens; both packages refuse
    the same ones, from the reader and from the CLI."""
    for pkg, main in ((ref.ingest, ref.main), (t_ingest, t_main)):
        with pytest.raises((ValueError, SystemExit), match="name"):
            pkg.read_tensor_file(corpus["bin"], name=bad)
        with pytest.raises((ValueError, SystemExit), match="name"):
            main([str(corpus["bin"]), "--name", bad, "--dump-dir", str(tmp_path)])
    assert not list(tmp_path.glob("*.npz"))


def test_cli_rejects_duplicate_stems_in_one_batch(ref, corpus, tmp_path):
    other = tmp_path / "other"
    other.mkdir()
    shutil.copy(corpus["bin"], other / corpus["bin"].name)
    for label, main in (("ref", ref.main), ("port", t_main)):
        with pytest.raises(SystemExit, match="duplicate"):
            main([str(corpus["bin"]), str(other / corpus["bin"].name),
                  "--dump-dir", str(tmp_path / label)])
        assert not (tmp_path / label / "counters.npz").exists()   # nothing written


# ---------------------------------------------------------------------------
# the dump:<name> families
# ---------------------------------------------------------------------------

def test_default_workloads_match_reference(ref, dump_dirs):
    """Names, kinds and word bits of every family, dumps included, in order."""
    jdir, tdir = dump_dirs
    jreg, treg = ref.workloads(str(jdir)), t_workloads(str(tdir))
    assert [(w.name, w.kind, w.word_bits) for w in treg] == \
        [(w.name, w.kind, w.word_bits) for w in jreg]
    assert [w.description for w in treg.select("dump")] == [
        w.description.replace(str(jdir), str(tdir)) for w in jreg.select("dump")]
    assert "Dump" not in t_workloads("/no/such/dir").kinds()


def test_dump_families_generate_reference_words(ref, dump_dirs):
    jdir, tdir = dump_dirs
    jreg, treg = ref.workloads(str(jdir)), t_workloads(str(tdir))
    for w in treg.select("dump"):
        for n_bytes, seed in ((8192, 3), (N_BYTES, 0)):
            np.testing.assert_array_equal(w.generate(n_bytes, seed),
                                          jreg.get(w.name).generate(n_bytes, seed))


def test_evaluate_dump_suite_matches_reference(ref, dump_dirs):
    """``evaluate(suite="dump")`` at 64 KiB: equal cells for gbdi, bdi and the
    reference's ``fr`` (its jnp oracle, which the port's ``fr`` is on the CPU)."""
    jdir, tdir = dump_dirs
    jcells = ref.run.evaluate(ref.workloads(str(jdir)), ref.codecs.default_codecs(),
                              suite="dump", codecs="gbdi,bdi,fr", n_bytes=N_BYTES, repeats=1)
    tcells = t_run.evaluate(t_workloads(str(tdir)), t_codecs.default_codecs("cpu"),
                            suite="dump", codecs="gbdi,bdi,fr", n_bytes=N_BYTES, repeats=1)
    assert len(tcells) == 3 * len(CORPUS)
    for j, t in zip(jcells, tcells):
        assert (t.workload, t.codec, t.kind) == (j.workload, j.codec, j.kind) \
            and t.kind == "Dump"
        assert t.verified and j.verified, (t.workload, t.codec, t.error, j.error)
        assert (t.compression_ratio, t.bits_per_word, t.exact_frac, t.word_bits) == \
            (j.compression_ratio, j.bits_per_word, j.exact_frac, j.word_bits), (t.workload, t.codec)


def test_scan_dump_dir_skips_garbage(dump_dirs, tmp_path):
    d = tmp_path / "mixed"
    d.mkdir()
    shutil.copy(dump_dirs[1] / "mini_core.npz", d / "mini_core.npz")
    np.savez(d / "not_a_dump.npz", x=np.arange(4))       # foreign artifact
    with pytest.warns(UserWarning, match="not_a_dump"):
        names = t_ingest.scan_dump_dir(WorkloadRegistry(), d)
    assert names == ["dump:mini_core"]
    with pytest.raises(ValueError, match="__meta__"):
        t_ingest.scan_dump_dir(WorkloadRegistry(), d, strict=True)


@pytest.mark.parametrize("same_mtime", [False, True])
def test_reingest_serves_fresh_bytes(tmp_path, same_mtime):
    """The image cache is keyed on (path, size, mtime_ns, tail crc): a
    rewritten container serves its new bytes, also when the rewrite keeps the
    old mtime (coarse-timestamp filesystems)."""
    d, src = tmp_path / "dumps", tmp_path / "w.npy"
    np.save(src, np.full(4096, 7, np.uint32))
    t_ingest.read_tensor_file(src, name="w").save(d / "w.npz")
    st = os.stat(d / "w.npz")
    a = t_workloads(str(d)).get("dump:w").generate(4096, 0)
    np.save(src, np.full(4096, 9, np.uint32))
    t_ingest.read_tensor_file(src, name="w").save(d / "w.npz")
    if same_mtime:
        os.utime(d / "w.npz", ns=(st.st_mtime_ns, st.st_mtime_ns))
    b = t_workloads(str(d)).get("dump:w").generate(4096, 0)
    assert a[0] == 7 and b[0] == 9


def test_env_dump_dir_and_cli_suite(tmp_path, monkeypatch, capsys):
    """``$REPRO_DUMP_DIR`` is the default dump dir; ``--suite dump`` runs every
    dump family and ``--dump-dir`` points elsewhere."""
    d = tmp_path / "dumps"
    for build, name in ((build_elf_core, "core.elf"), (build_bin, "c.bin"),
                        (build_npz, "cols.npz"), (build_pytree_pickle, "p.pkl")):
        build(tmp_path / name, seed=1)
    t_main([str(tmp_path / n) for n in ("core.elf", "c.bin", "cols.npz", "p.pkl")]
           + ["--dump-dir", str(d)])
    monkeypatch.setenv("REPRO_DUMP_DIR", str(d))
    assert t_ingest.default_dump_dir() == str(d)
    assert len(t_workloads().select("dump")) == 4
    monkeypatch.delenv("REPRO_DUMP_DIR")
    cells = t_run.main(["--device", "cpu", "--suite", "dump", "--dump-dir", str(d),
                        "--codec", "gbdi,bdi", "--bytes", "16384", "--repeats", "1"])
    assert len(cells) == 8 and all(c.verified and c.kind == "Dump" for c in cells)
    assert "Dump=" in capsys.readouterr().out


def test_bench_compression_script_reports_dumps(dump_dirs):
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "benchmarks" / "bench_compression_torch.py"
    spec = importlib.util.spec_from_file_location("bench_compression_torch", path)
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    cells = drv.run(n_bytes=16384, suite="dump", device="cpu", dump_dir=str(dump_dirs[1]))
    s = drv.summarize(cells)
    assert s["cr_dump_avg"] == t_run.geomean(c.compression_ratio for c in cells
                                             if c.codec == "gbdi")
    assert s["cr_dump_avg"] > 1 and s["cr_c_avg"] == 0.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_dump_suite_on_card(cuda_device, tmp_path):
    """The dump families through gbdi, bdi and fr on the card (kernels A and
    B), each cell verified and equal to the CPU's ratio on a carried model."""
    from repro_torch import obs

    def launches():
        got = obs.snapshot(spans=False)["counters"]
        return got["launches.encode"], got["launches.decode"]

    d = tmp_path / "dumps"
    for build, name in ((build_elf_core, "core.elf"), (build_bin, "c.bin"),
                        (build_npz, "cols.npz"), (build_pytree_pickle, "p.pkl")):
        build(tmp_path / name, seed=0)
    t_main([str(tmp_path / n) for n in ("core.elf", "c.bin", "cols.npz", "p.pkl")]
           + ["--dump-dir", str(d)])
    enc0, dec0 = launches()
    reg = t_workloads(str(d))
    cells = t_run.evaluate(reg, t_codecs.default_codecs(), suite="dump", codecs="gbdi,bdi,fr",
                           n_bytes=1 << 20, repeats=1)
    assert len(cells) == 12 and all(c.verified and c.device.startswith("NVIDIA") for c in cells)
    enc1, dec1 = launches()
    assert enc1 > enc0 and dec1 > dec0
    cpu, card = t_codecs.default_codecs("cpu"), t_codecs.default_codecs()
    for wl in reg.select("dump"):
        data = wl.generate(1 << 20, 0)
        for cname in ("gbdi", "bdi", "fr"):
            ref_c, dut = cpu.make(cname, wl.word_bits), card.make(cname, wl.word_bits)
            words = ref_c.stream(data)
            model = ref_c.fit(words)
            kb = dut.encode(dut.stream(data), model.to(cuda_device) if model is not None
                            else None)
            assert dut.size_bits(kb) == ref_c.size_bits(ref_c.encode(words, model)), \
                (wl.name, cname)
