"""The port's multi-device front-end (``repro_torch.kernels.pipeline``), the
prepared-table memo of the codec wrappers and the FR codec's pipeline knobs,
against the JAX package.

The reference's own pipeline raises on jax 0.9.0 (``jax.core.trace_state_clean``
is gone), so every path is held bit for bit to the reference's oracle
composition ``repro.core.gbdi_fr.fr_encode`` / ``fr_decode`` on
``tests/test_pipeline.py``'s config (16-bit words, 256-word pages, 6 bases,
two cap profiles, 37 pages) and a table the reference fitted, carried across
as numpy.  On the CPU every shard runs the plain versions; the split paths
wrap over the one host (``devices=4`` is the CPU four times), which
exercises the padding, the reassembly and the strip.  Tests marked ``cuda``
run the same paths on the card's kernels.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core.gbdi_fr import FRConfig
from repro_torch.eval import codecs as t_codecs
from repro_torch.eval import run as t_run
from repro_torch.eval import workloads as t_wl
from repro_torch.kernels import gbdi_encode as t_enc
from repro_torch.kernels import ops, pipeline

FIELDS = dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
              cap_profiles=((64, 192), (192, 64)), outlier_cap=16)
CFG = FRConfig(**FIELDS)
N_PAGES = 37


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the models and pages here are small, and on a
    host shared with other test workers torch's thread pool spends more time
    contending than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference oracle on the test config: pages, fitted table, blob, words."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import gbdi_fr

    jcfg = gbdi_fr.FRConfig(**FIELDS)
    rng = np.random.default_rng(0)
    x = rng.integers(-2000, 2000, (N_PAGES, CFG.page_words)).astype(np.int32)
    jt = gbdi_fr.fit_fr_bases(jnp.asarray(x), jcfg)
    jblob = gbdi_fr.fr_encode(jnp.asarray(x), jt, jcfg)
    words = np.asarray(gbdi_fr.fr_decode(jblob, jt, jcfg))
    table = interop.table_from_numpy(np.asarray(jt.bases), np.asarray(jt.widths), device="cpu")
    return SimpleNamespace(x=torch.from_numpy(x), table=table, jnp=jnp, gbdi_fr=gbdi_fr,
                           jcfg=jcfg, jt=jt, blob={k: np.array(v) for k, v in jblob.items()},
                           words=words)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_blob(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k].cpu()), want[k], err_msg=f"{label}:{k}")


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def test_auto_path_matches_reference(ref):
    assert pipeline.device_count("cpu") == 1 and pipeline.auto_shards("cpu") == 1
    assert pipeline.local_devices("cpu") == [torch.device("cpu")]
    _assert_blob(pipeline.encode_pages(ref.x, ref.table, CFG), ref.blob, "auto")


@pytest.mark.parametrize("devices", [2, 3, 4, ["cpu", "cpu", "cpu"]])
def test_explicit_shards_match_reference(ref, devices):
    """37 rows over 2-4 shards: padding, reassembly and the strip."""
    _assert_blob(pipeline.encode_pages(ref.x, ref.table, CFG, devices=devices), ref.blob,
                 f"devices={devices}")


@pytest.mark.parametrize("devices", [None, 3])
def test_encode_pages_sharded_matches_reference(ref, devices):
    _assert_blob(pipeline.encode_pages_sharded(ref.x, ref.table, CFG, devices=devices),
                 ref.blob, f"sharded {devices}")


def test_encode_stream_matches_reference(ref):
    parts = np.array_split(ref.x.numpy(), 5)
    blobs = list(pipeline.encode_stream(parts, ref.table, CFG, device="cpu"))
    assert len(blobs) == 5 and all(b["ptrs"].device.type == "cpu" for b in blobs)
    _assert_blob({k: torch.cat([b[k] for b in blobs]) for k in blobs[0]}, ref.blob, "stream")
    assert list(pipeline.encode_stream([], ref.table, CFG, device="cpu")) == []
    # CPU tensors as batches, and a batch with leading axes
    torch_parts = [ref.x[:12].reshape(3, 4, -1), ref.x[12:]]
    blobs = list(pipeline.encode_stream(torch_parts, ref.table, CFG, device="cpu"))
    assert blobs[0]["ptrs"].shape[:2] == (3, 4) and blobs[0]["n_out"].shape == (3, 4)
    _assert_blob({k: torch.cat([blobs[0][k].reshape((12,) + blobs[1][k].shape[1:]), blobs[1][k]])
                  for k in blobs[0]}, ref.blob, "stream lead")


def test_leading_axes_roundtrip(ref):
    x = ref.x[:36].reshape(3, 12, CFG.page_words)
    want = {k: v[:36].reshape((3, 12) + v.shape[1:]) for k, v in ref.blob.items()}
    for devices in (None, 4):
        blob = pipeline.encode_pages(x, ref.table, CFG, devices=devices)
        _assert_blob(blob, want, f"lead {devices}")
        words = pipeline.decode_pages(blob, ref.table, CFG, devices=devices)
        np.testing.assert_array_equal(words.numpy(), ref.words[:36].reshape(3, 12, -1))


def test_bad_device_lists_raise(ref):
    with pytest.raises(ValueError, match="not present"):
        pipeline.encode_pages(ref.x, ref.table, CFG,
                              devices=[f"cuda:{torch.cuda.device_count()}"])
    with pytest.raises(ValueError, match="devices must be >= 1"):
        pipeline.encode_pages(ref.x, ref.table, CFG, devices=0)
    with pytest.raises(ValueError, match="unknown mode"):
        pipeline.encode_pages_sharded(ref.x, ref.table, CFG, mode="pmap")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [None, 2, 4])
def test_decode_matches_reference(ref, devices):
    blob = {k: torch.from_numpy(v) for k, v in ref.blob.items()}
    words = pipeline.decode_pages(blob, ref.table, CFG, devices=devices)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), ref.words)
    np.testing.assert_array_equal(
        pipeline.decode_pages_sharded(blob, ref.table, CFG, devices=devices or 3).numpy(),
        ref.words)


def test_decode_stream_matches_reference(ref):
    bounds = np.array_split(np.arange(N_PAGES), 4)
    parts = [{k: v[b[0]:b[-1] + 1] for k, v in ref.blob.items()} for b in bounds]
    out = list(pipeline.decode_stream(parts, ref.table, CFG, device="cpu"))
    assert len(out) == 4
    np.testing.assert_array_equal(torch.cat(out).numpy(), ref.words)
    assert list(pipeline.decode_stream(iter([]), ref.table, CFG, device="cpu")) == []


def test_unsigned_is_the_reference_unsigned_view(ref):
    """16-bit words: the values of the reference's uint16 view; 32-bit words:
    the bit patterns of its uint32 view (as int32)."""
    blob = {k: torch.from_numpy(v) for k, v in ref.blob.items()}
    got = pipeline.decode_pages(blob, ref.table, CFG, unsigned=True, devices=2)
    np.testing.assert_array_equal(got.numpy(), ref.words.astype(np.uint16).astype(np.int32))
    wide = dict(word_bits=32, page_words=256, num_bases=5, width_set=(8, 16),
                bucket_caps=(64, 192), outlier_cap=32)
    jcfg, tcfg = ref.gbdi_fr.FRConfig(**wide), FRConfig(**wide)
    rng = np.random.default_rng(3)
    x = (rng.integers(-3000, 3000, (9, 256)) + np.int64(0x7FFF0000)).astype(np.int64)
    x = (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    jt = ref.gbdi_fr.fit_fr_bases(ref.jnp.asarray(x), jcfg)
    words = np.asarray(ref.gbdi_fr.fr_decode(ref.gbdi_fr.fr_encode(ref.jnp.asarray(x), jt, jcfg),
                                             jt, jcfg))
    table = interop.table_from_numpy(np.asarray(jt.bases), np.asarray(jt.widths), device="cpu")
    blob = pipeline.encode_pages(torch.from_numpy(x), table, tcfg, devices=3)
    got = pipeline.decode_pages(blob, table, tcfg, unsigned=True, devices=3)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), words.astype(np.uint32))


# ---------------------------------------------------------------------------
# the prepared-table memo
# ---------------------------------------------------------------------------

def test_prepared_table_memo_keys_on_identity_and_version(ref):
    cpu = torch.device("cpu")
    t_enc.table_cache_clear()
    table = interop.table_from_numpy(ref.table.bases.numpy(), ref.table.widths.numpy(),
                                     device="cpu")
    a = t_enc.prepare_table(table, CFG, cpu)
    assert t_enc.prepare_table(table, CFG, cpu) is a
    assert t_enc.prepare_table(a, CFG, cpu) is a
    assert t_enc.table_cache_info() == {"hits": 1, "misses": 1, "size": 1}
    # an equal table made anew is another key (no content hash, no sync)
    twin = interop.table_from_numpy(ref.table.bases.numpy(), ref.table.widths.numpy(),
                                    device="cpu")
    assert t_enc.prepare_table(twin, CFG, cpu) is not a
    # an in-place write bumps the version counter: the entry is not reused
    table.bases[0] += 1
    b = t_enc.prepare_table(table, CFG, cpu)
    assert b is not a and int(b.bases[0]) == int(a.bases[0]) + 1
    # another config is another entry
    other = FRConfig(**{**FIELDS, "outlier_cap": 8})
    assert t_enc.prepare_table(table, other, cpu).cfg == other
    assert t_enc.table_cache_info()["misses"] == 4
    for _ in range(t_enc.PREP_CAP + 3):
        t_enc.prepare_table(interop.table_from_numpy([1, 2, 3, 4, 5, 6], [4] * 6, device="cpu"),
                            CFG, cpu)
    assert t_enc.table_cache_info()["size"] == t_enc.PREP_CAP
    t_enc.table_cache_clear()
    assert t_enc.table_cache_info() == {"hits": 0, "misses": 0, "size": 0}


def test_prepared_table_in_ops_and_the_padded_layout(ref):
    prep = t_enc.prepare_table(ref.table, CFG, torch.device("cpu"))
    bases, cls = t_enc.pad_table(ref.table, CFG)
    assert torch.equal(prep.bases, bases.reshape(-1)) and torch.equal(prep.cls, cls.reshape(-1))
    assert torch.equal(prep.meta, t_enc.kernel_meta(CFG, torch.device("cpu")))
    blob = ops.encode_pages(ref.x, prep, CFG)
    _assert_blob(blob, ref.blob, "ops + prepared")
    np.testing.assert_array_equal(ops.decode_pages(blob, prep, CFG).numpy(), ref.words)


# ---------------------------------------------------------------------------
# the FR codec's knobs and the registry's names
# ---------------------------------------------------------------------------

def _stream_data(n_words: int = 30000) -> np.ndarray:
    rng = np.random.default_rng(7)
    centers = rng.integers(0, 1 << 16, 6)
    w = centers[rng.integers(0, 6, n_words)] + rng.integers(-100, 100, n_words)
    return (w & 0xFFFF).astype(np.uint16)


@pytest.mark.parametrize("knobs", [dict(devices=4), dict(devices=None), dict(stream_batches=3),
                                   dict(stream_batches=5, devices=2), dict(stream_batches=64)])
def test_frcodec_pipeline_knobs_roundtrip(knobs):
    data = _stream_data()
    plain = t_codecs.FRCodec(word_bits=16, device="cpu")
    codec = t_codecs.FRCodec(word_bits=16, device="cpu", backend="pipeline", **knobs)
    words = codec.stream(data)
    assert torch.equal(words, plain.stream(data))
    table = codec.fit(words)
    blob, pblob = codec.encode(words, table), plain.encode(words, table)
    for k in pblob:
        if not k.startswith("_"):
            assert torch.equal(blob[k], pblob[k]), k
    dec = codec.decode(blob)
    assert torch.equal(dec, plain.decode(pblob))
    assert int((dec != words).sum()) <= codec.dropped_words(blob)
    assert codec.size_bits(blob) == plain.size_bits(pblob)


def test_frcodec_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="unknown FR backend"):
        t_codecs.FRCodec(device="cpu", backend="xla")


def test_registry_has_the_reference_names(ref):
    from repro.eval import codecs as jcodecs
    from repro.eval import run as jrun

    reg = t_codecs.default_codecs("cpu")
    assert reg.names() == jcodecs.default_codecs().names()
    assert t_run.THROUGHPUT_CODECS == jrun.THROUGHPUT_CODECS
    made = {n: reg.make(n, 16) for n in reg.names()}
    assert {n: c.name for n, c in made.items()} == {n: n for n in made}
    assert made["fr_xla"].backend == "pipeline" and made["fr_kernel"].backend == "kernel"


def test_throughput_rows_of_fr_xla_and_fr_kernel(monkeypatch):
    """The rows' fields on a host stand-in for the card (the harness refuses
    the host, so the card's name and events are patched): both FR front-ends
    give fr's bytes, keep the requested size and are not truncated."""
    class OnCard(t_codecs.FRCodec):
        torch_device = torch.device("cuda")

    made = {n: OnCard(word_bits=16, device="cpu", name=n, backend=b)
            for n, b in (("fr", "auto"), ("fr_xla", "pipeline"), ("fr_kernel", "kernel"))}
    monkeypatch.setattr(t_run, "_timed_median", lambda fn, repeats, dev: (fn(), 1e-3)[1])
    monkeypatch.setattr(t_run, "device_name", lambda dev: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(t_run, "power_limit", lambda: "700.00 W")
    wl = t_wl.default_workloads("/no/such/dir", device="cpu").get("ml_kvcache_bf16")
    data = wl.generate(1 << 16, 0)
    rows = {n: t_run.measure_throughput(wl, c, data, repeats=1, n_bytes_requested=1 << 16)
            for n, c in made.items()}
    for n, row in rows.items():
        assert row["codec"] == n and row["truncated"] is False
        assert row["n_bytes"] == row["n_bytes_requested"] == 1 << 16
        assert row["comp_bytes"] == rows["fr"]["comp_bytes"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_pipeline_on_card_matches_one_kernel_call(cuda_device):
    rng = np.random.default_rng(1)
    centers = rng.integers(0, 1 << 16, 6)
    w = (centers[rng.integers(0, 6, (64, 256))] + rng.integers(-120, 120, (64, 256))) & 0xFFFF
    host = torch.from_numpy(w.astype(np.int32))
    x = host.to(cuda_device)
    table = interop.table_from_numpy(centers.astype(np.int32), [4, 8, 4, 8, 4, 8],
                                     device=cuda_device)
    want = ops.encode_pages(x, table, CFG)
    for blob in (pipeline.encode_pages(x, table, CFG, devices=2),
                 pipeline.encode_pages_sharded(x, table, CFG, devices=3)):
        for k in want:
            assert torch.equal(blob[k], want[k]), k
    blobs = list(pipeline.encode_stream(torch.tensor_split(host, 5), table, CFG))
    for k in want:
        assert torch.equal(torch.cat([b[k] for b in blobs]), want[k]), k
    words = ops.decode_pages(want, table, CFG)
    host_blob = {k: v.cpu() for k, v in want.items()}
    parts = [{k: v[i * 16:(i + 1) * 16] for k, v in host_blob.items()} for i in range(4)]
    assert torch.equal(torch.cat(list(pipeline.decode_stream(parts, table, CFG))), words)
    assert torch.equal(pipeline.decode_pages(want, table, CFG, devices=2), words)
    with pytest.raises(ValueError, match="names the CPU"):
        pipeline.encode_pages(x, table, CFG, devices=["cpu", "cuda:0"])


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(stream_batches=4), dict(devices=2)])
def test_frcodec_pipeline_knobs_on_card(cuda_device, knobs):
    data = _stream_data(1 << 20)
    plain = t_codecs.FRCodec(word_bits=16)
    codec = t_codecs.FRCodec(word_bits=16, backend="pipeline", **knobs)
    words = codec.stream(data)
    assert words.device.type == ("cpu" if "stream_batches" in knobs else "cuda")
    table = plain.fit(plain.stream(data))
    blob, pblob = codec.encode(words, table), plain.encode(plain.stream(data), table)
    for k in pblob:
        if not k.startswith("_"):
            assert torch.equal(blob[k], pblob[k]), k
    assert torch.equal(codec.decode(blob).cpu(), plain.decode(pblob).cpu())
