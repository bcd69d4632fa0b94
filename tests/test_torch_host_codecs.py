"""The port's host codecs against the JAX package: bit packing, the GBDI
assignment at 32-bit words, the GBDI codec (fit, blobs, decode, block
sizes), B∆I (every tag, int64-extreme blocks), the codec adapters, and the
FR codec across the sweep's config grid (static and adaptive4).

Inputs are made with numpy from a seed and handed to both packages; a
fitted model is carried across wherever blobs are compared.  Tolerance:
exact equality throughout.  The JAX reference is imported inside the
``ref`` fixture, so the card tests also run where JAX is absent.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import bdi as tbdi
from repro_torch.core import bitpack as tbp
from repro_torch.core import format as tfmt
from repro_torch.core import gbdi as tgbdi
from repro_torch.eval import codecs as tcodecs
from repro_torch.eval import run as t_run
from repro_torch.eval.workloads import default_workloads as t_workloads

I64 = np.iinfo(np.int64)
N_BYTES = 64 << 10
SWEEP_SUITE = "605.mcf_s,ml_kvcache_bf16"


@pytest.fixture(scope="module")
def ref():
    """The JAX reference host codecs (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import bdi, bitpack, gbdi
    from repro.core.format import assign
    from repro.eval import run
    from repro.eval.workloads import default_workloads

    return SimpleNamespace(bdi=bdi, bitpack=bitpack, gbdi=gbdi, assign=assign, jnp=jnp,
                           run=run, workloads=default_workloads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card path has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _fields(seed: int, n: int):
    """Random widths 0..32 with runs of zero widths, and unmasked values
    (bits above each width set, which both packers must ignore)."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 33, n)
    for _ in range(3):
        lo = int(rng.integers(0, max(1, n)))
        widths[lo:lo + int(rng.integers(1, 40))] = 0
    values = rng.integers(0, 1 << 63, n, dtype=np.int64)
    return values, widths


def _gbdi_stream(word_bits: int, seed: int, n: int = 6000) -> np.ndarray:
    """Clustered words with zeros, outliers and both ends of the word range."""
    rng = np.random.default_rng(seed)
    span = 1 << word_bits
    centers = np.array([5, span // 3, span // 2 - 3, span - 40, 1 << (word_bits - 1)], np.int64)
    w = centers[rng.integers(0, len(centers), n)] + rng.integers(-3000, 3000, n)
    w[::9] = 0
    w[4::31] = rng.integers(0, span, w[4::31].shape)
    return (w % span).astype(np.uint16 if word_bits == 16 else np.uint32)


def _bdi_blocks() -> tuple[np.ndarray, dict[int, int]]:
    """64-byte blocks that reach every B∆I tag, then int64-extreme blocks;
    returns (bytes, expected tag by block index)."""
    blocks, tags = [], {}

    def add(block: np.ndarray, tag: int | None = None) -> None:
        raw = np.ascontiguousarray(block).view(np.uint8).reshape(-1)
        assert raw.size == 64
        if tag is not None:
            tags[len(blocks)] = tag
        blocks.append(raw)

    rng = np.random.default_rng(5)
    add(rng.integers(0, 256, 64).astype(np.uint8), 0)                     # uncompressed
    add(np.zeros(64, np.uint8), 1)                                         # zeros
    add(np.full(8, 0x1234_5678_9ABC_DEF0, np.int64), 2)                   # repeated
    add(0x7F3A_0000_0000 + rng.integers(-60, 60, 8), 3)                 # base8-delta1
    add(0x7F3A_0000_0000 + rng.integers(-16000, 16000, 8), 4)             # base8-delta2
    add(0x7F3A_0000_0000 + rng.integers(-(1 << 29), 1 << 29, 8), 5)       # base8-delta4
    add((0x9000_0000 + rng.integers(-60, 60, 16)).astype(np.uint32), 6)  # base4-delta1
    add((0x9000_0000 + rng.integers(-16000, 16000, 16)).astype(np.uint32), 7)  # base4-delta2
    add((30000 + np.arange(32) % 100).astype(np.uint16), 8)               # base2-delta1
    for pair in ([I64.min, I64.max], [I64.min, I64.min + 1], [I64.max, I64.max - 100],
                 [-1, 0], [I64.max, I64.min + 127], [1 << 62, -(1 << 62)]):
        add(np.array(pair * 4, np.int64))
    add(np.array([I64.min, 5, -5, I64.min + 127, 0, 0, 0, 0], np.int64))
    top = np.array([1 << 63, (1 << 63) + 3, 7, (1 << 63) | 0xFF], np.uint64)   # top bit differs
    add(np.concatenate([top, top]).view(np.int64))
    return np.concatenate(blocks), tags


def _carry(model_j, cfg_t) -> tgbdi.GBDIModel:
    return tgbdi.GBDIModel(cfg_t, torch.from_numpy(np.array(model_j.bases, np.int32)),
                           torch.from_numpy(np.array(model_j.widths, np.int32)))


GBDI_CFGS = [
    dict(word_bits=32),                                        # the paper's host config
    dict(word_bits=16, width_set=(4, 8)),                      # GBDICodec, 16-bit words
    dict(word_bits=32, num_bases=13, width_set=(2, 8, 24)),    # 4-bit pointers
    dict(word_bits=16, num_bases=6, width_set=(4, 8, 12), modified_kmeans=False),
]


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 37), (3, 4099), (4, 20000)])
def test_bitpack_matches_reference(ref, seed, n):
    values, widths = _fields(seed, n)
    jbytes, jtotal = ref.bitpack.pack_bits(values.view(np.uint64), widths)
    tbytes, ttotal = tbp.pack_bits(torch.from_numpy(values), torch.from_numpy(widths))
    assert ttotal == jtotal and tbytes.dtype == torch.uint8
    np.testing.assert_array_equal(tbytes.numpy(), jbytes)
    junp = ref.bitpack.unpack_bits(jbytes, widths)
    tunp = tbp.unpack_bits(tbytes, torch.from_numpy(widths))
    np.testing.assert_array_equal(tunp.numpy(), junp.astype(np.int64))


def test_bitpack_refuses_wide_fields():
    with pytest.raises(ValueError, match="wider"):
        tbp.pack_bits(torch.zeros(2, dtype=torch.int64), torch.tensor([3, 33]))
    with pytest.raises(ValueError, match=">= 0"):
        tbp.unpack_bits(torch.zeros(2, dtype=torch.uint8), torch.tensor([-1]))


# ---------------------------------------------------------------------------
# GBDI assignment and codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_assign_32bit_width24_matches_reference(ref, seed):
    rng = np.random.default_rng(seed)
    bases = np.concatenate([[np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1],
                            rng.integers(-(1 << 31), 1 << 31, 26)]).astype(np.int32)
    widths = rng.choice([4, 8, 16, 24], 30).astype(np.int32)
    vals = (bases.astype(np.int64)[rng.integers(0, 30, 5000)]
            + rng.integers(-(1 << 24), 1 << 24, 5000))
    vals[::7] = 0
    vals[3::11] = rng.integers(-(1 << 31), 1 << 31, vals[3::11].shape)
    vals = ((vals + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    ja = ref.assign(ref.jnp.asarray(vals), ref.jnp.asarray(bases), ref.jnp.asarray(widths),
                    word_bits=32)
    ta = tfmt.assign(torch.from_numpy(vals), torch.from_numpy(bases), torch.from_numpy(widths),
                     word_bits=32)
    for k in ("code", "delta", "payload_width"):
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)
    assert int((ta["payload_width"] == 24).sum()) > 0


@pytest.mark.parametrize("kw", GBDI_CFGS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_gbdi_codec_matches_reference(ref, kw):
    """Fit equal on the CPU; with the model carried across every blob field,
    the decode, the block sizes and the ratio equal the reference's."""
    data = _gbdi_stream(kw["word_bits"], 7)
    jcfg, tcfg = ref.gbdi.GBDIConfig(**kw), tgbdi.GBDIConfig(**kw)
    jm = ref.gbdi.fit(data, jcfg)
    tm = tgbdi.fit(data, tcfg, device="cpu")
    np.testing.assert_array_equal(tm.bases.numpy(), jm.bases)
    np.testing.assert_array_equal(tm.widths.numpy(), jm.widths)
    assert tm.table.num_bases == tcfg.num_bases
    model = _carry(jm, tcfg)
    jb, tb = ref.gbdi.encode(data, jm), tgbdi.encode(data, model)
    for k in ("ptr_stream", "payload_stream"):
        assert tb[k].dtype == torch.uint8
        np.testing.assert_array_equal(tb[k].numpy(), jb[k], err_msg=k)
    for k in ("n_words", "ptr_bits_total", "payload_bits_total"):
        assert tb[k] == jb[k] and isinstance(tb[k], int), k
    assert tgbdi.compressed_size_bits(tb) == ref.gbdi.compressed_size_bits(jb)
    assert tgbdi.compression_ratio(tb) == ref.gbdi.compression_ratio(jb)
    dec = tgbdi.decode(tb)
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(tgbdi.signed_to_words(dec.numpy(), kw["word_bits"]),
                                  ref.gbdi.decode(jb))
    assert tgbdi.roundtrip_ok(data, model)
    signed = tgbdi.words_to_signed(tgbdi.to_words(data, kw["word_bits"]), kw["word_bits"])
    geo = dict(word_bits=tcfg.word_bits, block_words=tcfg.block_words, ptr_bits=tcfg.ptr_bits)
    jsz = ref.gbdi.block_sizes_bits(ref.jnp.asarray(signed), ref.jnp.asarray(jm.bases),
                                    ref.jnp.asarray(jm.widths), **geo)
    tsz = tgbdi.block_sizes_bits(torch.from_numpy(signed), model.bases, model.widths, **geo)
    np.testing.assert_array_equal(tsz.numpy(), np.asarray(jsz))
    assert int(tsz.sum()) <= tb["ptr_bits_total"] + tb["payload_bits_total"]


@pytest.mark.parametrize("name", ["605.mcf_s", "ml_kvcache_bf16"])
def test_gbdi_fit_matches_reference_on_streams(ref, name):
    """The host config's fit on a workload stream: 605.mcf_s at 64 KiB is the
    stream where an unfused quantile interpolation put base 23 one off."""
    wl = t_workloads().get(name)
    data = wl.generate(N_BYTES, 0)
    kw = dict(word_bits=wl.word_bits, width_set=(4, 8) if wl.word_bits == 16 else (4, 8, 16, 24))
    jm = ref.gbdi.fit(data, ref.gbdi.GBDIConfig(**kw))
    tm = tgbdi.fit(data, tgbdi.GBDIConfig(**kw), device="cpu")
    np.testing.assert_array_equal(tm.bases.numpy(), jm.bases)
    np.testing.assert_array_equal(tm.widths.numpy(), jm.widths)


def test_gbdi_chunked_assignment_and_odd_stream(ref, monkeypatch):
    """Assignment in chunks gives the same blob; a 16-bit buffer of odd byte
    length pads like the reference's ``to_words``."""
    raw = _gbdi_stream(16, 3, 2001).view(np.uint8)[:-1]
    cfg = dict(word_bits=16, width_set=(4, 8))
    jm = ref.gbdi.fit(raw, ref.gbdi.GBDIConfig(**cfg))
    model = _carry(jm, tgbdi.GBDIConfig(**cfg))
    monkeypatch.setattr(tgbdi, "ASSIGN_CHUNK", 97)
    jb, tb = ref.gbdi.encode(raw, jm), tgbdi.encode(raw, model)
    np.testing.assert_array_equal(tb["payload_stream"].numpy(), jb["payload_stream"])
    np.testing.assert_array_equal(tb["ptr_stream"].numpy(), jb["ptr_stream"])
    assert tb["n_words"] == jb["n_words"] == 2001


def test_gbdi_fit_on_all_zero_stream(ref):
    data = np.zeros(100, np.uint32)
    jm = ref.gbdi.fit(data)
    tm = tgbdi.fit(data, device="cpu")
    np.testing.assert_array_equal(tm.bases.numpy(), jm.bases)
    blob = tgbdi.encode(data, tm)
    assert blob["payload_bits_total"] == 0 and tgbdi.roundtrip_ok(data, tm)


# ---------------------------------------------------------------------------
# B∆I
# ---------------------------------------------------------------------------

def _bdi_equal(ref, data) -> np.ndarray:
    jb, tb = ref.bdi.compress(data), tbdi.compress(data, device="cpu")
    np.testing.assert_array_equal(tb["tags"].numpy(), jb["tags"])
    np.testing.assert_array_equal(tb["sizes_bits"].numpy(), jb["sizes_bits"])
    np.testing.assert_array_equal(tb["blocks"].numpy(), jb["blocks"])
    assert tb["n_bytes"] == jb["n_bytes"] and tb["patterns"] == jb["patterns"]
    assert tbdi.compressed_size_bits(tb) == ref.bdi.compressed_size_bits(jb)
    assert tbdi.compression_ratio(tb) == ref.bdi.compression_ratio(jb)
    np.testing.assert_array_equal(tbdi.decompress(tb).numpy(), ref.bdi.decompress(jb))
    return jb["tags"]


def test_bdi_every_tag_and_int64_extremes(ref):
    data, want = _bdi_blocks()
    tags = _bdi_equal(ref, data)
    assert {int(tags[i]) for i in want} == set(range(9))
    for i, tag in want.items():
        assert tags[i] == tag, (i, tags[i], tag)


@pytest.mark.parametrize("cut", [0, 1, 3, 62])
def test_bdi_ragged_buffers(ref, cut):
    """Buffers not a whole number of 4-byte words or 64-byte blocks."""
    data, _ = _bdi_blocks()
    _bdi_equal(ref, data.tobytes()[: data.size - cut])


@pytest.mark.parametrize("name", ["605.mcf_s", "col_int_keys", "ml_kvcache_bf16"])
def test_bdi_on_workloads(ref, name):
    _bdi_equal(ref, t_workloads().get(name).generate(48 << 10, 2))


# ---------------------------------------------------------------------------
# codec adapters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("word_bits,n_words", [(16, 1001), (16, 4096), (32, 777)])
def test_adapters_roundtrip_the_stream(ref, word_bits, n_words):
    """stream -> encode -> decode gives the stream back (an odd 16-bit count
    included), and the sizes equal the reference adapters' on the same data."""
    from repro.eval import codecs as jcodecs

    data = _gbdi_stream(word_bits, 11, n_words)
    for cname in ("gbdi", "bdi"):
        codec = tcodecs.default_codecs("cpu").make(cname, word_bits)
        jcodec = jcodecs.default_codecs().make(cname, word_bits)
        assert codec.lossless and codec.torch_device.type == "cpu"
        words = codec.stream(data)
        model = codec.fit(words)
        blob = codec.encode(words, model)
        dec = codec.decode(blob)
        assert dec.dtype == torch.int32 and torch.equal(dec, words)
        assert codec.dropped_words(blob) == 0
        jblob = jcodec.encode(data, jcodec.fit(data))
        assert codec.size_bits(blob) == jcodec.size_bits(jblob)


def test_word_bits_for_dtype(ref):
    from repro.eval.codecs import word_bits_for_dtype

    for dt in (np.float32, np.float16, np.int16, np.uint8, np.float64, np.int32):
        assert tcodecs.word_bits_for_dtype(dt) == word_bits_for_dtype(dt)
    assert tcodecs.word_bits_for_dtype(torch.bfloat16) == 16
    assert tcodecs.word_bits_for_dtype(torch.float32) == 32


def test_codec_registry_names():
    assert tcodecs.default_codecs("cpu").names() == ["gbdi", "bdi", "fr", "fr_xla", "fr_kernel"]


# ---------------------------------------------------------------------------
# the FR config sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile_set", ["static", "adaptive4"])
def test_sweep_matches_reference(ref, profile_set):
    jrows = ref.run.sweep(ref.workloads(), suite=SWEEP_SUITE, backend="ref", n_bytes=N_BYTES,
                          profile_sets=profile_set)
    trows = t_run.sweep(t_workloads(), suite=SWEEP_SUITE, device="cpu", n_bytes=N_BYTES,
                        profile_sets=profile_set)
    assert len(trows) == len(jrows) == (12 if profile_set == "static" else 3)
    for j, t in zip(jrows, trows):
        assert t["config"] == j["config"] and t["profile_set"] == j["profile_set"]
        assert t["geomean_cr"] == j["geomean_cr"], t["config"]
        assert t["verified"] and j["verified"]
        assert t["width_sets"] == j["width_sets"]
        assert t.get("cap_profiles") == j.get("cap_profiles")
        for jc, tc in zip(j["cells"], t["cells"]):
            assert tc["codec"] == jc["codec"] and tc["workload"] == jc["workload"]
            assert tc["compression_ratio"] == jc["compression_ratio"], (t["config"], tc["workload"])
    assert any(r["pareto"] for r in trows)
    assert "CR(geo)" in t_run.format_sweep_table(trows)


def test_sweep_grid_is_the_reference_grid(ref):
    assert t_run.SWEEP_SHAPES == ref.run.SWEEP_SHAPES
    assert t_run.SWEEP_NUM_BASES == ref.run.SWEEP_NUM_BASES
    assert t_run.SWEEP_PROFILE_SETS == ref.run.SWEEP_PROFILE_SETS
    assert len(t_run.sweep_grid("static,adaptive4")) == 15
    with pytest.raises(KeyError, match="unknown profile set"):
        t_run.sweep_grid("static,nope")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("seed,n", [(2, 37), (4, 3_000_000)])
def test_bitpack_on_card(cuda_device, seed, n):
    values, widths = _fields(seed, n)
    cbytes, ctotal = tbp.pack_bits(torch.from_numpy(values), torch.from_numpy(widths))
    kbytes, ktotal = tbp.pack_bits(torch.from_numpy(values).to(cuda_device),
                                   torch.from_numpy(widths).to(cuda_device))
    assert ktotal == ctotal and torch.equal(kbytes.cpu(), cbytes)
    kunp = tbp.unpack_bits(kbytes, torch.from_numpy(widths).to(cuda_device))
    assert torch.equal(kunp.cpu(), tbp.unpack_bits(cbytes, torch.from_numpy(widths)))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", GBDI_CFGS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_gbdi_on_card_matches_cpu(cuda_device, kw):
    """The CPU fit carried to the card: the same blob, the stream back."""
    data = _gbdi_stream(kw["word_bits"], 7, 300_000)
    cfg = tgbdi.GBDIConfig(**kw)
    model = tgbdi.fit(data, cfg, device="cpu")
    cb = tgbdi.encode(data, model)
    kb = tgbdi.encode(data, model.to(cuda_device))
    for k in ("ptr_stream", "payload_stream"):
        assert torch.equal(kb[k].cpu(), cb[k]), k
    assert kb["payload_bits_total"] == cb["payload_bits_total"]
    assert torch.equal(tgbdi.decode(kb).cpu(), tgbdi.decode(cb))
    own = tgbdi.fit(data, cfg)                   # the card's own fit
    assert own.device.type == "cuda" and tgbdi.roundtrip_ok(data, own)


@pytest.mark.cuda
def test_bdi_on_card_matches_cpu(cuda_device):
    data, want = _bdi_blocks()
    big = np.concatenate([data, t_workloads().get("col_int_keys").generate(1 << 20, 0)
                          .view(np.uint8)])
    cb, kb = tbdi.compress(big, device="cpu"), tbdi.compress(big, device=cuda_device)
    assert torch.equal(kb["tags"].cpu(), cb["tags"])
    assert torch.equal(kb["sizes_bits"].cpu(), cb["sizes_bits"])
    assert {int(kb["tags"][i]) for i in want} == set(range(9))
    assert torch.equal(tbdi.decompress(kb).cpu(), tbdi.decompress(cb))


@pytest.mark.cuda
def test_sweep_blobs_on_card_match_cpu(cuda_device):
    reg = t_workloads()
    for point in t_run.sweep_grid("static,adaptive4"):
        for name in SWEEP_SUITE.split(","):
            wl = reg.get(name)
            cfg = point.config(wl.word_bits)
            cpu = tcodecs.FRCodec(word_bits=wl.word_bits, device="cpu", cfg=cfg)
            card = tcodecs.FRCodec(word_bits=wl.word_bits, cfg=cfg)
            data = wl.generate(256 << 10, 1)
            words = cpu.stream(data)
            table = cpu.fit(words)
            pb, kb = cpu.encode(words, table), card.encode(card.stream(data), table)
            for k in pb:
                if not k.startswith("_"):
                    assert torch.equal(kb[k].cpu(), pb[k]), (point, name, k)
            assert card.size_bits(kb) == cpu.size_bits(pb)
