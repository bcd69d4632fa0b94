"""PyTorch port vs the JAX reference: config geometry, lane packing, plain
codec blobs and decodes, serialization, base fitting and workload streams.

Inputs are made with numpy from a seed and handed to both packages; the
fitted table is carried across (never fitted twice) wherever blobs are
compared.  Tolerance: exact equality throughout.
"""
import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gbdi_fr as jfr
from repro.core import kmeans as jkm
from repro.core.format import BaseTable as JTable
from repro.core.format_doc import serialize_page as j_serialize
from repro.data import workloads as j_dumps
from repro.eval import workloads as j_workloads
from repro.kernels.gbdi_decode import gbdi_decode_pallas
from repro.kernels.gbdi_encode import gbdi_encode_pallas
from repro_torch import interop
from repro_torch.core import format as tfmt
from repro_torch.core import gbdi as tgbdi
from repro_torch.core import gbdi_fr as tfr
from repro_torch.core import kmeans as tkm
from repro_torch.core.format_doc import serialize_page as t_serialize
from repro_torch.eval import workloads as t_workloads

# tests/test_kernels.py::CFGS (the first two run in tier 1 there)
KERNEL_CFGS = [
    dict(word_bits=16, page_words=256, width_set=(4, 8), bucket_caps=(64, 224), outlier_cap=16),
    dict(word_bits=32, page_words=256, width_set=(8, 16), bucket_caps=(64, 224), outlier_cap=32),
    dict(),                                                      # bf16 production default
    dict(word_bits=16, page_words=1024, width_set=(2, 4, 8),
         bucket_caps=(128, 256, 768), outlier_cap=32),
    dict(word_bits=32, page_words=2048, delta_bits=8, num_bases=14, outlier_cap=128),
]
# tests/test_fr_v2.py::PARITY_CFGS
PARITY_CFGS = [
    dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
         bucket_caps=(64, 192), outlier_cap=16),
    dict(word_bits=16, page_words=256, num_bases=6, width_set=(2, 4, 8),
         bucket_caps=(16, 64, 160), outlier_cap=16),
    dict(word_bits=32, page_words=256, num_bases=5, width_set=(8, 16),
         bucket_caps=(64, 192), outlier_cap=32),
    dict(word_bits=16, page_words=128, num_bases=6, width_set=(2, 4, 8),
         bucket_caps=(16, 8, 8), outlier_cap=4),
    dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
         cap_profiles=((64, 192), (192, 64), (8, 8)), outlier_cap=16),
]
# repro.eval.codecs.FRCodec defaults (16- and 32-bit)
CODEC_CFGS = [
    dict(word_bits=16, page_words=2048, num_bases=14, width_set=(4, 8),
         bucket_caps=(192, 1856), outlier_cap=64),
    dict(word_bits=32, page_words=2048, num_bases=14, width_set=(8, 16),
         bucket_caps=(192, 1856), outlier_cap=128),
]
ALL_CFGS = KERNEL_CFGS + PARITY_CFGS + CODEC_CFGS


def _cfg_id(kw):
    return "-".join(f"{k}{v}" for k, v in kw.items()).replace(" ", "") or "default"


def _pair(kw):
    return jfr.FRConfig(**kw), tfr.FRConfig(**kw)


def _pages(rng, cfg, n_pages, style):
    """tests/test_kernels.py::_pages, as numpy int32."""
    mask = (1 << cfg.word_bits) - 1
    if style == "gauss":
        x = rng.normal(0, 1, (n_pages, cfg.page_words)).astype(np.float32)
        w = x.view(np.uint32) >> (16 if cfg.word_bits == 16 else 0)
    elif style == "clustered":
        centers = rng.integers(0, mask, 6)
        w = (centers[rng.integers(0, 6, (n_pages, cfg.page_words))]
             + rng.integers(-60, 60, (n_pages, cfg.page_words)))
    elif style == "zeros":
        w = np.where(rng.random((n_pages, cfg.page_words)) < 0.6, 0,
                     rng.integers(0, mask, (n_pages, cfg.page_words)))
    else:  # uniform: worst case, all outliers
        w = rng.integers(0, mask, (n_pages, cfg.page_words))
    return (w & mask).astype(np.int64).astype(np.int32)


def _parity_pages(cfg, n_pages=4):
    """The input of tests/test_fr_v2.py::test_cross_backend_blob_parity."""
    rng = np.random.default_rng(cfg.page_words + cfg.num_bases)
    mask = (1 << cfg.word_bits) - 1
    centers = rng.integers(0, mask, cfg.num_bases)
    w = (centers[rng.integers(0, cfg.num_bases, (n_pages, cfg.page_words))]
         + rng.integers(-120, 120, (n_pages, cfg.page_words)))
    w[:, ::7] = 0
    return (w & mask).astype(np.int64).astype(np.int32)


def _carry(jtable):
    return interop.table_from_numpy(np.asarray(jtable.bases), np.asarray(jtable.widths),
                                   device="cpu")


def _assert_codec_parity(x, jtable, jcfg, tcfg):
    """Port encode == JAX encode; decode equal both ways."""
    ttable = _carry(jtable)
    jb = jfr.fr_encode(jnp.asarray(x), jtable, jcfg)
    tb = tfr.fr_encode(torch.from_numpy(x), ttable, tcfg)
    assert set(jb) == set(tb)
    jb_np = {k: np.asarray(v) for k, v in jb.items()}
    for k in jb_np:
        np.testing.assert_array_equal(tb[k].numpy(), jb_np[k], err_msg=k)
    j_dec = np.asarray(jfr.fr_decode(jb, jtable, jcfg))
    # port decodes the JAX blob, JAX decodes the port blob
    t_of_j = tfr.fr_decode(interop.blob_from_numpy(jb_np, device="cpu"), ttable, tcfg).numpy()
    j_of_t = np.asarray(jfr.fr_decode(
        {k: jnp.asarray(v) for k, v in interop.blob_to_numpy(tb).items()}, jtable, jcfg))
    np.testing.assert_array_equal(t_of_j, j_dec)
    np.testing.assert_array_equal(j_of_t, j_dec)
    return jb_np, tb


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", ALL_CFGS, ids=_cfg_id)
def test_config_geometry_matches(kw):
    jc, tc = _pair(kw)
    props = ["word_bits", "page_words", "num_bases", "width_set", "bucket_caps",
             "outlier_cap", "cap_profiles", "num_classes", "profiles", "num_profiles",
             "widest_bits", "ptr_bits", "zero_code", "outlier_code", "ptr_lanes",
             "class_lanes", "class_lane_offsets", "delta_lanes", "drop_penalty_bits"]
    for p in props:
        assert getattr(tc, p) == getattr(jc, p), p
    for p in range(jc.num_profiles):
        assert tc.class_lanes_for(p) == jc.class_lanes_for(p)
        assert tc.class_lane_offsets_for(p) == jc.class_lane_offsets_for(p)
        assert tc.delta_lanes_for(p) == jc.delta_lanes_for(p)
        assert tc.compressed_bytes_for_profile(p) == jc.compressed_bytes_for_profile(p)
        nd = np.array([0, 1, 7, jc.page_words], np.int32)
        np.testing.assert_array_equal(
            tc.profile_cost_bits(p, torch.from_numpy(nd)).numpy(),
            np.asarray(jc.profile_cost_bits(p, jnp.asarray(nd))))
    assert tc.compressed_bytes_per_page() == jc.compressed_bytes_per_page()
    assert tc.ratio() == jc.ratio() and tc.bits_per_word() == jc.bits_per_word()
    assert interop.config_from_fields(dataclasses.asdict(jc)) == tc


BAD_CFGS = [
    dict(word_bits=8),
    dict(width_set=(8, 4), bucket_caps=(192, 1856)),
    dict(width_set=(3,), bucket_caps=(2048,)),
    dict(width_set=(4, 16), bucket_caps=(192, 1856)),
    dict(bucket_caps=(192,)),
    dict(bucket_caps=(192, 4096)),
    dict(bucket_caps=(4, 1856)),
    dict(page_words=1000, bucket_caps=(192, 800)),
    dict(num_bases=70000),
    dict(cap_profiles=()),
    dict(cap_profiles=((192,),)),
    dict(cap_profiles=((192, 1856), (4, 8))),
    dict(cap_profiles=tuple((192, 1856) for _ in range(257))),
    dict(word_bits=32, page_words=16384, num_bases=6, width_set=(8, 16),
         cap_profiles=((1024, 15360), (2048, 14336)), outlier_cap=16384),
]


@pytest.mark.parametrize("kw", BAD_CFGS, ids=lambda kw: _cfg_id(kw)[:60])
def test_config_errors_match(kw):
    with pytest.raises(ValueError) as j_err:
        jfr.FRConfig(**kw)
    with pytest.raises(ValueError) as t_err:
        tfr.FRConfig(**kw)
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# packing and small helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_lanes_sets_bit_31(bits):
    rng = np.random.default_rng(bits)
    per = 32 // bits
    x = rng.integers(0, 1 << bits, (3, 4 * per)).astype(np.int32)
    x[:, per - 1] = (1 << bits) - 1            # top field of lane 0: bit 31 set
    x[1, :] = (1 << bits) - 1                  # all-ones lanes (-1 as int32)
    packed = tfr.pack_lanes(torch.from_numpy(x), bits)
    ref = np.asarray(jfr.pack_lanes(jnp.asarray(x), bits))
    np.testing.assert_array_equal(packed.numpy(), ref)
    assert (packed[:, 0] < 0).all()
    back = tfr.unpack_lanes(packed, bits, x.shape[1])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jfr.unpack_lanes(jnp.asarray(ref), bits, x.shape[1])))


def test_assign_and_class_demand_match():
    from repro.core import format as jfmt

    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 16, 512).astype(np.int32)
    vals[::5] = 0
    bases = np.array([100, 9000, 30000, 65000, 2**31 - 5], np.int32)
    widths = np.array([4, 8, 8, 4, 7], np.int32)    # 7: a dead (foreign) width
    ja = jfmt.assign(jnp.asarray(vals), jnp.asarray(bases), jnp.asarray(widths), word_bits=16)
    ta = tfmt.assign(torch.from_numpy(vals), torch.from_numpy(bases),
                     torch.from_numpy(widths), word_bits=16)
    for k in ja:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)
    jcls = jfmt.class_indices(jnp.asarray(widths), (4, 8))
    tcls = tfmt.class_indices(torch.from_numpy(widths), (4, 8))
    np.testing.assert_array_equal(tcls.numpy(), np.asarray(jcls))
    np.testing.assert_array_equal(
        tfmt.class_demand(ta["code"], tcls, 2).numpy(),
        np.asarray(jfmt.class_demand(ja["code"], jcls, 2)))


@pytest.mark.parametrize("word_bits", [16, 32])
def test_wrapped_delta_at_int32_extremes(word_bits):
    vals = np.array([0, 1, -1, 2**31 - 1, -2**31, 65535, 32768], np.int32)
    bases = np.array([2**31 - 1, -2**31, 0, 12345], np.int32)
    jd = jkm.wrapped_delta(jnp.asarray(vals), jnp.asarray(bases), word_bits)
    td = tkm.wrapped_delta(torch.from_numpy(vals), torch.from_numpy(bases), word_bits)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tkm.delta_magnitude(td).numpy(),
                                  np.asarray(jkm.delta_magnitude(jd)))


def test_init_bases_index_arithmetic():
    """float32 linspace indices agree with jnp.linspace for every size."""
    rng = np.random.default_rng(0)
    for n in (1, 3, 100, 65535, 1 << 16):
        s = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
        for k in (1, 14, 30):
            np.testing.assert_array_equal(
                tkm._init_bases(torch.from_numpy(s), k).numpy(),
                np.asarray(jkm._init_bases(jnp.asarray(s), k)), err_msg=f"{n},{k}")


def test_word_views_match():
    from repro.core import gbdi as jg

    raw = np.random.default_rng(5).integers(0, 256, 1001).astype(np.uint8)
    for wb in (16, 32):
        w = tgbdi.to_words(raw, wb)
        np.testing.assert_array_equal(w, jg.to_words(raw, wb))
        s = tgbdi.words_to_signed(w, wb)
        np.testing.assert_array_equal(s, jg.words_to_signed(w, wb))
        np.testing.assert_array_equal(tgbdi.signed_to_words(s, wb), jg.signed_to_words(s, wb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_to_pages_matches(dtype):
    kw = dict(word_bits=16 if dtype == "bfloat16" else 32, page_words=128,
              width_set=(4, 8), bucket_caps=(32, 96), outlier_cap=8)
    jc, tc = _pair(kw)
    v = np.random.default_rng(1).normal(0, 3, (3, 100)).astype(np.float32)
    if dtype == "int32":
        v = (v * 1e6).astype(np.int32)
    t = torch.from_numpy(v).to(getattr(torch, dtype))
    j = jnp.asarray(v).astype(getattr(jnp, dtype))
    tp, tmeta = tfr.tensor_to_pages(t, tc)
    jp, _ = jfr.tensor_to_pages(j, jc)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    back = tfr.pages_to_tensor(tp, tmeta, tc)
    assert back.dtype == t.dtype and torch.equal(back.view(-1), t.view(-1))


# ---------------------------------------------------------------------------
# blob parity: the port's plain encode/decode vs the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", KERNEL_CFGS[:2], ids=_cfg_id)
@pytest.mark.parametrize("style", ["gauss", "clustered", "zeros", "uniform"])
def test_blob_parity_kernel_cfgs(kw, style):
    jc, tc = _pair(kw)
    rng = np.random.default_rng(zlib.crc32(f"{jc.word_bits}{jc.page_words}{style}".encode()))
    x = _pages(rng, jc, 8, style)
    jtable = jfr.fit_fr_bases(jnp.asarray(x), jc)
    _assert_codec_parity(x, jtable, jc, tc)


@pytest.mark.parametrize("kw", PARITY_CFGS, ids=_cfg_id)
def test_blob_parity_parity_cfgs(kw):
    jc, tc = _pair(kw)
    x = _parity_pages(jc)
    jtable = jfr.fit_fr_bases(jnp.asarray(x), jc)
    _assert_codec_parity(x, jtable, jc, tc)


SPILL_CFG = dict(word_bits=16, page_words=256, num_bases=3, width_set=(4, 8),
                 bucket_caps=(32, 224), outlier_cap=8)


def spill_drop_case(kind):
    """A hand-made table and pages that force the spill chain or drops.

    Bases 0 and 1 share a value: class-0 demand far over its 32-slot bucket
    re-codes to the class-1 twin (spills).  Pages of far-off words overflow
    the 8-slot outlier table (drops).
    """
    rng = np.random.default_rng(11)
    table = (np.array([1000, 1000, 20000], np.int32), np.array([4, 8, 8], np.int32))
    if kind == "spill":
        x = 1000 + rng.integers(-7, 8, (4, 256))
        x[:, ::9] = 20000 + rng.integers(-100, 100, (4, 29))
        x[:, ::31] = 0
    else:
        x = rng.integers(30000, 65536, (4, 256))
        x[:, ::3] = 1000 + rng.integers(-60, 60, (4, 86))
    return (x & 0xFFFF).astype(np.int32), table


@pytest.mark.parametrize("kind", ["spill", "drop"])
def test_blob_parity_forced_spill_and_drop(kind):
    jc, tc = _pair(SPILL_CFG)
    x, (bases, widths) = spill_drop_case(kind)
    jb, _ = _assert_codec_parity(x, JTable(jnp.asarray(bases), jnp.asarray(widths)), jc, tc)
    assert jb["n_spilled"].sum() > 0 if kind == "spill" else jb["n_dropped"].sum() > 0


PALLAS_CFGS = KERNEL_CFGS[:2] + [PARITY_CFGS[4]]


@pytest.mark.parametrize("kw", PALLAS_CFGS, ids=_cfg_id)
def test_port_matches_pallas_interpret(kw):
    """The port's plain codec against the Pallas kernels in interpret mode."""
    jc, tc = _pair(kw)
    x = _pages(np.random.default_rng(21), jc, 4, "clustered")
    x[:, ::5] = 0
    jtable = jfr.fit_fr_bases(jnp.asarray(x), jc)
    ttable = _carry(jtable)
    kb = gbdi_encode_pallas(jnp.asarray(x), jtable, jc, interpret=True)
    tb = tfr.fr_encode(torch.from_numpy(x), ttable, tc)
    assert set(kb) == set(tb)
    for k in kb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(kb[k]), err_msg=k)
    kd = np.asarray(gbdi_decode_pallas(kb, jtable, jc, interpret=True))
    np.testing.assert_array_equal(tfr.fr_decode(tb, ttable, tc).numpy(), kd)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [PARITY_CFGS[0], PARITY_CFGS[2], PARITY_CFGS[4]], ids=_cfg_id)
def test_serialize_page_matches_reference(kw):
    jc, tc = _pair(kw)
    x = _parity_pages(jc, 3)
    jtable = jfr.fit_fr_bases(jnp.asarray(x), jc)
    jb = jfr.fr_encode(jnp.asarray(x), jtable, jc)
    tb = tfr.fr_encode(torch.from_numpy(x), _carry(jtable), tc)
    for i in range(3):
        assert (t_serialize({k: v[i] for k, v in tb.items()}, tc)
                == j_serialize({k: np.asarray(v)[i] for k, v in jb.items()}, jc))


GOLDEN_CRCS = [3381184247, 1710504446, 3996448536]


def golden_case():
    """tests/test_fr_v2.py's golden-CRC input, numpy only."""
    kw = dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
              bucket_caps=(64, 192), outlier_cap=16)
    bases = np.array([1000, 5000, 9000, 20000, 40000, 60000], np.int32)
    widths = np.array([4, 8, 4, 8, 4, 8], np.int32)
    rng = np.random.default_rng(42)
    w = bases.astype(np.int64)[rng.integers(0, 6, (3, 256))] + rng.integers(-120, 120, (3, 256))
    w[:, ::7] = 0
    return kw, bases, widths, (w & 0xFFFF).astype(np.int32)


def test_golden_crcs_without_jax():
    kw, bases, widths, x = golden_case()
    cfg = tfr.FRConfig(**kw)
    blob = tfr.fr_encode(torch.from_numpy(x), interop.table_from_numpy(bases, widths, device="cpu"),
                         cfg)
    assert "profile" not in blob
    crcs = [zlib.crc32(t_serialize({k: v[i] for k, v in blob.items()}, cfg))
            for i in range(3)]
    assert crcs == GOLDEN_CRCS


# ---------------------------------------------------------------------------
# base fitting and workloads
# ---------------------------------------------------------------------------

def _stream_words(name, n_bytes):
    data = t_workloads.default_workloads().get(name).generate(n_bytes, 0)
    wb = 16 if name == "ml_kvcache_bf16" else 32
    return wb, tgbdi.words_to_signed(tgbdi.to_words(data, wb), wb).astype(np.int32)


@pytest.mark.parametrize("name", ["ml_kvcache_bf16", "605.mcf_s"])
def test_fit_fr_bases_matches_reference(name):
    """The CPU fit returns the JAX table exactly on both main-path streams
    at 256 KiB (same sample shaping, float32 steps in the same order)."""
    wb, words = _stream_words(name, 256 << 10)
    kw = CODEC_CFGS[0] if wb == 16 else CODEC_CFGS[1]
    jc, tc = _pair(kw)
    jt = jfr.fit_fr_bases(jnp.asarray(words), jc)
    tt = tfr.fit_fr_bases(torch.from_numpy(words), tc)
    np.testing.assert_array_equal(tt.bases.numpy(), np.asarray(jt.bases))
    np.testing.assert_array_equal(tt.widths.numpy(), np.asarray(jt.widths))


def test_fit_bases_host_matches_reference():
    """Host wrapper incl. the seeded subsample of a stream over the cap."""
    _, words = _stream_words("605.mcf_s", 1 << 20)
    kw = dict(num_bases=14, width_set=(8, 16), word_bits=32, iters=4)
    jb, jw = jkm.fit_bases_host(words, **kw)
    tb, tw = tkm.fit_bases_host(words, device="cpu", **kw)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tw, jw)


def test_nanquantile_is_the_reference_fused_interpolation():
    """Column quantiles with NaN holes equal ``jnp.nanpercentile`` under jit
    bit for bit: XLA's CPU compiler fuses the interpolation into one FMA,
    which a plain ``low * lw + high * hw`` misses by an ulp at large values."""
    import jax

    qs = jnp.asarray([10.0, 25.0, 50.0, 75.0, 90.0])
    ref = jax.jit(lambda m: jnp.nanpercentile(m, qs, axis=0))
    q = torch.tensor([10.0, 25.0, 50.0, 75.0, 90.0]) / torch.tensor(100.0)
    rng = np.random.default_rng(1)
    for _ in range(60):
        n, k = int(rng.integers(1, 600)), int(rng.integers(1, 8))
        x = rng.normal(0, 10 ** rng.uniform(0, 7), (n, k)).round().astype(np.float32)
        x[rng.random((n, k)) < 0.3] = np.nan
        got = tkm._nanquantile_cols(torch.from_numpy(x), q).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(x))))


def test_fma_f32_rounds_once():
    a = torch.tensor([5474585.0, 1.0, 3.0, -2.5], dtype=torch.float32)
    b = torch.tensor([0.3000183, 1.0 + 2 ** -23, 1.0 / 3.0, 0.125], dtype=torch.float32)
    c = torch.tensor([3951281.5, -1.0, -1.0, 7.0], dtype=torch.float32)
    want = [np.float32(float(x) * float(y) + float(z))      # exact in float64 here
            for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())]
    assert tkm._fma_f32(a, b, c).tolist() == [float(w) for w in want]
    # a*b + c = 1 + 3 * 2**-24 - 2**-70: float64 rounds it onto the float32
    # midpoint, whose tie-to-even goes up; the single rounding goes down
    a, b, c = (torch.tensor([v], dtype=torch.float32)
               for v in (2 ** -24 * (1 + 2 ** -23), 1 - 2 ** -23, 1 + 2 ** -23))
    assert float((a.double() * b.double() + c.double()).float()) == 1 + 2 ** -22
    assert float(tkm._fma_f32(a, b, c)) == 1 + 2 ** -23


@pytest.mark.parametrize("name", ["ml_kvcache_bf16", *j_dumps.WORKLOADS])
def test_workload_streams_identical(name):
    n_bytes = 96 << 10
    if name == "ml_kvcache_bf16":
        ref = j_workloads.ml_kvcache_bf16(n_bytes, 3)
    else:
        ref = j_dumps.generate(name, n_bytes, 3)
    got = t_workloads.default_workloads().get(name).generate(n_bytes, 3)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
