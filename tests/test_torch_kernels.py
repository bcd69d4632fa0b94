"""The port's kernel modules: wrappers, plain versions, budgets, backends.

On the CPU each wrapper runs its kernel's plain version, and these tests hold
that path (and the table padding, budget check and backend routing around
the kernels) against the JAX package.  Tests marked ``cuda`` launch the
hand-written kernels and compare them with their plain versions bit for bit;
they skip where there is no card.  The JAX reference is imported inside
the tests that need it, so the card tests also run where JAX is absent.
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import gbdi_fr as tfr
from repro_torch.core.format import BaseTable
from repro_torch.kernels import gbdi_decode as t_dec
from repro_torch.kernels import gbdi_encode as t_enc
from repro_torch.kernels import ops

SMALL = dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
             bucket_caps=(64, 192), outlier_cap=16)
ADAPTIVE = dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
                cap_profiles=((64, 192), (192, 64), (8, 8)), outlier_cap=16)
WIDE = dict(word_bits=32, page_words=256, num_bases=5, width_set=(8, 16),
            bucket_caps=(64, 192), outlier_cap=32)
DEFAULT16 = dict(word_bits=16, page_words=2048, num_bases=14, width_set=(4, 8),
                 bucket_caps=(192, 1856), outlier_cap=64)
DEFAULT32 = dict(word_bits=32, page_words=2048, num_bases=14, width_set=(8, 16),
                 bucket_caps=(192, 1856), outlier_cap=128)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference modules (the test skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import gbdi_fr
    from repro.kernels import gbdi_encode

    return SimpleNamespace(jnp=jnp, fr=gbdi_fr, enc=gbdi_encode)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _clustered(cfg, n_pages, seed):
    rng = np.random.default_rng(seed)
    mask = (1 << cfg.word_bits) - 1
    centers = rng.integers(0, mask, cfg.num_bases)
    w = (centers[rng.integers(0, cfg.num_bases, (n_pages, cfg.page_words))]
         + rng.integers(-120, 120, (n_pages, cfg.page_words)))
    w[:, ::7] = 0
    w[:, 1::97] = rng.integers(0, mask, w[:, 1::97].shape)   # scattered outliers
    return (w & mask).astype(np.int64).astype(np.int32)


@pytest.mark.parametrize("num_bases", [1, 6, 8, 14, 30])
def test_pad_table_matches_reference(ref, num_bases):
    jnp = ref.jnp
    kw = dict(num_bases=num_bases)
    jc, tc = ref.fr.FRConfig(**kw), tfr.FRConfig(**kw)
    assert t_enc.k_padded(tc) == ref.enc.k_padded(jc)
    rng = np.random.default_rng(num_bases)
    bases = rng.integers(-2**31, 2**31 - 1, num_bases).astype(np.int32)
    widths = rng.choice([4, 8, 5], num_bases).astype(np.int32)   # 5: foreign width
    jb, jcls = ref.enc.pad_table(ref.fr.BaseTable(jnp.asarray(bases), jnp.asarray(widths)), jc)
    tb, tcls = t_enc.pad_table(interop.table_from_numpy(bases, widths, device="cpu"), tc)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tcls.numpy(), np.asarray(jcls))


def test_smem_budget_check():
    """The shared-memory check stands where the VMEM check stood: default
    pages fit one block, a page whose decode warp cannot stage its blob in
    227 KB raises (no fallback), and so does an encode page past the words
    its block's registers hold.  The decode block stages one page blob for
    each of its warps (fewer warps for large pages), so it needs more
    shared memory than the encode's block."""
    for kw in (DEFAULT16, DEFAULT32, ADAPTIVE):
        cfg = tfr.FRConfig(**kw)
        t_enc.check_smem(cfg)
        t_enc.check_smem(cfg, t_dec.smem_bytes(cfg))
        assert t_dec.block_warps(cfg) == t_dec.MAX_WARPS
        assert t_enc.smem_bytes(cfg) < t_dec.smem_bytes(cfg) <= t_enc.SMEM_LIMIT_BYTES
    assert t_enc.smem_bytes(tfr.FRConfig(**DEFAULT16)) == 2680
    assert t_dec.smem_bytes(tfr.FRConfig(**DEFAULT16)) == 16592
    big = tfr.FRConfig(word_bits=16, page_words=32768, width_set=(4, 8),
                       bucket_caps=(4096, 28672), outlier_cap=64)
    t_enc.check_smem(big, t_dec.smem_bytes(big))     # the decode takes this page
    with pytest.raises(ValueError, match="lower page_words"):
        t_enc.check_smem(big)
    huge = tfr.FRConfig(word_bits=16, page_words=262144, width_set=(4, 8),
                        bucket_caps=(32768, 229376), outlier_cap=64)
    assert t_dec.block_warps(huge) == 0
    with pytest.raises(ValueError, match="shared memory"):
        t_enc.check_smem(huge, t_dec.smem_bytes(huge))
    edge = tfr.FRConfig(word_bits=16, page_words=t_enc.MAX_PAGE_WORDS, width_set=(4, 8),
                        bucket_caps=(256, 2048), outlier_cap=64)
    t_enc.check_smem(edge)


@pytest.mark.parametrize("kw", [SMALL, ADAPTIVE, WIDE], ids=["small", "adaptive", "wide"])
def test_wrappers_on_cpu_run_the_plain_version(kw):
    cfg = tfr.FRConfig(**kw)
    x = torch.from_numpy(_clustered(cfg, 4, 0))
    table = tfr.fit_fr_bases(x, cfg)
    before = (t_enc.launch_count, t_dec.launch_count)
    blob = t_enc.gbdi_encode(x, table, cfg)
    plain = t_enc.gbdi_encode_plain(x, table, cfg)
    assert set(blob) == set(plain)
    for k in blob:
        assert torch.equal(blob[k], plain[k]), k
    dec = t_dec.gbdi_decode(blob, table, cfg)
    assert torch.equal(dec, t_dec.gbdi_decode_plain(blob, table, cfg))
    assert (t_enc.launch_count, t_dec.launch_count) == before   # no kernel ran
    dropped = int(blob["n_dropped"].sum())
    assert int((dec != x).sum()) <= dropped


def test_wrappers_refuse_other_devices():
    cfg = tfr.FRConfig(**SMALL)
    table = BaseTable(torch.arange(6, dtype=torch.int32), torch.full((6,), 8, dtype=torch.int32))
    x = torch.zeros(2, 256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        t_enc.gbdi_encode(x, table, cfg)
    blob = {k: torch.zeros(2, 1, dtype=torch.int32, device="meta") for k in ("ptrs",)}
    with pytest.raises(ValueError, match="cuda"):
        t_dec.gbdi_decode(blob, table, cfg)


def test_resolve_backend_follows_the_device():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert ops.resolve_backend("auto", cpu) == "ref"
    assert ops.resolve_backend(None, gpu) == "kernel"
    assert ops.resolve_backend("kernel", cpu) == "kernel"   # wrapper -> plain on CPU
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.resolve_backend("ref", gpu)                      # never plain on the card
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("xla", cpu)


@pytest.mark.parametrize("backend", ["ref", "kernel", "auto"])
def test_tensor_roundtrip_matches_reference(ref, backend):
    jnp, jfr = ref.jnp, ref.fr
    kw = dict(word_bits=16, page_words=128, num_bases=6, width_set=(4, 8),
              bucket_caps=(32, 96), outlier_cap=8)
    jc, tc = jfr.FRConfig(**kw), tfr.FRConfig(**kw)
    v = np.random.default_rng(2).normal(0, 1, (5, 77)).astype(np.float32)
    t = torch.from_numpy(v).to(torch.bfloat16)
    jpages, _ = jfr.tensor_to_pages(jnp.asarray(v).astype(jnp.bfloat16), jc)
    jtable = jfr.fit_fr_bases(jpages, jc)
    ttable = interop.table_from_numpy(np.asarray(jtable.bases), np.asarray(jtable.widths),
                                     device="cpu")
    blob, meta = ops.encode_tensor(t, ttable, tc, backend)
    jblob = jfr.fr_encode(jpages, jtable, jc)
    for k in jblob:
        np.testing.assert_array_equal(blob[k].numpy(), np.asarray(jblob[k]), err_msg=k)
    back = ops.decode_tensor(blob, meta, ttable, tc, backend)
    assert back.dtype == torch.bfloat16 and back.shape == t.shape
    if int(blob["n_dropped"].sum()) == 0:
        assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_interop_blob_roundtrip():
    cfg = tfr.FRConfig(**ADAPTIVE)
    x = torch.from_numpy(_clustered(cfg, 3, 4))
    table = tfr.fit_fr_bases(x, cfg)
    blob = tfr.fr_encode(x, table, cfg)
    back = interop.blob_from_numpy(interop.blob_to_numpy(blob), device="cpu")
    assert set(back) == set(blob)
    for k in blob:
        assert back[k].dtype == torch.int32 and torch.equal(back[k], blob[k])


# ---------------------------------------------------------------------------
# on the card: kernel vs plain, bit for bit
# ---------------------------------------------------------------------------

SPILL = dict(word_bits=16, page_words=256, num_bases=3, width_set=(4, 8),
             bucket_caps=(32, 224), outlier_cap=8)


def _spill_pages(n_pages):
    rng = np.random.default_rng(11)
    x = 1000 + rng.integers(-7, 8, (n_pages, 256))
    x[:, ::9] = 20000 + rng.integers(-100, 100, (n_pages, 29))
    x[n_pages // 2:, ::2] = rng.integers(30000, 65536, (n_pages - n_pages // 2, 128))
    return (x & 0xFFFF).astype(np.int32)


# single-width v1 config with 30 bases (8-bit pointers)
V1_K30 = dict(word_bits=32, page_words=2048, delta_bits=8, num_bases=30, outlier_cap=128)
# 30 bases in 4 clusters, so several bases of a class fit one word (first
# index wins); a third of the entries carry a width outside the set (dead);
# clusters at both ends of the word range, so deltas wrap; caps below the
# page, so words spill to the wide class and overflow to outliers
TIES32 = dict(word_bits=32, page_words=2048, num_bases=30, width_set=(8, 16),
              bucket_caps=(256, 1536), outlier_cap=64)
TIES16 = dict(word_bits=16, page_words=2048, num_bases=30, width_set=(4, 8),
              bucket_caps=(256, 1536), outlier_cap=64)
# every width class (the encode's three-register build of the fits)
FIVE = dict(word_bits=32, page_words=1024, num_bases=10, width_set=(1, 2, 4, 8, 16),
            bucket_caps=(32, 32, 64, 128, 512), outlier_cap=32)


def ladder_pages(cfg, n_pages, seed):
    """(x, bases, widths): two centers, each with one base per width class,
    and words whose deltas spread evenly over the classes' spans, so every
    class has demand and caps below it spill words down the whole chain."""
    rng = np.random.default_rng(seed)
    span = 1 << cfg.word_bits
    centers = rng.integers(0, span, 2)
    bases = np.repeat(centers, cfg.num_classes)
    widths = np.tile(np.array(cfg.width_set), 2)
    halves = np.array([1 << (w - 1) for w in cfg.width_set])
    h = halves[rng.integers(0, cfg.num_classes, (n_pages, cfg.page_words))]
    w = centers[rng.integers(0, 2, h.shape)] + rng.integers(-h, h)
    w[:, ::13] = 0
    w[:, 5::31] = rng.integers(0, span, w[:, 5::31].shape)   # outliers
    to32 = lambda v: (v % span).astype(np.uint32).view(np.int32)  # noqa: E731
    return to32(w), to32(bases), widths.astype(np.int32)


def tie_pages(cfg, n_pages, seed):
    """(x int32 pages, bases, widths) of the tie / dead-entry / wrap set."""
    rng = np.random.default_rng(seed)
    bits = cfg.word_bits
    span = 1 << bits
    centers = np.array([span // 2 - 40, span // 2 + 20, span // 3, span - 60], np.int64)
    bases = centers[rng.integers(0, 4, cfg.num_bases)] + rng.integers(-6, 7, cfg.num_bases)
    bases[:4] = centers                          # every cluster has a base
    widths = rng.choice([cfg.width_set[0], cfg.width_set[1], 2], cfg.num_bases)
    widths[:4] = cfg.width_set[0]
    near = rng.integers(-5, 6, (n_pages, cfg.page_words))
    far = rng.integers(-100, 101, (n_pages, cfg.page_words))
    w = centers[rng.integers(0, 4, (n_pages, cfg.page_words))]
    w = w + np.where(rng.random((n_pages, cfg.page_words)) < 0.6, near, far)
    w[:, ::11] = 0
    w[:, 3::29] = rng.integers(0, span, w[:, 3::29].shape)   # scattered outliers
    as_int32 = lambda v: (v % span).astype(np.int64).astype(np.uint32).view(np.int32)  # noqa: E731
    if bits == 32:
        return as_int32(w), as_int32(bases), widths.astype(np.int32)
    return (w % span).astype(np.int32), (bases % span).astype(np.int32), widths.astype(np.int32)


def test_tie_set_matches_reference(ref):
    """The tie / dead-entry / wrap set: the plain encode equals the JAX
    oracle bit for bit, and the set spills, drops and holds dead entries."""
    jnp = ref.jnp
    for kw in (TIES32, TIES16):
        tc, jc = tfr.FRConfig(**kw), ref.fr.FRConfig(**kw)
        x, bases, widths = tie_pages(tc, 6, 7)
        assert (widths == 2).any()
        blob = tfr.fr_encode(torch.from_numpy(x), interop.table_from_numpy(bases, widths, device="cpu"), tc)
        jblob = ref.fr.fr_encode(jnp.asarray(x), ref.fr.BaseTable(jnp.asarray(bases), jnp.asarray(widths)), jc)
        for k in jblob:
            np.testing.assert_array_equal(blob[k].numpy(), np.asarray(jblob[k]), err_msg=k)
        assert int(blob["n_spilled"].sum()) > 0 and int(blob["n_dropped"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [SMALL, ADAPTIVE, WIDE, DEFAULT16, DEFAULT32, V1_K30, SPILL,
                                "foreign", TIES32, TIES16, FIVE],
                         ids=["small", "adaptive", "wide", "default16", "default32", "v1-k30",
                              "spill", "foreign-width", "ties-dead-wrap32", "ties-dead-wrap16",
                              "five-classes"])
def test_kernels_match_plain_on_card(cuda_device, kw):
    cfg = tfr.FRConfig(**(SMALL if kw == "foreign" else kw))
    if kw is TIES32 or kw is TIES16 or kw is FIVE:
        x, bases, widths = (ladder_pages if kw is FIVE else tie_pages)(cfg, 64, 7)
        x = torch.from_numpy(x).to(cuda_device)
        table = interop.table_from_numpy(bases, widths, device=cuda_device)
    elif kw is SPILL:
        x = torch.from_numpy(_spill_pages(64)).to(cuda_device)
        table = interop.table_from_numpy([1000, 1000, 20000], [4, 8, 8], device=cuda_device)
    else:
        x = torch.from_numpy(_clustered(cfg, 64, 1)).to(cuda_device)
        table = tfr.fit_fr_bases(x, cfg)
    if kw == "foreign":   # a base whose width is outside the width set is dead
        table = BaseTable(table.bases, table.widths.clone().index_fill_(0, torch.tensor(
            [0, 3], device=cuda_device), 5))
    n_enc = t_enc.launch_count
    blob = t_enc.gbdi_encode(x, table, cfg)
    plain = t_enc.gbdi_encode_plain(x, table, cfg)
    torch.cuda.synchronize()
    assert t_enc.launch_count == n_enc + 1
    assert set(blob) == set(plain)
    for k in blob:
        assert torch.equal(blob[k], plain[k]), k
    if kw is SPILL or kw is TIES32 or kw is TIES16 or kw is FIVE:
        assert int(plain["n_spilled"].sum()) > 0 and int(plain["n_dropped"].sum()) > 0
    dec = t_dec.gbdi_decode(blob, table, cfg)
    torch.cuda.synchronize()
    assert torch.equal(dec, t_dec.gbdi_decode_plain(plain, table, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("page_words", [384, 1024, 4096, 8192, 16640])
def test_encode_page_sizes_on_card(cuda_device, page_words):
    """Every build of the encode by words a thread (2, 4, 16, 32 and the
    largest, 65): a few pages against the plain version, bit for bit."""
    cfg = tfr.FRConfig(word_bits=16, page_words=page_words, num_bases=4, width_set=(4, 8),
                       bucket_caps=(page_words // 8, page_words // 2), outlier_cap=32)
    x, bases, widths = ladder_pages(cfg, 3, page_words)
    x = torch.from_numpy(x).to(cuda_device)
    table = interop.table_from_numpy(bases, widths, device=cuda_device)
    blob = t_enc.gbdi_encode(x, table, cfg)
    plain = t_enc.gbdi_encode_plain(x, table, cfg)
    for k in plain:
        assert torch.equal(blob[k], plain[k]), k
    assert int(plain["n_spilled"].sum()) > 0 and int(plain["n_dropped"].sum()) > 0


@pytest.mark.cuda
def test_smem_formula_matches_kernel_source(cuda_device):
    from repro_torch.kernels import _build

    for kw in (SMALL, ADAPTIVE, DEFAULT16, DEFAULT32, TIES32):
        cfg = tfr.FRConfig(**kw)
        ip = _build.int_array(t_enc.kernel_iparams(cfg, 1))
        assert _build.load("gbdi_encode").gbdi_encode_smem_bytes(ip) == t_enc.smem_bytes(cfg)
        assert _build.load("gbdi_decode").gbdi_decode_smem_bytes(ip) == t_dec.smem_bytes(cfg)


# ---------------------------------------------------------------------------
# the decode on blobs the encoder never writes
# ---------------------------------------------------------------------------

THREE = dict(word_bits=16, page_words=512, num_bases=9, width_set=(2, 4, 8),
             bucket_caps=(64, 64, 384), outlier_cap=16)
FOUR = dict(word_bits=32, page_words=512, num_bases=9, width_set=(2, 4, 8, 16),
            bucket_caps=(32, 64, 128, 256), outlier_cap=24)
# 300 bases: 16-bit pointer codes, two lanes for a lane's four words
PTR16 = dict(word_bits=32, page_words=512, num_bases=300, width_set=(8, 16),
             bucket_caps=(64, 256), outlier_cap=32)


def handmade_blobs(cfg, n_pages, seed):
    """(blob, bases, widths): ``chip_smoke.handmade_blobs``, the generator of
    blobs the encoder never writes that the card's smoke test decodes too
    (its docstring lists what the blobs hold)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.handmade_blobs(cfg, n_pages, seed)


HANDMADE = [SMALL, WIDE, ADAPTIVE, THREE, FOUR]
HANDMADE_IDS = ["small", "wide", "adaptive", "three-classes", "four-classes"]


@pytest.mark.parametrize("kw", HANDMADE, ids=HANDMADE_IDS)
def test_decode_of_handmade_blobs_matches_reference(ref, kw):
    """The port's fr_decode (and the wrapper on the CPU) equals the JAX
    oracle fr_decode word for word on blobs the encoder never writes.  The
    oracle is the ground truth here, not the Pallas decode in interpret
    mode: that kernel differs from fr_decode on such adaptive pages (pages
    with valid profile ids 1 and 2)."""
    jnp = ref.jnp
    tc, jc = tfr.FRConfig(**kw), ref.fr.FRConfig(**kw)
    blob, bases, widths = handmade_blobs(tc, 64, tc.page_words + tc.num_classes)
    live = np.clip(blob["n_out"], 0, tc.outlier_cap)
    assert (blob["n_out"] < 0).any() and (blob["n_out"] > tc.outlier_cap).any()
    assert any((np.diff(blob["out_idx"][p, :live[p]]) <= 0).any() for p in range(64))
    if tc.num_profiles > 1:
        assert {-1, tc.num_profiles} <= set(blob["profile"].tolist())
    codes = tfr.unpack_lanes(torch.from_numpy(blob["ptrs"]), tc.ptr_bits, tc.page_words)
    assert int(codes.max()) > tc.num_bases + 1
    want = ref.fr.fr_decode({k: jnp.asarray(v) for k, v in blob.items()},
                            ref.fr.BaseTable(jnp.asarray(bases), jnp.asarray(widths)), jc)
    tblob = interop.blob_from_numpy(blob, device="cpu")
    table = interop.table_from_numpy(bases, widths, device="cpu")
    got = tfr.fr_decode(tblob, table, tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(t_dec.gbdi_decode(tblob, table, tc), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", HANDMADE + [DEFAULT16, DEFAULT32, FIVE, V1_K30, PTR16],
                         ids=HANDMADE_IDS + ["default16", "default32", "five-classes", "v1-k30",
                                             "ptr16"])
def test_decode_of_handmade_blobs_on_card(cuda_device, kw):
    """Kernel B against the plain decode, bit for bit, on the same kind of
    blobs, for every number of width classes and pointer widths 4, 8, 16."""
    cfg = tfr.FRConfig(**kw)
    blob, bases, widths = handmade_blobs(cfg, 256, 5)
    blob = interop.blob_from_numpy(blob, device=cuda_device)
    table = interop.table_from_numpy(bases, widths, device=cuda_device)
    n = t_dec.launch_count
    got = t_dec.gbdi_decode(blob, table, cfg)
    torch.cuda.synchronize()
    assert t_dec.launch_count == n + 1
    assert torch.equal(got, t_dec.gbdi_decode_plain(blob, table, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("page_words", [384, 1024, 4096, 8192, 16640])
def test_decode_page_sizes_on_card(cuda_device, page_words):
    """Pages of 3 to 130 groups of 128 words: blobs from the plain encode,
    kernel B against the plain decode, bit for bit."""
    cfg = tfr.FRConfig(word_bits=16, page_words=page_words, num_bases=4, width_set=(4, 8),
                       bucket_caps=(page_words // 8, page_words // 2), outlier_cap=32)
    x, bases, widths = ladder_pages(cfg, 3, page_words)
    table = interop.table_from_numpy(bases, widths, device=cuda_device)
    blob = t_enc.gbdi_encode_plain(torch.from_numpy(x).to(cuda_device), table, cfg)
    blob = {k: v.contiguous() for k, v in blob.items()}
    got = t_dec.gbdi_decode(blob, table, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, t_dec.gbdi_decode_plain(blob, table, cfg))
    assert int(blob["n_dropped"].sum()) > 0
