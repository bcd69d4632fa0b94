"""Decode attention over GBDI-FR pages: the port's plain version, wrapper
and budget against the JAX package's Pallas kernel (interpret mode).

On the CPU the wrapper runs the plain version; tests marked ``cuda`` launch
the hand-written kernel and hold it against the plain version on the card.
The JAX reference is imported inside the tests that need it, so the card
tests also run where JAX is absent.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import gbdi_fr as tfr
from repro_torch.kernels import _build
from repro_torch.kernels import gbdi_encode as t_enc
from repro_torch.kernels import gbdi_paged_attn as t_pa

B = 2
FR8 = dict(word_bits=16, page_words=256, num_bases=14, width_set=(8,),
           bucket_caps=(256,), outlier_cap=16)
FR48 = dict(word_bits=16, page_words=256, num_bases=14, width_set=(4, 8),
            bucket_caps=(32, 256), outlier_cap=16)
# a page with at most 128 wide-class words takes the smaller second profile
ADAPTIVE = dict(word_bits=16, page_words=256, num_bases=14, width_set=(4, 8),
                cap_profiles=((32, 256), (32, 128)), outlier_cap=16)
# heads whose float32 scale 1/sqrtf(hd) differs from a double 1/sqrt(hd)
# rounded to float32 (hd 96), and wider than one 256-channel chunk (hd 512)
HD96 = dict(word_bits=16, page_words=384, num_bases=14, width_set=(8,),
            bucket_caps=(384,), outlier_cap=16)
HD512 = dict(word_bits=16, page_words=2048, num_bases=14, width_set=(8,),
             bucket_caps=(2048,), outlier_cap=64)
# (fr, n_kv, hd, groups, slots): page_tokens = page_words // (n_kv * hd)
GEOMS = [
    (FR8, 2, 64, 2, 5),     # pt 2
    (FR48, 1, 64, 4, 4),    # pt 4
    (FR8, 2, 128, 3, 6),    # pt 1
    (FR48, 4, 16, 2, 3),    # pt 4, narrow heads
    (HD96, 1, 96, 2, 5),    # pt 4
    (HD512, 1, 512, 2, 3),  # pt 4, two channel chunks
]
GEOM_IDS = ["pt2", "pt4-multiwidth", "pt1", "pt4-hd16", "hd96", "hd512"]
LLAMA405B = dict(n_kv=8, hd=128, groups=16)   # the serving path's attention layer


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (the test skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import gbdi_fr
    from repro.kernels import gbdi_paged_attn

    return SimpleNamespace(jnp=jnp, fr=gbdi_fr, pa=gbdi_paged_attn)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def kv_words(rng, n_tok, n_kv, hd, sparse=False):
    """Channel-structured bf16 K/V (per-channel mean N(0,1)*2 + N(0, 0.1))
    as uint16 words, (B, n_tok, n_kv, hd); ``sparse`` zeroes half the
    channels of the first half of the tokens (so adaptive pages differ)."""
    ch = rng.normal(0, 1, (1, 1, n_kv, hd)) * 2
    x = ch + rng.normal(0, 0.1, (B, n_tok, n_kv, hd))
    if sparse:
        x[:, :n_tok // 2, :, ::2] = 0
    return tfr.bf16_to_words(torch.from_numpy(x.astype(np.float32))).numpy().astype(np.uint16)


def make_pages(ref, fr_kw, n_kv, hd, slots, seed):
    """K and V page slots (B, slots, ...) encoded by the JAX oracle, the
    JAX-fitted table, and the port's config."""
    jnp = ref.jnp
    jcfg, tcfg = ref.fr.FRConfig(**fr_kw), tfr.FRConfig(**fr_kw)
    pt = tcfg.page_words // (n_kv * hd)
    rng = np.random.default_rng(seed)
    kw, vw = kv_words(rng, slots * pt, n_kv, hd), kv_words(rng, slots * pt, n_kv, hd)
    table = ref.fr.fit_fr_bases(jnp.asarray(np.concatenate([kw, vw]).astype(np.int32).reshape(-1)), jcfg)

    def pages(w):
        blob = ref.fr.fr_encode(jnp.asarray(w.astype(np.int32).reshape(-1, tcfg.page_words)), table, jcfg)
        return {k: np.asarray(v).reshape((B, slots) + v.shape[1:]) for k, v in blob.items()
                if k not in ("n_spilled", "n_dropped")}

    return SimpleNamespace(jcfg=jcfg, cfg=tcfg, table=table, k=pages(kw), v=pages(vw), pt=pt,
                           ttable=interop.table_from_numpy(np.asarray(table.bases),
                                                           np.asarray(table.widths), device="cpu"))


def assert_state_close(got, want):
    """(acc, m, l): rtol 1e-5 / atol 1e-6 on acc/l and l, atol 1e-5 on m (float32
    sums in another order); where nothing is valid, l = 0 and acc = 0 exactly."""
    acc, m, l = (np.asarray(t, dtype=np.float32) for t in got)
    jacc, jm, jl = (np.asarray(t, dtype=np.float32) for t in want)
    np.testing.assert_allclose(m, jm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-6)
    empty = jl == 0
    assert (l[empty] == 0).all() and (acc[empty] == 0).all()
    live = ~empty
    np.testing.assert_allclose(acc[live] / l[live][:, None], jacc[live] / jl[live][:, None],
                               rtol=1e-5, atol=1e-6)


def test_merge_softmax_matches_reference(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(0)
    acc1, acc2 = rng.normal(0, 1, (2, 3, 4, 8)).astype(np.float32)
    m1, m2 = rng.normal(0, 3, (2, 3, 4)).astype(np.float32)
    l1, l2 = rng.uniform(0.5, 4, (2, 3, 4)).astype(np.float32)
    m2[0] = t_pa.MASKED    # an empty stream merges as nothing
    l2[0], acc2[0] = 0, 0
    want = ref.pa.merge_softmax(*(jnp.asarray(a) for a in (acc1, m1, l1, acc2, m2, l2)))
    got = t_pa.merge_softmax(*(torch.from_numpy(a) for a in (acc1, m1, l1, acc2, m2, l2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[0][0].numpy(), acc1[0])


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
def test_plain_matches_pallas_interpret(ref, geom):
    fr_kw, n_kv, hd, groups, slots = geom
    jnp = ref.jnp
    d = make_pages(ref, fr_kw, n_kv, hd, slots, seed=n_kv * hd + groups)
    q = np.random.default_rng(1).normal(0, 1, (B, n_kv, groups, hd)).astype(np.float32)
    n_tok = slots * d.pt
    for pos in sorted({n_tok - 1, n_tok // 2, d.pt, d.pt - 1, 0}):
        want = ref.pa.paged_attention_decode(
            jnp.asarray(q), {k: jnp.asarray(v) for k, v in d.k.items()},
            {k: jnp.asarray(v) for k, v in d.v.items()}, d.table, jnp.int32(pos), d.jcfg,
            n_kv=n_kv, hd=hd, groups=groups, interpret=True)
        got = t_pa.paged_attention_decode_plain(
            torch.from_numpy(q), interop.blob_from_numpy(d.k, device="cpu"),
            interop.blob_from_numpy(d.v, device="cpu"),
            d.ttable, pos, d.cfg, n_kv=n_kv, hd=hd, groups=groups, chunk_slots=2)
        assert_state_close(got, want)
        if pos < d.pt:     # every page masked
            assert (got[1] == t_pa.MASKED).all() and (got[2] == 0).all() and (got[0] == 0).all()


def test_plain_scale_is_float32_inv_sqrt():
    """The plain path scales its scores by 1/sqrt(hd) formed in float32, as
    the reference and the kernel do: with one key of 1.0 on channel 0 and a
    query of 1.0 there, the running max m is that scale, bit for bit, for
    every head dim 1..512 (a double 1/sqrt rounded to float32 misses at 151
    of them)."""
    for hd in range(1, 513):
        want = np.float32(1) / np.sqrt(np.float32(hd))
        pw = int(np.lcm(hd, 128))
        cfg = tfr.FRConfig(word_bits=16, page_words=pw, num_bases=1, width_set=(8,),
                           bucket_caps=(pw,), outlier_cap=8)
        words = torch.zeros(1, pw, dtype=torch.int32)
        words[0, 0] = 0x3F80                                  # bf16 1.0, token 0 channel 0
        table = interop.table_from_numpy([0x3F80], [8], device="cpu")
        blob = {k: v[None] for k, v in tfr.fr_encode(words, table, cfg).items()}
        q = torch.zeros(1, 1, 1, hd)
        q[..., 0] = 1.0
        pt = pw // hd
        _, m, l = t_pa.paged_attention_decode_plain(q, blob, blob, table, pt, cfg,
                                                    n_kv=1, hd=hd, groups=1)
        assert m.numpy().reshape(()).tobytes() == want.tobytes(), hd
        assert float(l) >= 1.0
    for hd in range(1, 513):    # the helper the kernel-side paths share
        want = np.float32(1) / np.sqrt(np.float32(hd))
        assert t_pa.inv_sqrt(hd, "cpu").numpy().tobytes() == want.tobytes(), hd


def test_wrapper_on_cpu_runs_the_plain_version(ref):
    fr_kw, n_kv, hd, groups, slots = GEOMS[0]
    d = make_pages(ref, fr_kw, n_kv, hd, slots, seed=3)
    q = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (B, n_kv, groups, hd)).astype(np.float32))
    args = (q, interop.blob_from_numpy(d.k, device="cpu"), interop.blob_from_numpy(d.v, device="cpu"),
            d.ttable, 7, d.cfg)
    before = t_pa.launch_count
    got = t_pa.paged_attention_decode(*args, n_kv=n_kv, hd=hd, groups=groups)
    want = t_pa.paged_attention_decode_plain(*args, n_kv=n_kv, hd=hd, groups=groups)
    assert t_pa.launch_count == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_reads_adaptive_pages():
    """Adaptive pages have no Pallas reference: hold the plain version to
    attention over the fr_decode'd words, computed here directly."""
    cfg = tfr.FRConfig(**ADAPTIVE)
    n_kv, hd, groups, slots = 2, 64, 2, 4
    pt = cfg.page_words // (n_kv * hd)
    rng = np.random.default_rng(5)
    kw, vw = (torch.from_numpy(kv_words(rng, slots * pt, n_kv, hd, sparse=True).astype(np.int32))
              for _ in "kv")
    table = tfr.fit_fr_bases(torch.cat([kw, vw]).reshape(-1), cfg)

    def pages(w):
        blob = tfr.fr_encode(w.reshape(-1, cfg.page_words), table, cfg)
        return {k: v.reshape((B, slots) + v.shape[1:]) for k, v in blob.items()}

    pk, pv = pages(kw), pages(vw)
    assert len(set(pk["profile"].flatten().tolist() + pv["profile"].flatten().tolist())) > 1
    q = torch.from_numpy(rng.normal(0, 1, (B, n_kv, groups, hd)).astype(np.float32))
    pos = slots * pt - 1
    acc, m, l = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, n_kv=n_kv, hd=hd,
                                            groups=groups)

    def decoded(p):
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in p.items()}
        return tfr.words_to_bf16(tfr.fr_decode(flat, table, cfg)).float().reshape(B, -1, n_kv, hd)

    K, V = decoded(pk)[:, :(pos // pt) * pt], decoded(pv)[:, :(pos // pt) * pt]
    logits = torch.einsum("bkgh,btkh->bkgt", q, K) / np.sqrt(hd)
    probs = torch.softmax(logits, dim=-1)
    want = torch.einsum("bkgt,btkh->bkgh", probs, V)
    torch.testing.assert_close(acc / l[..., None], want, rtol=1e-5, atol=1e-6)


def test_geometry_and_device_errors():
    cfg = tfr.FRConfig(**FR8)
    pages = {k: torch.zeros(B, 2, 1, dtype=torch.int32) for k in ("ptrs",)}
    q = torch.zeros(B, 3, 1, 64)
    with pytest.raises(ValueError, match="whole number"):   # 256 % (3 * 64) != 0
        t_pa.paged_attention_decode(q, pages, pages, [0], 3, cfg, n_kv=3, hd=64, groups=1)
    with pytest.raises(ValueError, match="whole number"):   # a row wider than a page
        t_pa.page_tokens(cfg, 4, 128)
    meta = {"ptrs": torch.zeros(B, 2, 1, dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="cuda"):
        t_pa.paged_attention_decode(q[:, :2], meta, meta, [0], 3, cfg, n_kv=2, hd=64, groups=1)


KV_FR = dict(word_bits=16, page_words=2048, num_bases=14, width_set=(8,),
             bucket_caps=(2048,), outlier_cap=64)
ADAPTIVE_2048 = dict(word_bits=16, page_words=2048, num_bases=14, width_set=(4, 8),
                     cap_profiles=((192, 1856), (64, 1024)), outlier_cap=64)


def test_smem_budget_check():
    """The shared-memory check stands where the VMEM check stood, and picks
    the pass size: the serving path's Llama-3-405B layer fits up to 7 page
    slots a pass and takes 4 (8 tokens, one whole tile); rows past one
    block's 128 go to a second row chunk of the same size; a page too large
    for even one slot a pass raises."""
    kv = tfr.FRConfig(**KV_FR)
    need = t_pa.smem_bytes(kv, **LLAMA405B)
    assert need == 162352 <= t_enc.SMEM_LIMIT_BYTES
    assert t_pa.check_smem(kv, **LLAMA405B) == t_pa.pass_slots(kv, **LLAMA405B) == 4
    assert t_pa.smem_bytes(kv, **LLAMA405B, n_slots=7) == 230704 <= t_enc.SMEM_LIMIT_BYTES
    assert t_pa.smem_bytes(kv, **LLAMA405B, n_slots=8) > t_enc.SMEM_LIMIT_BYTES
    assert t_pa.check_smem(kv, n_kv=8, hd=128, groups=6) == 8           # Mixtral-8x22B
    assert t_pa.chunk_rows(8 * 32, 128) == 128
    assert t_pa.smem_bytes(kv, n_kv=8, hd=128, groups=32) == need
    big = tfr.FRConfig(word_bits=16, page_words=32768, num_bases=14, width_set=(8,),
                       bucket_caps=(32768,), outlier_cap=64)
    assert t_pa.pass_slots(big, **LLAMA405B) == 0
    assert t_pa.smem_bytes(big, **LLAMA405B, n_slots=1) > t_enc.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        t_pa.check_smem(big, **LLAMA405B)


# the five shapes the chip smoke test holds kernel C to: (fr, n_kv, hd, groups,
# pass size, page tokens)
PHASE5 = {
    "llama3-405b": (KV_FR, 8, 128, 16, 4, 2),
    "mixtral-8x22b": (KV_FR, 8, 128, 6, 8, 2),
    "4-token-pages": (KV_FR, 4, 128, 8, 8, 4),
    "adaptive": (ADAPTIVE_2048, 8, 128, 4, 8, 2),
    "small-page": (FR8, 2, 64, 2, 8, 2),
}


@pytest.mark.parametrize("case", list(PHASE5))
def test_pass_slots_at_phase5_shapes(case):
    fr_kw, n_kv, hd, groups, want, pt = PHASE5[case]
    cfg = tfr.FRConfig(**fr_kw)
    geom = dict(n_kv=n_kv, hd=hd, groups=groups)
    n = t_pa.pass_slots(cfg, **geom)
    assert n == want and t_pa.page_tokens(cfg, n_kv, hd) == pt
    assert t_pa.smem_bytes(cfg, **geom) == t_pa.smem_bytes(cfg, **geom, n_slots=n) <= t_enc.SMEM_LIMIT_BYTES
    assert (n * pt) % t_pa.TILE_TOKENS == 0        # whole 8-token tiles
    ip = t_pa.attn_iparams(cfg, **geom)
    assert ip[-1] == n and ip[-2] == pt


@pytest.mark.parametrize("kg,hd,rows", [
    (128, 128, 128), (256, 128, 128), (48, 128, 48), (32, 64, 32), (512, 64, 256),
    (1000, 32, 512), (64, 256, 16), (8, 200, 8), (16, 16, 16),
])
def test_chunk_rows(kg, hd, rows):
    """A block holds 16 warps of 32 / channels-per-lane rows (1 at 8 channels
    a lane); more rows take further chunks of the same size."""
    assert t_pa.chunk_rows(kg, hd) == rows


def test_pass_slots_fall_as_groups_grow():
    kv = tfr.FRConfig(**KV_FR)
    ns = [t_pa.pass_slots(kv, n_kv=8, hd=128, groups=g) for g in (1, 2, 4, 8, 12, 16)]
    assert ns == sorted(ns, reverse=True) and ns[0] == 8 and ns[-1] == 4
    sizes = [t_pa.smem_bytes(kv, n_kv=8, hd=128, groups=g, n_slots=4) for g in (1, 2, 4, 8, 16)]
    assert sizes == sorted(sizes) and len(set(sizes)) == len(sizes)


@pytest.mark.parametrize("n_valid,batch,pass_n", [
    (0, 8, 4), (1, 8, 4), (3, 2, 4), (4, 2, 8), (5, 2, 4), (7, 1, 4), (13, 3, 8),
    (101, 2, 4), (4095, 2, 8), (16383, 8, 4), (16383, 1, 4),
], ids=lambda v: str(v))
def test_splits_cover_n_valid(n_valid, batch, pass_n):
    """No empty split, the splits cover n_valid exactly, and a run is a whole
    number of passes whenever n_valid holds one."""
    splits, run = t_pa._splits(n_valid, batch, sms=132, per_sm=1, pass_n=pass_n)
    assert splits >= 1 and run >= 1
    if n_valid == 0:
        assert splits == 1
        return
    assert (splits - 1) * run < n_valid <= splits * run
    assert run % pass_n == 0
    if n_valid >= pass_n * 132 * 2:
        assert splits * batch >= 132 // 2       # the grid fills the card


def test_splits_fill_whole_waves():
    """At the serving shape the grid is two whole waves of the 132 SMs."""
    assert t_pa._splits(16383, 8, sms=132, per_sm=1, pass_n=4) == (33, 500)
    splits, run = t_pa._splits(16383, 8, sms=132, per_sm=2, pass_n=4)
    assert (splits * 8) % 264 <= 8 and (splits - 1) * run < 16383 <= splits * run
    splits, _ = t_pa._splits(16383, 2, sms=132, per_sm=1, pass_n=4, chunks=2)
    assert splits * 2 * 2 <= 132 * t_pa.MAX_WAVES


@pytest.mark.parametrize("bad", ["word_bits=32", "hd=512"])
def test_wrapper_raises_outside_kernel_geometry(bad):
    """The kernel reads only bf16 pages, and both paths refuse the rest, so
    the CPU answers as the card would; a head wider than 256 channels is
    inside the geometry (the kernel splits it into channel chunks), and both
    entry points take it on the CPU as the plain version."""
    if bad == "word_bits=32":
        cfg = tfr.FRConfig(word_bits=32, page_words=256, num_bases=14, width_set=(8, 16),
                           bucket_caps=(64, 192), outlier_cap=16)
        n_kv, hd = 2, 64
        pages = {"ptrs": torch.zeros(B, 2, 1, dtype=torch.int32)}
        q = torch.zeros(B, n_kv, 1, hd)
        with pytest.raises(ValueError, match="16-bit"):
            t_pa.paged_attention_decode(q, pages, pages, [0], 3, cfg, n_kv=n_kv, hd=hd, groups=1)
        with pytest.raises(ValueError, match="16-bit"):
            t_pa.decode_pages(pages, pages, [0], 1, cfg, n_kv=n_kv, hd=hd, groups=1)
        return
    cfg = tfr.FRConfig(word_bits=16, page_words=1024, num_bases=14, width_set=(8,),
                       bucket_caps=(1024,), outlier_cap=16)
    n_kv, hd, groups, slots = 1, 512, 2, 3
    assert t_pa.channel_chunks(hd) == 2 and t_pa.check_smem(cfg, n_kv=n_kv, hd=hd, groups=groups) >= 1
    pk, pv, table, pt = _card_pages(cfg, n_kv, hd, slots, torch.device("cpu"), seed=4)
    q = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (B, n_kv, groups, hd)).astype(np.float32))
    pos = slots * pt - 1
    got = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, n_kv=n_kv, hd=hd, groups=groups)
    want = t_pa.paged_attention_decode_plain(q, pk, pv, table, pos, cfg, n_kv=n_kv, hd=hd,
                                             groups=groups)
    assert got[0].shape == (B, n_kv, groups, hd) and bool(got[2].gt(0).all())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    k, v = t_pa.decode_pages(pk, pv, table, slots, cfg, n_kv=n_kv, hd=hd, groups=groups)
    assert k.shape == v.shape == (B, slots, cfg.page_words)


def test_decode_pages_on_cpu_is_fr_decode():
    """On the CPU the pass decode's entry point gives fr_decode's words of the
    first n_valid slots of every batch row."""
    cfg = tfr.FRConfig(**ADAPTIVE)
    n_kv, hd, groups, slots = 2, 64, 2, 5
    pk, pv, table, _ = _card_pages(cfg, n_kv, hd, slots, torch.device("cpu"), seed=9)
    before = t_pa.launch_count
    k, v = t_pa.decode_pages(pk, pv, table, 3, cfg, n_kv=n_kv, hd=hd, groups=groups)
    assert t_pa.launch_count == before
    for got, pages in ((k, pk), (v, pv)):
        assert got.shape == (B, 3, cfg.page_words) and got.dtype == torch.int32
        for b in range(B):
            want = tfr.fr_decode({key: t[b, :3] for key, t in pages.items()}, table, cfg)
            assert torch.equal(got[b], want)


# ---------------------------------------------------------------------------
# on the card: kernel vs plain
# ---------------------------------------------------------------------------

def _card_pages(cfg, n_kv, hd, slots, dev, seed):
    pt = cfg.page_words // (n_kv * hd)
    rng = np.random.default_rng(seed)
    sparse = cfg.num_profiles > 1
    kw, vw = (torch.from_numpy(kv_words(rng, slots * pt, n_kv, hd, sparse).astype(np.int32)).to(dev)
              for _ in "kv")
    table = tfr.fit_fr_bases(torch.cat([kw, vw]).reshape(-1), cfg)

    def pages(w):
        blob = tfr.fr_encode(w.reshape(-1, cfg.page_words), table, cfg)
        return {k: v.reshape((B, slots) + v.shape[1:]).contiguous() for k, v in blob.items()
                if k not in ("n_spilled", "n_dropped")}

    return pages(kw), pages(vw), table, pt


def _single_width(page_words):
    return dict(word_bits=16, page_words=page_words, num_bases=14, width_set=(8,),
                bucket_caps=(page_words,), outlier_cap=16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pt2", "pt4", "pt1", "adaptive", "llama405b",
                                  "hd256", "hd32", "hd80", "hd33", "hd512", "hd384"])
def test_kernel_matches_plain_on_card(cuda_device, case):
    """Every channels-per-lane build of the kernel (hd 32, 64, 80 and 128,
    256), the odd-hd path (no channel pairs), a page of 32 tokens, and heads
    split into two channel chunks (hd 512, and hd 384 with a half chunk)."""
    cfg = tfr.FRConfig(**{"adaptive": ADAPTIVE, "pt4": FR48, "llama405b": KV_FR,
                          "hd256": KV_FR, "hd80": _single_width(640),
                          "hd33": _single_width(4224), "hd512": KV_FR,
                          "hd384": _single_width(1536)}.get(case, FR8))
    n_kv, hd, groups, slots = {"pt2": (2, 64, 2, 37), "pt4": (1, 64, 4, 40),
                               "pt1": (2, 128, 3, 50), "adaptive": (2, 64, 2, 33),
                               "llama405b": (8, 128, 16, 64), "hd256": (4, 256, 4, 21),
                               "hd32": (2, 32, 8, 30), "hd80": (1, 80, 3, 25),
                               "hd33": (1, 33, 2, 6), "hd512": (1, 512, 8, 27),
                               "hd384": (1, 384, 3, 19)}[case]
    pk, pv, table, pt = _card_pages(cfg, n_kv, hd, slots, cuda_device, seed=slots)
    q = torch.randn(B, n_kv, groups, hd, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    for pos in (slots * pt - 1, slots * pt // 3, pt - 1):
        n0 = t_pa.launch_count
        got = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, n_kv=n_kv, hd=hd,
                                          groups=groups)
        torch.cuda.synchronize()
        assert t_pa.launch_count == n0 + 1
        want = t_pa.paged_attention_decode_plain(q, pk, pv, table, pos, cfg, n_kv=n_kv,
                                                 hd=hd, groups=groups)
        if pos < pt:
            assert (got[1] == t_pa.MASKED).all() and (got[2] == 0).all() and (got[0] == 0).all()
        assert_state_close([t.cpu() for t in got], [t.cpu() for t in want])


@pytest.mark.cuda
def test_smem_formula_matches_kernel_source(cuda_device):
    """The wrapper's shared-memory formula equals the kernel source's at every
    pass size, and the runtime holds at least one block per SM."""
    lib = t_pa._lib()
    for kw, geom in ((FR8, dict(n_kv=2, hd=64, groups=2)), (ADAPTIVE, dict(n_kv=1, hd=64, groups=4)),
                     (KV_FR, LLAMA405B), (KV_FR, dict(n_kv=8, hd=128, groups=32)),
                     (ADAPTIVE_2048, dict(n_kv=8, hd=128, groups=4)),
                     (KV_FR, dict(n_kv=1, hd=512, groups=8))):
        cfg = tfr.FRConfig(**kw)
        for n in range(1, t_pa.MAX_PASS_SLOTS + 1):
            ip = _build.int_array(t_pa.attn_iparams(cfg, **geom, pass_n=n))
            assert lib.gbdi_paged_attn_smem_bytes(ip) == t_pa.smem_bytes(cfg, **geom, n_slots=n)
        assert t_pa._blocks_per_sm(cfg, geom["n_kv"], geom["hd"], geom["groups"], 0) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PHASE5))
def test_pass_decode_matches_decode_kernel(cuda_device, case):
    """The kernel's batched pass decode gives the decode kernel's words bit for
    bit on every page slot, adaptive profiles included, at a count of slots
    that leaves a short last pass."""
    from repro_torch.kernels import gbdi_decode as t_dec

    fr_kw, n_kv, hd, groups, n, pt = PHASE5[case]
    cfg = tfr.FRConfig(**fr_kw)
    slots = 5 * n + 3
    pk, pv, table, _ = _card_pages(cfg, n_kv, hd, slots, cuda_device, seed=slots + n_kv)
    for n_valid in (slots, slots - 1, n - 1, 1):
        k, v = t_pa.decode_pages(pk, pv, table, n_valid, cfg, n_kv=n_kv, hd=hd, groups=groups)
        for got, pages in ((k, pk), (v, pv)):
            flat = {key: t[:, :n_valid].reshape((B * n_valid,) + t.shape[2:]).contiguous()
                    for key, t in pages.items()}
            want = t_dec.gbdi_decode(flat, table, cfg).reshape(B, n_valid, cfg.page_words)
            assert torch.equal(got, want), f"{int((got != want).sum())} words differ"
