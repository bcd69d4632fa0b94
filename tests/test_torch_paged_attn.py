"""Decode attention over GBDI-FR pages: the port's plain version, wrapper
and budget against the JAX package's Pallas kernel (interpret mode).

On the CPU the wrapper runs the plain version; tests marked ``cuda`` launch
the hand-written kernel and hold it against the plain version on the card.
The JAX reference is imported inside the tests that need it, so the card
tests also run where JAX is absent.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop, obs
from repro_torch.core import gbdi_fr as tfr
from repro_torch.kernels import _build
from repro_torch.kernels import gbdi_encode as t_enc
from repro_torch.kernels import gbdi_paged_attn as t_pa


def _launches(kernel: str) -> int:
    """Launches of a kernel counted so far (``encode``, ``decode``, ``attn``)."""
    return obs.snapshot(spans=False)["counters"][f"launches.{kernel}"]


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
    the reference and the kernel do, and takes it from ``inv_sqrt``: that
    helper is held bit for bit at every head dim 1..512 (a double 1/sqrt
    rounded to float32 misses at 151 of them).  With one key of 1.0 on
    channel 0 and a query of 1.0 there, the plain path's running max m is
    that scale, bit for bit, at every head dim where the double misses and a
    page of lcm(hd, 128) words is at most 4,096 words, and at 64 and 128."""
    misses = [hd for hd in range(1, 513)
              if np.float32(1 / math.sqrt(hd)) != np.float32(1) / np.sqrt(np.float32(hd))]
    assert len(misses) == 151
    for hd in [hd for hd in misses if np.lcm(hd, 128) <= 4096] + [64, 128]:
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
    before = _launches("attn")
    got = t_pa.paged_attention_decode(*args, n_kv=n_kv, hd=hd, groups=groups)
    want = t_pa.paged_attention_decode_plain(*args, n_kv=n_kv, hd=hd, groups=groups)
    assert _launches("attn") == before
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
    # a row of two pages, two heads a page: one token a slot, two slots a row
    assert t_pa.page_tokens(cfg, 4, 128) == 1 and t_pa.attn_layout(cfg, 4, 128) == (1, 2)
    for n_kv, hd in ((3, 64), (3, 128), (1, 512)):   # neither way whole, or a head over two pages
        with pytest.raises(ValueError, match="whole number"):
            t_pa.attn_layout(cfg, n_kv, hd)
    # the cache lays a 512-word head over two slots; only the attention needs whole heads
    from repro_torch.serving import kv_cache as tkv

    spec = tkv.KVSpec(1, 512, max_len=8, fr=cfg)
    assert tfr.page_layout(cfg, 512) == (1, 2) == (spec.page_tokens, spec.pages_per_row)
    meta ={"ptrs": torch.zeros(B, 2, 1, dtype=torch.int32, device="meta")}
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
    "deepseek-7b": (KV_FR, 32, 128, 1, 8, 1),     # a row over two page slots
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


#: (fr, n_kv, hd, groups, pass tokens or None for pass_slots x page_tokens, ts)
TOKEN_SLICES = {
    "mixtral-trinity-cell": (KV_FR, 1, 128, 6, None, 16),   # one chip's share, G 6
    "musicgen": (KV_FR, 32, 64, 1, None, 1),                # a pass is one tile
    "llama405b-serving": (KV_FR, 8, 128, 16, None, 1),      # 128 rows fill the block
    "paligemma-hd256": (KV_FR, 1, 256, 8, None, 2),         # one row a warp at 8 channels a lane
    "hd512": (KV_FR, 1, 512, 8, None, 1),                   # channel chunks: never sliced
    "mixtral-8kv": (KV_FR, 8, 128, 6, None, 2),             # 48 rows, 6 a warp at ts 2
    "short-pass": (KV_FR, 1, 128, 6, 24, 2),                # 3 tiles bound ts
    "one-tile": (KV_FR, 1, 128, 6, 8, 1),
}


@pytest.mark.parametrize("case", list(TOKEN_SLICES))
def test_token_slices(case):
    """ts is the largest power of two up to 16 that the pass's 8-token tiles
    and the rows a warp may own allow; each slice's warps still cover every
    row of the block."""
    fr_kw, n_kv, hd, groups, tokens, want = TOKEN_SLICES[case]
    cfg = tfr.FRConfig(**fr_kw)
    if tokens is None:
        tokens = t_pa.pass_slots(cfg, n_kv=n_kv, hd=hd, groups=groups) * t_pa.page_tokens(cfg, n_kv, hd)
    ts = t_pa.token_slices(n_kv * groups, hd, tokens)
    assert ts == want
    rows = t_pa.chunk_rows(n_kv * groups, hd)
    per_warp = -(-rows * ts // t_pa.ATTN_WARPS)
    assert per_warp * (t_pa.ATTN_WARPS // ts) >= rows
    assert ts <= -(-tokens // t_pa.TILE_TOKENS) or ts == 1


@pytest.mark.parametrize("geom", [(1, 128, 6), (32, 64, 1)], ids=["g6-hd128", "g1-hd64"])
def test_pass_slots_stay_at_the_decode_cells(geom):
    """The slices' state costs no pass slot at the benchmark's decode cells:
    8 slots a pass, in one block an SM's shared memory."""
    n_kv, hd, groups = geom
    kv = tfr.FRConfig(**KV_FR)
    assert t_pa.pass_slots(kv, n_kv=n_kv, hd=hd, groups=groups) == 8
    assert t_pa.smem_bytes(kv, n_kv=n_kv, hd=hd, groups=groups) <= t_enc.SMEM_LIMIT_BYTES


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
    before = _launches("attn")
    k, v = t_pa.decode_pages(pk, pv, table, 3, cfg, n_kv=n_kv, hd=hd, groups=groups)
    assert _launches("attn") == before
    for got, pages in ((k, pk), (v, pv)):
        assert got.shape == (B, 3, cfg.page_words) and got.dtype == torch.int32
        for b in range(B):
            want = tfr.fr_decode({key: t[b, :3] for key, t in pages.items()}, table, cfg)
            assert torch.equal(got[b], want)


def _prep_counts() -> tuple[int, int]:
    info = t_enc.table_cache_info()
    return info["hits"], info["misses"]


def test_attention_table_is_the_prep_memo_entry():
    """C's wrapper takes its padded table and meta from the memo A and B use:
    a repeat call with the same table is one hit and hands back the same
    tensors; an in-place write to the bases bumps their version and misses,
    and the new entry holds the new values."""
    cfg = tfr.FRConfig(**FR48)
    cpu = torch.device("cpu")
    table = interop.table_from_numpy(np.arange(14) * 37, [4, 8] * 7, device="cpu")
    hits, misses = _prep_counts()
    prep, ptrs = t_pa._table_ptrs(table, cfg, cpu)
    assert _prep_counts() == (hits, misses + 1)
    assert prep is t_enc.prepare_table(table, cfg, cpu)
    assert ptrs == [prep.bases.data_ptr(), prep.cls.data_ptr(), prep.meta.data_ptr()]
    pad_bases, pad_cls = t_enc.pad_table(table, cfg)
    assert torch.equal(prep.bases, pad_bases.reshape(-1))
    assert torch.equal(prep.cls, pad_cls.reshape(-1))
    assert torch.equal(prep.meta, t_enc.kernel_meta(cfg, cpu))
    hits, misses = _prep_counts()
    again, ptrs_again = t_pa._table_ptrs(table, cfg, cpu)
    assert _prep_counts() == (hits + 1, misses)
    assert again is prep and ptrs_again == ptrs
    assert t_pa._table_ptrs(prep, cfg, cpu)[0] is prep
    table.bases[3] = 1234                      # an in-place write: a new version
    new, _ = t_pa._table_ptrs(table, cfg, cpu)
    assert _prep_counts() == (hits + 1, misses + 1)
    assert new is not prep and int(new.bases[3]) == 1234 and int(prep.bases[3]) == 3 * 37


def test_prepared_table_gives_the_same_state_on_cpu():
    """The wrapper, its plain version and the pass decode's entry point give
    bit-identical results for a BaseTable and for its PreparedTable."""
    cfg = tfr.FRConfig(**ADAPTIVE)
    n_kv, hd, groups, slots = 2, 64, 2, 4
    pk, pv, table, pt = _card_pages(cfg, n_kv, hd, slots, torch.device("cpu"), seed=11)
    prep = t_enc.prepare_table(table, cfg, torch.device("cpu"))
    q = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (B, n_kv, groups, hd))
                         .astype(np.float32))
    geom = dict(n_kv=n_kv, hd=hd, groups=groups)
    for pos in (slots * pt - 1, pt + 1):
        want = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
        for got in (t_pa.paged_attention_decode(q, pk, pv, prep, pos, cfg, **geom),
                    t_pa.paged_attention_decode_plain(q, pk, pv, prep, pos, cfg, **geom)):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    for g, w in zip(t_pa.decode_pages(pk, pv, prep, slots, cfg, **geom),
                    t_pa.decode_pages(pk, pv, table, slots, cfg, **geom)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("hd", [32, 64, 96, 112, 128, 256, 267, 384, 512])
def test_inv_sqrt_is_memoised_float32(hd):
    """inv_sqrt keeps its float32 bits and hands back one tensor per device."""
    want = np.float32(1) / np.sqrt(np.float32(hd))
    got = t_pa.inv_sqrt(hd, "cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == want.tobytes()
    assert t_pa.inv_sqrt(hd, "cpu") is got
    assert t_pa.inv_sqrt(hd, torch.device("cpu")) is got


def _tail_ring(pt, n_kv, hd, dev, seed):
    """A raw tail ring (B, pt, n_kv, hd) bf16 of K or V rows; its slots past
    the position hold earlier tokens, which the merge must mask."""
    gen = torch.Generator(dev).manual_seed(seed)
    return (2 * torch.randn(B, pt, n_kv, hd, generator=gen, device=dev)).to(torch.bfloat16)


def _eager_tail_merge(qf, state, k_tail, v_tail, pos, window):
    """The raw tail's attention and merge as ``kv_cache`` ran them after C
    before the kernel took them over, written out."""
    pt = k_tail.shape[1]
    Kt, Vt = k_tail.float(), v_tail.float()
    tok = (pos // pt) * pt + torch.arange(pt, device=qf.device)
    tail_valid = tok <= pos
    if window:
        tail_valid &= tok > pos - window
    tail = t_pa.softmax_chunk(qf, Kt, Vt, tail_valid, t_pa.inv_sqrt(qf.shape[-1], qf.device))
    accm, _, lm = t_pa.merge_softmax(*state, *tail)
    return (accm / lm[..., None]).to(k_tail.dtype)


def _tail_positions(pt, cur):
    """Positions in page ``cur`` whose tail holds 1, pt - 1 and pt tokens."""
    return sorted({cur * pt + k - 1 for k in (1, pt - 1, pt) if k >= 1})


@pytest.mark.parametrize("window", [0, 13])
def test_tail_form_on_cpu_is_the_eager_merge(window):
    """On the CPU the tail form is the pages' state then the eager tail merge,
    bit for bit, at a full layer and a window layer (a ring of 4 slots of 4
    tokens, wrapped), with the tail holding 1, pt - 1 and pt tokens and before
    the first full page; the plain twin gives the same bits, and no launch is
    counted."""
    cfg = tfr.FRConfig(**FR48)
    n_kv, hd, groups = 1, 64, 4
    cpu = torch.device("cpu")
    pt = cfg.page_words // (n_kv * hd)
    slots = -(-window // pt) if window else 9
    pk, pv, table, _ = _card_pages(cfg, n_kv, hd, slots, cpu, seed=slots)
    kt, vt = _tail_ring(pt, n_kv, hd, cpu, 1), _tail_ring(pt, n_kv, hd, cpu, 2)
    q = torch.randn(B, n_kv, groups, hd, generator=torch.Generator().manual_seed(3)) * 4
    geom = dict(n_kv=n_kv, hd=hd, groups=groups, window=window)
    before = (_launches("attn"), _launches("attn_tail"))
    for pos in [0, pt - 2] + _tail_positions(pt, 3 * slots + 1 if window else slots - 1):
        state = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
        want = _eager_tail_merge(q, state, kt, vt, pos, window)
        got = t_pa.paged_attention_decode_tail(q, pk, pv, table, pos, cfg, k_tail=kt, v_tail=vt,
                                               **geom)
        plain = t_pa.paged_attention_decode_tail_plain(q, pk, pv, table, pos, cfg, k_tail=kt,
                                                       v_tail=vt, **geom)
        assert got.shape == (B, n_kv, groups, hd) and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), pos
        assert torch.equal(plain.view(torch.int16), want.view(torch.int16)), pos
    assert (_launches("attn"), _launches("attn_tail")) == before


def test_tail_form_runs_a_given_merge():
    """A merge other than merge_softmax is run as given (eagerly): one that
    keeps the pages' state alone leaves the tail out of the output."""
    cfg = tfr.FRConfig(**FR48)
    n_kv, hd, groups, slots = 1, 64, 4, 6
    cpu = torch.device("cpu")
    pk, pv, table, pt = _card_pages(cfg, n_kv, hd, slots, cpu, seed=4)
    kt, vt = _tail_ring(pt, n_kv, hd, cpu, 5), _tail_ring(pt, n_kv, hd, cpu, 6)
    q = torch.randn(B, n_kv, groups, hd, generator=torch.Generator().manual_seed(7)) * 4
    geom = dict(n_kv=n_kv, hd=hd, groups=groups)
    pos = slots * pt - 2
    acc, m, l = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
    got = t_pa.paged_attention_decode_tail(q, pk, pv, table, pos, cfg, k_tail=kt, v_tail=vt,
                                           merge=lambda acc, m, l, *tail: (acc, m, l), **geom)
    assert torch.equal(got, (acc / l[..., None]).to(torch.bfloat16))
    full = t_pa.paged_attention_decode_tail(q, pk, pv, table, pos, cfg, k_tail=kt, v_tail=vt,
                                            **geom)
    assert not torch.equal(got, full)


# ---------------------------------------------------------------------------
# rows over several page slots (a multipage row), on the CPU
# ---------------------------------------------------------------------------

#: the tolerances of tests/test_torch_window_kv.py: the tail form rounds its
#: float32 output to bf16 (half an ulp, 2^-8 of |out|, plus float32 order);
#: the oracle also rounds the probabilities to bf16 (another 2^-8); the
#: state form is float32 against float32 in another order.  A gap is
#: |out - ref| / max(1, |ref|), as the benchmark's.
TOL_PAGED, TOL_ORACLE, TOL_STATE = 2 ** -8 + 1e-5, 2 ** -7 + 1e-5, 1e-5
#: ppr -> (page words, n_kv, hd): rows of 2 and 4 pages of 128 words, each
#: page two heads of 64
MULTIPAGE = {2: (128, 4, 64), 4: (128, 8, 64)}
#: the lean of a query toward its own token's key, as a logit (the cells' 8)
OWN_KEY_LOGIT = 8.0


def _multipage_run(ppr, groups, n_tok, seed):
    """A spec of rows over ``ppr`` page slots, seeded K/V ``(2, B, n_tok,
    Kv, hd)`` bf16 about per-channel means, their K noise, and a table."""
    from repro_torch.serving import kv_cache as tkv

    P, n_kv, hd = MULTIPAGE[ppr]
    fr = tfr.FRConfig(**_single_width(P))
    spec = tkv.KVSpec(n_kv, hd, max_len=n_tok, fr=fr)
    assert (spec.pages_per_row, spec.page_tokens) == (ppr, 1)
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(2, 1, 1, n_kv, hd, generator=g) * 2
    kv = (means + 0.1 * torch.randn(2, B, n_tok, n_kv, hd, generator=g)).to(torch.bfloat16)
    table = tfr.fit_fr_bases(tfr.bf16_to_words(kv).reshape(-1), fr)
    return SimpleNamespace(spec=spec, kv=kv, noise=kv[0].float() - means[0], table=table, g=g,
                           groups=groups)


def _multipage_query(run, pos):
    """(B, 1, Kv * G, hd) bf16: N(0, 4^2), leaning toward the key at ``pos``."""
    _, _, n_kv, hd = run.noise.shape
    q = torch.randn(B, n_kv, run.groups, hd, generator=run.g) * 4
    q += OWN_KEY_LOGIT / (0.1 ** 2 * math.sqrt(hd)) * run.noise[:, pos, :, None, :]
    return q.reshape(B, 1, n_kv * run.groups, hd).to(torch.bfloat16)


def _gap(out, ref):
    return float(((out.reshape(ref.shape).float() - ref).abs() / ref.abs().clamp_min(1.0)).max())


def _swap_head_groups(pages, ppr):
    """The page slots with head group ``j`` of every token in the slot of
    group ``j ^ 1``: a kernel whose group ``j`` read slot ``t * ppr + (1 -
    j)`` (at ppr 2) would see these."""
    S = pages["ptrs"].shape[1]
    j = torch.arange(S) % ppr
    perm = torch.arange(S) - j + (j ^ 1)
    return {k: v[:, perm] for k, v in pages.items()}


def _multipage_gaps(ppr, groups, seed, swap=False):
    """A prefix by ``extend``, then an append and every form at each later
    position, on and off the plain version's chunks of 3 tokens and the
    kernel's passes of 8: the widest gap of the tail form (``paged``) and
    of ``oracle`` from the float32 reference over [0, pos], and of the state
    form's acc / l from it over [0, pos - 1] (the pages before the tail).
    ``swap``: the attention reads the slots of :func:`_swap_head_groups`."""
    from repro_torch.serving import kv_cache as tkv
    from repro_torch.serving.reference import window_attention

    n_tok, prefix = 20, 7
    run = _multipage_run(ppr, groups, n_tok, seed)
    spec, kv = run.spec, run.kv
    P, n_kv, hd = MULTIPAGE[ppr]
    cache = tkv.init_compressed(spec, B, run.table, device="cpu")
    worst = {"paged": 0.0, "oracle": 0.0, "state": 0.0}
    with obs.recording():
        tkv.extend(spec, cache, kv[0, :, :prefix], kv[1, :, :prefix], 0)
        for pos in range(prefix, n_tok):
            tkv.append(spec, cache, kv[0, :, pos:pos + 1], kv[1, :, pos:pos + 1], pos)
            q = _multipage_query(run, pos)
            ref = window_attention(q[:, 0], kv[0], kv[1], pos)
            read = cache
            if swap:
                read = dict(cache, k_pages=_swap_head_groups(cache["k_pages"], ppr),
                            v_pages=_swap_head_groups(cache["v_pages"], ppr))
            worst["paged"] = max(worst["paged"], _gap(
                tkv.attention_decode(spec, q, read, pos, backend="paged"), ref))
            worst["oracle"] = max(worst["oracle"], _gap(
                tkv.attention_decode(spec, q, cache, pos, backend="oracle"), ref))
            qg = q.reshape(B, n_kv, groups, hd).float()
            acc, m, l = t_pa.paged_attention_decode_plain(
                qg, read["k_pages"], read["v_pages"], run.table, pos, spec.fr, n_kv=n_kv,
                hd=hd, groups=groups, chunk_slots=3)
            before = window_attention(q[:, 0], kv[0], kv[1], pos - 1)
            worst["state"] = max(worst["state"], _gap(acc / l[..., None], before))
        assert obs.snapshot(spans=False)["counters"]["words.dropped"] == 0
    return worst


@pytest.mark.parametrize("ppr", list(MULTIPAGE))
@pytest.mark.parametrize("groups", [1, 2])
def test_multipage_rows_match_the_references(ppr, groups):
    """Rows over 2 and 4 page slots at G 1 and 2: the tail form (the
    ``paged`` backend: the plain version's state, then the tail merge) and
    the state form against the float32 plain reference
    (``serving.reference.window_attention``, window 0), and the oracle
    backend against it, each within its rounding."""
    got = _multipage_gaps(ppr, groups, seed=10 * ppr + groups)
    assert got["paged"] <= TOL_PAGED, got
    assert got["oracle"] <= TOL_ORACLE, got
    assert got["state"] <= TOL_STATE, got


@pytest.mark.parametrize("ppr", list(MULTIPAGE))
def test_multipage_head_group_swap_fails(ppr):
    """A head group that reads another group's slot of its token misses the
    references by ten times the tolerance and more, in both forms."""
    got = _multipage_gaps(ppr, 1, seed=7 * ppr, swap=True)
    assert got["paged"] >= 10 * TOL_PAGED, got
    assert got["state"] >= 10 * TOL_PAGED, got


def test_multipage_entry_points_on_cpu():
    """The wrapper, the tail form and the pass decode's entry point take a
    multipage row on the CPU: the wrapper is the plain version bit for bit,
    the tail form its eager merge, and ``decode_pages`` gives ``fr_decode``'s
    words of the first tokens' slots in slot order; no launch is counted.  A
    window layer's ring refuses such rows, and so does a slot count that is
    not whole rows."""
    ppr, groups = 2, 2
    run = _multipage_run(ppr, groups, 12, seed=3)
    P, n_kv, hd = MULTIPAGE[ppr]
    cfg = run.spec.fr
    words = tfr.bf16_to_words(run.kv).reshape(2, -1, P)

    def pages(w):
        blob = tfr.fr_encode(w, run.table, cfg)
        return {k: v.reshape((B, -1) + v.shape[1:]) for k, v in blob.items()
                if k not in ("n_spilled", "n_dropped")}

    pk, pv = pages(words[0]), pages(words[1])
    assert pk["ptrs"].shape[1] == 12 * ppr
    q = _multipage_query(run, 9).reshape(B, n_kv, groups, hd).float()
    geom = dict(n_kv=n_kv, hd=hd, groups=groups)
    before = (_launches("attn"), _launches("attn_multipage"))
    for pos in (0, 5, 11):
        got = t_pa.paged_attention_decode(q, pk, pv, run.table, pos, cfg, **geom)
        want = t_pa.paged_attention_decode_plain(q, pk, pv, run.table, pos, cfg, **geom)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        kt, vt = run.kv[0, :, pos:pos + 1], run.kv[1, :, pos:pos + 1]
        tail = t_pa.paged_attention_decode_tail(q, pk, pv, run.table, pos, cfg, k_tail=kt,
                                                v_tail=vt, **geom)
        assert torch.equal(tail, _eager_tail_merge(q, want, kt, vt, pos, 0))
    k, v = t_pa.decode_pages(pk, pv, run.table, 5, cfg, **geom)
    assert k.shape == v.shape == (B, 5 * ppr, P)
    for b in range(B):
        assert torch.equal(k[b], tfr.fr_decode({f: t[b, :5 * ppr] for f, t in pk.items()},
                                               run.table, cfg))
    assert (_launches("attn"), _launches("attn_multipage")) == before
    with pytest.raises(ValueError, match="window"):
        t_pa.paged_attention_decode(q, pk, pv, run.table, 5, cfg, **geom, window=4)
    with pytest.raises(ValueError, match="window"):
        t_pa.attn_geometry(cfg, **geom, window=4)
    odd = {f: t[:, :-1] for f, t in pk.items()}
    with pytest.raises(ValueError, match="whole rows"):
        t_pa.decode_pages(odd, odd, run.table, 5, cfg, **geom)


def test_multipage_geometry_sees_a_page_of_heads():
    """A row over ppr slots runs blocks of a page's Kv / ppr heads: the same
    shared memory, pass size and token slices as a geometry of those heads
    whose row fills one page, and ppr head groups on the grid's third axis;
    the kernel's parameters are a page row's, its page count the slots'."""
    kv = tfr.FRConfig(**KV_FR)
    wide = t_pa.attn_geometry(kv, n_kv=32, hd=128, groups=1)             # deepseek-7b
    half = t_pa.attn_geometry(kv, n_kv=16, hd=128, groups=1)
    assert (wide.pt, wide.ppr, wide.chunks) == (1, 2, 2) and half.ppr == 1
    assert (wide.pass_n, wide.ts) == (half.pass_n, half.ts) == (8, 1)
    for n in range(1, t_pa.MAX_PASS_SLOTS + 1):
        assert (t_pa.smem_bytes(kv, n_kv=32, hd=128, groups=1, n_slots=n)
                == t_pa.smem_bytes(kv, n_kv=16, hd=128, groups=1, n_slots=n))
    ip = t_pa.attn_iparams(kv, n_kv=32, hd=128, groups=1, batch=3, n_slots=10)
    assert ip[0] == 3 * 10 * 2 and ip[-2:] == [1, 8]
    hd512 = t_pa.attn_geometry(kv, n_kv=8, hd=512, groups=2)          # two channel chunks a row
    assert (hd512.ppr, hd512.chunks) == (2, 2 * 1 * 2)


# ---------------------------------------------------------------------------
# on the card: kernel vs plain
# ---------------------------------------------------------------------------

def _card_pages(cfg, n_kv, hd, slots, dev, seed):
    """K and V pages of ``slots`` page slots a row, or of ``slots`` tokens
    (``slots * ppr`` page slots) where a row spans several, and their table."""
    pt, ppr = t_pa.attn_layout(cfg, n_kv, hd)
    rng = np.random.default_rng(seed)
    sparse = cfg.num_profiles > 1
    kw, vw = (torch.from_numpy(kv_words(rng, slots * pt, n_kv, hd, sparse).astype(np.int32)).to(dev)
              for _ in "kv")
    table = tfr.fit_fr_bases(torch.cat([kw, vw]).reshape(-1), cfg)

    def pages(w):
        blob = tfr.fr_encode(w.reshape(-1, cfg.page_words), table, cfg)
        return {k: v.reshape((B, slots * ppr) + v.shape[1:]).contiguous() for k, v in blob.items()
                if k not in ("n_spilled", "n_dropped")}

    return pages(kw), pages(vw), table, pt


def _single_width(page_words):
    return dict(word_bits=16, page_words=page_words, num_bases=14, width_set=(8,),
                bucket_caps=(page_words,), outlier_cap=16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pt2", "pt4", "pt1", "adaptive", "llama405b",
                                  "hd256", "hd32", "hd80", "hd33", "hd512", "hd384",
                                  "g6-hd128", "paligemma"])
def test_kernel_matches_plain_on_card(cuda_device, case):
    """Every channels-per-lane build of the kernel (hd 32, 64, 80 and 128,
    256), the odd-hd path (no channel pairs), a page of 32 tokens, heads
    split into two channel chunks (hd 512, and hd 384 with a half chunk), and
    the attention in token slices: 16 at the decode cells' G 6 on one KV
    head of 128 (45 slots, so a split's last pass is short), 2 at
    paligemma's G 8 at hd 256.  ``launches.attn_sliced`` rises with each
    sliced launch and stays put at the serving shape."""
    cfg = tfr.FRConfig(**{"adaptive": ADAPTIVE, "pt4": FR48, "llama405b": KV_FR,
                          "hd256": KV_FR, "hd80": _single_width(640),
                          "hd33": _single_width(4224), "hd512": KV_FR,
                          "hd384": _single_width(1536), "g6-hd128": KV_FR,
                          "paligemma": KV_FR}.get(case, FR8))
    n_kv, hd, groups, slots = {"pt2": (2, 64, 2, 37), "pt4": (1, 64, 4, 40),
                               "pt1": (2, 128, 3, 50), "adaptive": (2, 64, 2, 33),
                               "llama405b": (8, 128, 16, 64), "hd256": (4, 256, 4, 21),
                               "hd32": (2, 32, 8, 30), "hd80": (1, 80, 3, 25),
                               "hd33": (1, 33, 2, 6), "hd512": (1, 512, 8, 27),
                               "hd384": (1, 384, 3, 19), "g6-hd128": (1, 128, 6, 45),
                               "paligemma": (1, 256, 8, 21)}[case]
    pk, pv, table, pt = _card_pages(cfg, n_kv, hd, slots, cuda_device, seed=slots)
    q = torch.randn(B, n_kv, groups, hd, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    n = t_pa.pass_slots(cfg, n_kv=n_kv, hd=hd, groups=groups)
    sliced = t_pa.token_slices(n_kv * groups, hd, n * pt) > 1
    if case in ("g6-hd128", "paligemma", "llama405b"):
        assert sliced == (case != "llama405b")
    for pos in (slots * pt - 1, slots * pt // 3, pt - 1):
        n0, s0 = _launches("attn"), _launches("attn_sliced")
        got = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, n_kv=n_kv, hd=hd,
                                          groups=groups)
        torch.cuda.synchronize()
        assert _launches("attn") == n0 + 1
        assert _launches("attn_sliced") == s0 + sliced
        want = t_pa.paged_attention_decode_plain(q, pk, pv, table, pos, cfg, n_kv=n_kv,
                                                 hd=hd, groups=groups)
        if pos < pt:
            assert (got[1] == t_pa.MASKED).all() and (got[2] == 0).all() and (got[0] == 0).all()
        assert_state_close([t.cpu() for t in got], [t.cpu() for t in want])


#: (n_kv, hd, groups): one chip's share of mixtral-8x22b and of
#: Trinity-Large-Preview under 8-way tensor parallelism, and musicgen-large
RING_GEOMS = {"g6-hd128": (1, 128, 6), "g1-hd64": (32, 64, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(RING_GEOMS))
@pytest.mark.parametrize("whole_pages", [True, False])
def test_ring_kernel_matches_plain_on_card(cuda_device, geom, whole_pages):
    """The ring instantiation against the plain version's ring mode at a
    window of whole pages and one of not, before the ring fills, at a flush
    step (its reused slot masked) and after wraps, at the trinity cell's
    page of 16 tokens (G 6) and at one token a page (G 1)."""
    cfg = tfr.FRConfig(**KV_FR)
    n_kv, hd, groups = RING_GEOMS[geom]
    pt = cfg.page_words // (n_kv * hd)
    window = 40 * pt - (0 if whole_pages else max(1, pt // 2))
    R = -(-window // pt)
    pk, pv, table, _ = _card_pages(cfg, n_kv, hd, R, cuda_device, seed=R + pt)
    q = torch.randn(B, n_kv, groups, hd, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1)) * 4
    for pos in (10 * pt + pt // 2, 85 * pt + pt - 1, 130 * pt + 3 * pt // 4, 3 * R * pt - 1):
        n0 = _launches("attn")
        got = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, n_kv=n_kv, hd=hd,
                                          groups=groups, window=window)
        torch.cuda.synchronize()
        assert _launches("attn") == n0 + 1
        want = t_pa.paged_attention_decode_plain(q, pk, pv, table, pos, cfg, n_kv=n_kv,
                                                 hd=hd, groups=groups, window=window)
        assert_state_close([t.cpu() for t in got], [t.cpu() for t in want])


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want|`` elementwise in bf16 ulps of ``max(1, |want|)``: the
    resolution at which the benchmark's ``attn_gap`` (``|d| / max(1, |ref|)``)
    reads an output, so a rounding flip counts one and a near-zero output's
    float32 noise counts next to nothing."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1))) - 7)
    return (got.float() - w).abs() / ulp


#: the tail form's card cases: (n_kv, hd, groups, page slots, window): the
#: decode cells' full layers (mixtral's G 6 at hd 128, musicgen's one token a
#: page), the serving shape, and the rings of RING_GEOMS at a window of whole
#: pages and one of not
TAIL_CASES = {
    "mixtral": (1, 128, 6, 45, 0), "musicgen": (32, 64, 1, 50, 0),
    "serving": (8, 128, 16, 24, 0),
    **{f"ring-{g}-{w}": (*RING_GEOMS[g], None, w) for g in RING_GEOMS for w in ("whole", "part")},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_tail_form_matches_unfused_on_card(cuda_device, case):
    """The tail form (C, then the merge kernel taking the raw tail) against
    unfused C followed by the eager tail merge and against its plain version
    (``paged_attention_decode_tail_plain``), within one bf16 ulp, with the
    tail holding 1, pt - 1 and pt tokens and before the first full page (C
    contributes nothing there); ``launches.attn_tail`` rises by one a
    tail-form call and not for a direct ``paged_attention_decode`` call."""
    cfg = tfr.FRConfig(**KV_FR)
    n_kv, hd, groups, slots, window = TAIL_CASES[case]
    pt = cfg.page_words // (n_kv * hd)
    if window is not None:
        window = 40 * pt - (0 if window == "whole" else max(1, pt // 2))
        slots = -(-window // pt)
    pk, pv, table, _ = _card_pages(cfg, n_kv, hd, slots, cuda_device, seed=slots + pt)
    kt, vt = (_tail_ring(pt, n_kv, hd, cuda_device, s) for s in (1, 2))
    q = torch.randn(B, n_kv, groups, hd, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3)) * 4
    geom = dict(n_kv=n_kv, hd=hd, groups=groups, window=window or 0)
    cur = 3 * slots + 1 if window else slots - 1
    for pos in [pt // 2] + _tail_positions(pt, cur):
        n0, t0 = _launches("attn"), _launches("attn_tail")
        got = t_pa.paged_attention_decode_tail(q, pk, pv, table, pos, cfg, k_tail=kt, v_tail=vt,
                                               **geom)
        torch.cuda.synchronize()
        assert (_launches("attn"), _launches("attn_tail")) == (n0 + 1, t0 + 1)
        state = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
        assert (_launches("attn"), _launches("attn_tail")) == (n0 + 2, t0 + 1)
        unfused = t_pa.tail_merge(q, state, kt, vt, pos, window=geom["window"])
        plain = t_pa.paged_attention_decode_tail_plain(q, pk, pv, table, pos, cfg, k_tail=kt,
                                                       v_tail=vt, **geom)
        assert got.shape == plain.shape and got.dtype == torch.bfloat16
        assert got.isfinite().all()
        for want in (unfused, plain):
            ulps = bf16_ulps(got, want)
            assert float(ulps.max()) <= 1, (pos, float(ulps.max()), int((ulps > 1).sum()))


#: rows over several page slots on the card: (fr, n_kv, hd, groups, batch,
#: tokens, positions): deepseek-7b's layer at the benchmark cell's context (2
#: slots a row, G 1), 4 slots a row at G 2, 2 slots of hd 256 (8 channels a
#: lane), and 2 slots of hd 512 (two channel chunks)
MULTIPAGE_CARD = {
    "deepseek-7b": (KV_FR, 32, 128, 1, 4, 4096, (4031, 4095)),
    "ppr4-g2": (_single_width(512), 16, 128, 2, B, 300, (299, 171, 8, 0)),
    "hd256-g2": (KV_FR, 16, 256, 2, B, 200, (199, 64, 7)),
    "hd512-g2": (KV_FR, 8, 512, 2, B, 150, (149, 33)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MULTIPAGE_CARD))
def test_multipage_kernel_matches_plain_on_card(cuda_device, case):
    """Kernel C over rows that span several page slots (each head group's
    blocks decoding its own slots) against the plain version: the state form
    within ``assert_state_close`` and the tail form within one bf16 ulp, at
    positions off and on a pass's end; every launch is counted in
    ``launches.attn_multipage`` as in ``launches.attn``."""
    from repro_torch.kernels import gbdi_encode as enc

    fr_kw, n_kv, hd, groups, batch, n_tok, positions = MULTIPAGE_CARD[case]
    cfg = tfr.FRConfig(**fr_kw)
    ppr = t_pa.attn_layout(cfg, n_kv, hd)[1]
    assert ppr > 1
    gen = torch.Generator(cuda_device).manual_seed(n_tok + ppr)
    means = torch.randn(2, 1, 1, n_kv, hd, generator=gen, device=cuda_device) * 2
    kv = (means + 0.1 * torch.randn(2, batch, n_tok, n_kv, hd, generator=gen,
                                    device=cuda_device)).to(torch.bfloat16)
    words = tfr.bf16_to_words(kv)
    table = tfr.fit_fr_bases(words[:, 0, :64].reshape(-1), cfg)

    def pages(w):
        blob = enc.gbdi_encode(w.reshape(-1, cfg.page_words).contiguous(), table, cfg)
        return {k: v.reshape((batch, n_tok * ppr) + v.shape[1:]) for k, v in blob.items()
                if k not in ("n_spilled", "n_dropped")}

    pk, pv = pages(words[0]), pages(words[1])
    q = torch.randn(batch, n_kv, groups, hd, generator=gen, device=cuda_device) * 4
    geom = dict(n_kv=n_kv, hd=hd, groups=groups)
    for pos in positions:
        kt, vt = kv[0, :, pos:pos + 1], kv[1, :, pos:pos + 1]
        n0, m0 = _launches("attn"), _launches("attn_multipage")
        got = t_pa.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
        out = t_pa.paged_attention_decode_tail(q, pk, pv, table, pos, cfg, k_tail=kt, v_tail=vt,
                                               **geom)
        torch.cuda.synchronize()
        assert _launches("attn") - n0 == _launches("attn_multipage") - m0 == 2
        want = t_pa.paged_attention_decode_plain(q, pk, pv, table, pos, cfg, **geom)
        assert_state_close([t.cpu() for t in got], [t.cpu() for t in want])
        plain = t_pa.paged_attention_decode_tail_plain(q, pk, pv, table, pos, cfg, k_tail=kt,
                                                       v_tail=vt, **geom)
        ulps = bf16_ulps(out, plain)
        assert float(ulps.max()) <= 1, (pos, float(ulps.max()), int((ulps > 1).sum()))


@pytest.mark.cuda
def test_smem_formula_matches_kernel_source(cuda_device):
    """The wrapper's shared-memory formula equals the kernel source's at every
    pass size, and the runtime holds at least one block per SM."""
    lib = t_pa._lib()
    for kw, geom in ((FR8, dict(n_kv=2, hd=64, groups=2)), (ADAPTIVE, dict(n_kv=1, hd=64, groups=4)),
                     (KV_FR, LLAMA405B), (KV_FR, dict(n_kv=8, hd=128, groups=32)),
                     (ADAPTIVE_2048, dict(n_kv=8, hd=128, groups=4)),
                     (KV_FR, dict(n_kv=1, hd=512, groups=8)),
                     (KV_FR, dict(n_kv=1, hd=128, groups=6)),
                     (KV_FR, dict(n_kv=1, hd=256, groups=8)),
                     (KV_FR, dict(n_kv=32, hd=128, groups=1)),
                     (_single_width(512), dict(n_kv=16, hd=128, groups=2)),
                     (KV_FR, dict(n_kv=8, hd=512, groups=2))):
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
    ppr = t_pa.attn_layout(cfg, n_kv, hd)[1]
    slots = 5 * n + 3
    pk, pv, table, _ = _card_pages(cfg, n_kv, hd, slots, cuda_device, seed=slots + n_kv)
    for n_valid in (slots, slots - 1, n - 1, 1):
        k, v = t_pa.decode_pages(pk, pv, table, n_valid, cfg, n_kv=n_kv, hd=hd, groups=groups)
        n_slots = n_valid * ppr               # a wide row's tokens fill ppr slots each
        for got, pages in ((k, pk), (v, pv)):
            flat = {key: t[:, :n_slots].reshape((B * n_slots,) + t.shape[2:]).contiguous()
                    for key, t in pages.items()}
            want = t_dec.gbdi_decode(flat, table, cfg).reshape(B, n_slots, cfg.page_words)
            assert torch.equal(got, want), f"{int((got != want).sum())} words differ"
