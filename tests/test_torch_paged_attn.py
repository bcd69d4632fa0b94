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
# (fr, n_kv, hd, groups, slots): page_tokens = 256 // (n_kv * hd)
GEOMS = [
    (FR8, 2, 64, 2, 5),     # pt 2
    (FR48, 1, 64, 4, 4),    # pt 4
    (FR8, 2, 128, 3, 6),    # pt 1
    (FR48, 4, 16, 2, 3),    # pt 4, narrow heads
]
GEOM_IDS = ["pt2", "pt4-multiwidth", "pt1", "pt4-hd16"]
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
                                                           np.asarray(table.widths)))


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
            torch.from_numpy(q), interop.blob_from_numpy(d.k), interop.blob_from_numpy(d.v),
            d.ttable, pos, d.cfg, n_kv=n_kv, hd=hd, groups=groups, chunk_slots=2)
        assert_state_close(got, want)
        if pos < d.pt:     # every page masked
            assert (got[1] == t_pa.MASKED).all() and (got[2] == 0).all() and (got[0] == 0).all()


def test_wrapper_on_cpu_runs_the_plain_version(ref):
    fr_kw, n_kv, hd, groups, slots = GEOMS[0]
    d = make_pages(ref, fr_kw, n_kv, hd, slots, seed=3)
    q = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (B, n_kv, groups, hd)).astype(np.float32))
    args = (q, interop.blob_from_numpy(d.k), interop.blob_from_numpy(d.v), d.ttable, 7, d.cfg)
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


def test_smem_budget_check():
    """The shared-memory check stands where the VMEM check stood: the serving
    path's Llama-3-405B layer fits one block, a head count past 227 KB raises."""
    kv = tfr.FRConfig(word_bits=16, page_words=2048, num_bases=14, width_set=(8,),
                      bucket_caps=(2048,), outlier_cap=64)
    need = t_pa.smem_bytes(kv, **LLAMA405B)
    assert need == 194288 <= t_enc.SMEM_LIMIT_BYTES
    t_pa.check_smem(kv, **LLAMA405B)
    t_pa.check_smem(kv, n_kv=8, hd=128, groups=6)               # Mixtral-8x22B
    with pytest.raises(ValueError, match="shared memory"):
        t_pa.check_smem(kv, n_kv=8, hd=128, groups=32)
    assert t_pa.smem_bytes(kv, n_kv=8, hd=128, groups=32) > t_enc.SMEM_LIMIT_BYTES


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pt2", "pt4", "pt1", "adaptive", "llama405b"])
def test_kernel_matches_plain_on_card(cuda_device, case):
    cfg = tfr.FRConfig(**(ADAPTIVE if case == "adaptive" else FR48 if case == "pt4" else FR8))
    n_kv, hd, groups, slots = {"pt2": (2, 64, 2, 37), "pt4": (1, 64, 4, 40),
                               "pt1": (2, 128, 3, 50), "adaptive": (2, 64, 2, 33),
                               "llama405b": (8, 128, 16, 64)}[case]
    if case == "llama405b":
        cfg = tfr.FRConfig(word_bits=16, page_words=2048, num_bases=14, width_set=(8,),
                           bucket_caps=(2048,), outlier_cap=64)
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
    from repro_torch.kernels import _build

    lib = _build.load("gbdi_paged_attn")
    for kw, geom in ((FR8, dict(n_kv=2, hd=64, groups=2)), (ADAPTIVE, dict(n_kv=1, hd=64, groups=4)),
                     (dict(word_bits=16, page_words=2048, num_bases=14, width_set=(8,),
                           bucket_caps=(2048,), outlier_cap=64), LLAMA405B)):
        cfg = tfr.FRConfig(**kw)
        ip = _build.int_array(t_pa.attn_iparams(cfg, **geom))
        assert lib.gbdi_paged_attn_smem_bytes(ip) == t_pa.smem_bytes(cfg, **geom)
