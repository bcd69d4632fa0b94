"""The port's compressed-KV serving path (KVSpec, the cache, KVSession)
against the JAX package.

The reference's cache updates and reads raise on jax 0.9.0 (they reach the
removed ``jax.core.trace_state_clean``), so the references here are built
from the parts that run: JAX ``KVSpec`` and ``init_compressed`` without a
resident region, ``fr_encode``/``fr_decode``, ``merge_softmax`` and the
Pallas paged-attention kernel in interpret mode, with the reference's
attention arithmetic written out in ``jnp``.  Everything runs on the CPU
(``device="cpu"``), where the kernels' wrappers run their plain versions,
except the test marked ``cuda``, which holds the warm paged step on the card
to no blocking copy and no synchronising call.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop, obs
from repro_torch.core import gbdi_fr as tfr
from repro_torch.kernels import gbdi_encode as t_enc
from repro_torch.kernels import gbdi_paged_attn as t_pa
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import KVSession

B = 2
FR = dict(word_bits=16, page_words=128, num_bases=14, width_set=(4, 8),
          bucket_caps=(32, 128), outlier_cap=16)
# a page with at most 64 wide-class words takes the smaller second profile
FR_ADAPTIVE = dict(word_bits=16, page_words=128, num_bases=14, width_set=(4, 8),
                   cap_profiles=((32, 128), (32, 64)), outlier_cap=16)
# (name, fr, n_kv, head_dim, max_len): page_tokens 4, 4 and 1 (a row of two pages)
GEOMS = {"single": (FR, 2, 16, 32), "adaptive": (FR_ADAPTIVE, 2, 16, 32),
         "wide-row": (FR, 2, 128, 8)}


@pytest.fixture(scope="module")
def ref():
    """The JAX reference (the test skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import gbdi_fr
    from repro.kernels import gbdi_paged_attn
    from repro.serving import kv_cache

    return SimpleNamespace(jax=jax, jnp=jnp, fr=gbdi_fr, pa=gbdi_paged_attn, kvc=kv_cache)


def mk_kv(rng, n, n_kv, hd, sparse=False):
    """Channel-structured K/V (per-channel mean N(0,1)*2 + N(0, 0.1)) as
    float32 (B, n, n_kv, hd); ``sparse`` zeroes every other channel of the
    first half of the tokens (so adaptive pages pick both profiles)."""
    x = rng.normal(0, 1, (1, 1, n_kv, hd)) * 2 + rng.normal(0, 0.1, (B, n, n_kv, hd))
    if sparse:
        x[:, :n // 2, :, ::2] = 0
    return x.astype(np.float32)


def words(x):
    """float32 values -> their bf16 bit patterns as uint16 (round to nearest even)."""
    return tfr.bf16_to_words(torch.as_tensor(x)).numpy().astype(np.uint16)


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def assert_cache_equal(a, b, msg=""):
    assert set(a) == set(b), msg
    for key in a:
        if key == "table":
            continue
        if isinstance(a[key], dict):
            assert set(a[key]) == set(b[key]), (msg, key)
            for f in a[key]:
                assert torch.equal(a[key][f], b[key][f]), (msg, key, f)
        else:
            assert torch.equal(bits(a[key]), bits(b[key])), (msg, key)


def setup(ref, name, seed=0, resident=False):
    """Specs of both packages, tokens, and one table fitted by JAX."""
    fr_kw, n_kv, hd, max_len = GEOMS[name]
    jspec = ref.kvc.KVSpec(n_kv=n_kv, head_dim=hd, max_len=max_len,
                           fr=ref.fr.FRConfig(**fr_kw), resident_decode=resident)
    spec = interop.kv_spec_from_fields(dataclasses.asdict(jspec))
    rng = np.random.default_rng(seed)
    sparse = name == "adaptive"
    ks, vs = mk_kv(rng, max_len, n_kv, hd, sparse), mk_kv(rng, max_len, n_kv, hd, sparse)
    jtable = ref.fr.fit_fr_bases(
        ref.jnp.asarray(words(np.concatenate([ks, vs])).astype(np.int32).reshape(-1)), jspec.fr)
    table_np = (np.asarray(jtable.bases), np.asarray(jtable.widths))
    return SimpleNamespace(jspec=jspec, spec=spec, ks=ks, vs=vs, jtable=jtable, table_np=table_np,
                           table=interop.table_from_numpy(*table_np, device="cpu"), rng=rng)


def jax_encode(ref, d, w):
    """JAX fr_encode of (n, page_words) words -> page-slot fields as numpy."""
    blob = ref.fr.fr_encode(ref.jnp.asarray(w.astype(np.int32).reshape(-1, d.spec.fr.page_words)),
                            d.jtable, d.jspec.fr)
    return {k: np.asarray(v) for k, v in blob.items() if k not in ("n_spilled", "n_dropped")}


def jax_zeros(ref, d):
    """The reference's empty cache (its resident seed raises on jax 0.9.0)."""
    return ref.kvc.init_compressed(dataclasses.replace(d.jspec, resident_decode=False), B,
                                   d.jtable)


def jax_tree(ref, d, n):
    """The reference cache after appending tokens 0..n-1, built from JAX
    fr_encode (page slots) and the append rule (tail ring), as numpy."""
    pt, ppr = d.spec.page_tokens, d.spec.pages_per_row
    zeros = jax_zeros(ref, d)
    tree = {"table": d.table_np}
    for side, xs in (("k", d.ks), ("v", d.vs)):
        pages = {k: np.array(v) for k, v in zeros[f"{side}_pages"].items()}
        full = n // pt
        if full:
            for k, v in jax_encode(ref, d, words(xs[:, :full * pt])).items():
                pages[k][:, :full * ppr] = v.reshape((B, full * ppr) + v.shape[1:])
        tail = np.zeros((B, pt) + xs.shape[2:], np.uint16)
        for p in range(n):
            tail[:, p % pt] = words(xs[:, p])
        tree[f"{side}_pages"], tree[f"{side}_tail"] = pages, tail
    return tree


def jax_decoded(ref, d, tree, side):
    """JAX fr_decode of a side's page slots -> (B, S, Kv, hd) uint16 words."""
    flat = {k: ref.jnp.asarray(v.reshape((-1,) + v.shape[2:]))
            for k, v in tree[f"{side}_pages"].items()}
    w = np.asarray(ref.fr.fr_decode(flat, d.jtable, d.jspec.fr)).astype(np.uint16)
    return w.reshape(B, -1, d.spec.n_kv, d.spec.head_dim)


def jax_oracle(ref, d, tree, q, pos):
    """The reference's oracle attention (kv_cache.py:299-308) over JAX-decoded pages."""
    jax, jnp = ref.jax, ref.jnp
    pt = d.spec.page_tokens

    def view(side):
        w = jax_decoded(ref, d, tree, side)
        w[:, (pos // pt) * pt:(pos // pt) * pt + pt] = tree[f"{side}_tail"]
        return jax.lax.bitcast_convert_type(jnp.asarray(w), jnp.bfloat16)

    K, V = view("k"), view("v")
    Bq, S, Kv, hd = K.shape
    H = q.shape[2]
    valid = jnp.arange(S) <= pos
    scale = 1.0 / jnp.sqrt(hd).astype(jnp.float32)
    qg = jnp.asarray(q).reshape(Bq, 1, Kv, H // Kv, hd)
    logits = jnp.einsum("bskgh,btkh->bkgst", qg, K).astype(jnp.float32) * scale
    logits = jnp.where(valid[None, None, None, None, :], logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1).astype(V.dtype)
    return jnp.einsum("bkgst,btkh->bskgh", probs, V).reshape(Bq, 1, H * hd)


def jax_paged(ref, d, tree, q, pos):
    """The reference's paged attention (kv_cache.py:310-333) with the Pallas
    kernel in interpret mode for the compressed pages."""
    jax, jnp = ref.jax, ref.jnp
    Bq, _, H, hd = q.shape
    Kv, pt = d.spec.n_kv, d.spec.page_tokens
    G = H // Kv
    qg = jnp.asarray(q).reshape(Bq, Kv, G, hd).astype(jnp.float32)
    pages = {side: {k: jnp.asarray(v) for k, v in tree[f"{side}_pages"].items()} for side in "kv"}
    acc, m, l = ref.pa.paged_attention_decode(
        qg, pages["k"], pages["v"], d.jtable, jnp.int32(pos), d.jspec.fr,
        n_kv=Kv, hd=hd, groups=G, interpret=True)
    scale = 1.0 / jnp.sqrt(jnp.float32(hd))
    Kt, Vt = (jax.lax.bitcast_convert_type(jnp.asarray(tree[f"{s}_tail"]), jnp.bfloat16)
              .astype(jnp.float32) for s in "kv")
    tail_valid = (pos // pt) * pt + jnp.arange(pt) <= pos
    lg = jnp.einsum("bkgh,btkh->bkgt", qg, Kt) * scale
    lg = jnp.where(tail_valid[None, None, None, :], lg, -1e30)
    m2 = lg.max(-1)
    p2 = jnp.where(lg <= -1e29, 0.0, jnp.exp(lg - m2[..., None]))
    acc2 = jnp.einsum("bkgt,btkh->bkgh", p2, Vt)
    accm, _, lm = ref.pa.merge_softmax(acc, m, l, acc2, m2, p2.sum(-1))
    return (accm / lm[..., None]).reshape(Bq, 1, H * hd).astype(jnp.bfloat16)


def assert_within_one_ulp(got, want):
    """bf16 outputs at most one unit in the last place apart."""
    def ordered(x):
        x = x.astype(np.int32)
        return np.where(x < 0, -(x & 0x7FFF), x)

    g = got.view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    assert g.shape == w.shape
    assert np.abs(ordered(g) - ordered(w)).max() <= 1


# ---------------------------------------------------------------------------
# geometry and state
# ---------------------------------------------------------------------------

KV_GEOMS = [(8, 128, 32768, False), (8, 128, 32768, True), (2, 16, 33, False),
            (32, 128, 100, False), (32, 128, 100, True)]
KV_GEOM_IDS = ["llama405b", "llama405b-resident", "pt4-ragged", "wide-row", "wide-row-resident"]


@pytest.mark.parametrize("geom", KV_GEOMS, ids=KV_GEOM_IDS)
def test_kvspec_arithmetic_matches_reference(ref, geom):
    """Where a row fits in a page the byte counts equal the reference's.  A
    row wider than a page fills ``pages_per_row`` slots a page, which the
    port counts and the reference does not: there the port exceeds the
    reference by exactly the uncounted slots, K and V."""
    n_kv, hd, max_len, resident = geom
    jspec = ref.kvc.KVSpec(n_kv=n_kv, head_dim=hd, max_len=max_len, resident_decode=resident)
    spec = interop.kv_spec_from_fields(dataclasses.asdict(jspec))
    assert spec == tkv.KVSpec(n_kv=n_kv, head_dim=hd, max_len=max_len, resident_decode=resident)
    for attr in ("row_words", "page_tokens", "n_pages", "word_bytes"):
        assert getattr(spec, attr) == getattr(jspec, attr), attr
    ppr, per_page = spec.pages_per_row, spec.fr.compressed_bytes_per_page()
    assert (ppr > 1) == (n_kv * hd > spec.fr.page_words)

    def uncounted(b: int, pages: int) -> int:
        return 2 * b * (ppr - 1) * pages * per_page

    for b in (1, 3, 8):
        assert spec.compressed_bytes(b) == jspec.compressed_bytes(b) + uncounted(b, spec.n_pages)
        assert spec.raw_bytes(b) == jspec.raw_bytes(b)
        for n in (0, 1, 5, 31, 100, 40000):
            pages = min(spec.n_pages, n // spec.page_tokens)
            assert (spec.compressed_bytes_upto(b, n)
                    == jspec.compressed_bytes_upto(b, n) + uncounted(b, pages))
            assert spec.raw_bytes_upto(b, n) == jspec.raw_bytes_upto(b, n)
    assert tkv.KV_FR == interop.config_from_fields(dataclasses.asdict(ref.kvc.KV_FR))


@pytest.mark.parametrize("geom", KV_GEOMS, ids=KV_GEOM_IDS)
def test_kvspec_counts_the_allocated_page_slots(ref, geom):
    """``compressed_bytes`` is what ``init_compressed`` allocates: the page
    slots of each side (``n_out.shape[1]``, the same in both packages) at
    ``compressed_bytes_per_page``, plus the raw tail and any resident
    region; ``compressed_bytes_upto`` at ``max_len`` is the same."""
    n_kv, hd, max_len, resident = geom
    jspec = ref.kvc.KVSpec(n_kv=n_kv, head_dim=hd, max_len=max_len)
    spec = tkv.KVSpec(n_kv=n_kv, head_dim=hd, max_len=max_len, resident_decode=resident)
    table = (np.arange(14, dtype=np.int32), np.full(14, 8, np.int32))
    b = 1
    cache = tkv.init_compressed(spec, b, interop.table_from_numpy(*table, device="cpu"),
                                device="cpu")
    jcache = ref.kvc.init_compressed(jspec, b, ref.fr.BaseTable(*map(ref.jnp.asarray, table)))
    per_page = spec.fr.compressed_bytes_per_page()
    total = 0
    for side in ("k", "v"):
        slots = cache[f"{side}_pages"]["n_out"].shape[1]
        assert slots == jcache[f"{side}_pages"]["n_out"].shape[1]
        assert slots == spec.n_pages * spec.pages_per_row
        total += b * slots * per_page
        total += cache[f"{side}_tail"].numel() * spec.word_bytes
        if resident:
            total += cache[f"{side}_dec"].numel() * spec.word_bytes
    assert spec.compressed_bytes(b) == total
    assert spec.compressed_bytes_upto(b, spec.n_pages * spec.page_tokens) == total


@pytest.mark.parametrize("name", list(GEOMS))
def test_init_compressed_matches_reference(ref, name):
    d = setup(ref, name)
    want = ref.kvc.init_compressed(d.jspec, B, d.jtable)
    got = tkv.init_compressed(d.spec, B, d.table, device="cpu")
    assert set(got) == set(want)
    assert ("profile" in got["k_pages"]) == (name == "adaptive")
    for key in ("k_pages", "v_pages"):
        assert set(got[key]) == set(want[key])
        for f, v in want[key].items():
            t = got[key][f]
            assert t.dtype == torch.int32 and tuple(t.shape) == v.shape and not t.any()
    for key in ("k_tail", "v_tail"):
        assert got[key].dtype == torch.bfloat16 and tuple(got[key].shape) == want[key].shape
    assert got["k_tail"].data_ptr() != got["v_tail"].data_ptr()   # updated in place


@pytest.mark.parametrize("fr", [tkv.KV_FR, tfr.FRConfig(**FR_ADAPTIVE)], ids=["kv-fr", "adaptive"])
def test_blob_layout_is_the_encode_and_the_cache(fr):
    """The one blob layout of ``core/gbdi_fr.py``: its fields and trailing
    shapes are what ``fr_encode`` returns, in order; a full and a window
    cache's page dicts are its page fields at ``(batch, slots)``; flattening
    and restoring the leading dims round-trips; and the checked pointer list
    gives the fields' pointers in that order (0 for a single-profile
    config's ``profile``) and refuses a field of the wrong shape."""
    k = fr.num_bases
    table = interop.table_from_numpy(np.arange(k) * 37, [fr.width_set[-1]] * k, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 1 << 16, (3, fr.page_words), generator=gen, dtype=torch.int32)
    blob = {f: t.contiguous() for f, t in tfr.fr_encode(x, table, fr).items()}
    want = tfr.blob_shapes(fr, counts=True)
    assert list(blob) == list(want)
    assert {f: (t.dtype, tuple(t.shape)) for f, t in blob.items()} == \
        {f: (torch.int32, (3,) + shape) for f, shape in want.items()}
    pages = tfr.blob_shapes(fr)
    assert list(pages) == [f for f in tkv.PAGE_KEYS if f in want]
    assert ("profile" in pages) == (fr.num_profiles > 1)

    hd = fr.page_words // 4                       # page_tokens 4
    for spec in (tkv.KVSpec(n_kv=1, head_dim=hd, max_len=32, fr=fr),
                 tkv.KVSpec(n_kv=1, head_dim=hd, max_len=32, fr=fr, window=9)):
        cache = tkv.init_compressed(spec, B, table, device="cpu")
        for side in ("k_pages", "v_pages"):
            assert list(cache[side]) == list(pages)
            for f, shape in pages.items():
                t = cache[side][f]
                assert t.dtype == torch.int32 and not t.any()
                assert tuple(t.shape) == (B, spec.n_pages * spec.pages_per_row) + shape

    lead = tfr.lead_blob(blob, (3, 1))
    assert all(tuple(lead[f].shape) == (3, 1) + shape for f, shape in want.items())
    flat = tfr.flat_blob(lead)
    assert list(flat) == list(want) and all(torch.equal(flat[f], blob[f]) for f in want)
    assert list(tfr.lead_blob(flat, (3,), tkv.PAGE_KEYS)) == list(pages)

    tail = [] if fr.num_profiles > 1 else [0]
    assert t_enc.blob_ptrs(blob, fr, (3,), counts=True) == \
        [blob[f].data_ptr() for f in want] + tail
    assert t_enc.blob_ptrs(blob, fr, (3,)) == [blob[f].data_ptr() for f in pages] + tail
    with pytest.raises(ValueError, match="shape"):
        t_enc.blob_ptrs(blob, fr, (4,))
    for f in pages:
        bad = dict(blob, **{f: torch.zeros(blob[f].shape[:1] + (1,) * blob[f].dim(),
                                           dtype=torch.int32)})
        with pytest.raises(ValueError, match=f"k {f} must be"):
            t_enc.blob_ptrs(bad, fr, (3,), side="k ")


@pytest.mark.parametrize("name", list(GEOMS))
def test_resident_seed_is_the_decoded_zero_tree(ref, name):
    d = setup(ref, name, resident=True)
    cache = tkv.init_compressed(d.spec, B, d.table, device="cpu")
    zero = {"k_pages": {k: np.asarray(v) for k, v in jax_zeros(ref, d)["k_pages"].items()}}
    want = jax_decoded(ref, d, zero, "k")
    S = d.spec.n_pages * d.spec.page_tokens
    assert tuple(cache["k_dec"].shape) == (B, S, d.spec.n_kv, d.spec.head_dim) == want.shape
    for side in ("k", "v"):
        np.testing.assert_array_equal(cache[f"{side}_dec"].view(torch.int16).numpy(),
                                      want.view(np.int16))


@pytest.mark.parametrize("name", list(GEOMS))
def test_every_flush_matches_reference_encode(ref, name):
    """After every flush the page slots are bit-equal to JAX fr_encode of the
    tail's words; after all appends the cache equals the reference tree."""
    d = setup(ref, name)
    pt, ppr = d.spec.page_tokens, d.spec.pages_per_row
    cache = tkv.init_compressed(d.spec, B, d.table, device="cpu")
    n = d.spec.max_len - 1
    for p in range(n):
        tkv.append(d.spec, cache, torch.from_numpy(d.ks[:, p:p + 1]),
                   torch.from_numpy(d.vs[:, p:p + 1]), p)
        if p % pt != pt - 1:
            continue
        slots = slice((p // pt) * ppr, (p // pt + 1) * ppr)
        for side in ("k", "v"):
            want = jax_encode(ref, d, cache[f"{side}_tail"].view(torch.int16).numpy()
                              .view(np.uint16))
            assert set(cache[f"{side}_pages"]) == set(want)
            for f, v in want.items():
                np.testing.assert_array_equal(cache[f"{side}_pages"][f][:, slots].numpy(),
                                              v.reshape((B, ppr) + v.shape[1:]), err_msg=f)
    assert_cache_equal(cache, interop.cache_from_numpy(jax_tree(ref, d, n), device="cpu"))
    if name == "adaptive":
        assert len(set(cache["k_pages"]["profile"].flatten().tolist())) > 1


def test_resident_region_over_random_schedule(ref):
    """Port of test_kv_compress.py's resident-region property: over a random
    prefill/append schedule, k_dec/v_dec stay bit-identical to a from-scratch
    decode of the page slots, read_full matches the plain cache fed the same
    tokens, and resident attention is bit-identical to the oracle."""
    d = setup(ref, "single", seed=7, resident=True)
    spec0 = dataclasses.replace(d.spec, resident_decode=False)
    assert d.spec.page_tokens == 4        # flushes mid-schedule, not per token
    sess = KVSession(d.spec, B, d.table, device="cpu")         # auto -> resident
    plain = tkv.init_compressed(spec0, B, d.table, device="cpu")
    rng = np.random.default_rng(7)
    ks, vs = torch.from_numpy(d.ks), torch.from_numpy(d.vs)
    pos = 0
    while pos < d.spec.max_len - 6:
        burst = int(rng.integers(1, 6))
        k, v = ks[:, pos:pos + burst], vs[:, pos:pos + burst]
        if burst > 1 and rng.random() < 0.5:
            sess.prefill(k, v)
        else:
            for t in range(burst):
                sess.append(k[:, t:t + 1], v[:, t:t + 1])
        for t in range(burst):
            tkv.append(spec0, plain, k[:, t:t + 1], v[:, t:t + 1], pos + t)
        pos += burst
        for side in ("k", "v"):
            scratch = tkv._decompress_all(d.spec, sess.cache[f"{side}_pages"], d.table)
            assert torch.equal(bits(sess.cache[f"{side}_dec"]), bits(scratch)), (side, pos)
        got, want = tkv.read_full(d.spec, sess.cache, pos - 1), tkv.read_full(spec0, plain, pos - 1)
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w)), pos
    q = torch.from_numpy(rng.normal(0, 1, (B, 1, 4, 16)).astype(np.float32))
    res = tkv.attention_decode(d.spec, q, sess.cache, pos - 1, backend="resident")
    auto = tkv.attention_decode(d.spec, q, sess.cache, pos - 1)
    orc = tkv.attention_decode(spec0, q, plain, pos - 1, backend="oracle")
    assert torch.equal(bits(res), bits(orc)) and torch.equal(bits(auto), bits(res))


@pytest.mark.parametrize("name,resident", [("single", False), ("single", True),
                                           ("adaptive", True), ("wide-row", True)])
def test_bulk_prefill_matches_appends(ref, name, resident):
    """KVSession.prefill (one encode launch per side for every page it
    completes) leaves the cache bit-identical to token-by-token appends,
    stale rows of earlier pages in the tail ring included."""
    d = setup(ref, name, seed=3, resident=resident)
    ks, vs = torch.from_numpy(d.ks), torch.from_numpy(d.vs)
    one = tkv.init_compressed(d.spec, B, d.table, device="cpu")
    sess = KVSession(d.spec, B, d.table, device="cpu")
    pt = d.spec.page_tokens
    # mid-page starts, a burst shorter than a page, several pages at once
    for burst in (3, 1, 2 * pt + 1, pt - 1 or 1, 0, d.spec.max_len):
        burst = min(burst, d.spec.max_len - sess.pos)
        for t in range(sess.pos, sess.pos + burst):
            tkv.append(d.spec, one, ks[:, t:t + 1], vs[:, t:t + 1], t)
        sess.prefill(ks[:, sess.pos:sess.pos + burst], vs[:, sess.pos:sess.pos + burst])
        assert_cache_equal(sess.cache, one, f"after {sess.pos} tokens")
    assert sess.pos == d.spec.max_len


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["paged", "oracle"])
def test_attention_matches_reference(ref, backend):
    """Both packages attend over the same state (the JAX tree handed over
    with cache_from_numpy): equal to one bf16 ulp, at part-filled and full
    tails and where every page is masked."""
    d = setup(ref, "single", seed=11)
    compose = jax_paged if backend == "paged" else jax_oracle
    q = d.rng.normal(0, 1, (B, 1, 8, d.spec.head_dim)).astype(np.float32)   # G = 4
    for n in (2, 4, 13, 24, 31):
        tree = jax_tree(ref, d, n)
        cache = interop.cache_from_numpy(tree, device="cpu")
        got = tkv.attention_decode(d.spec, torch.from_numpy(q), cache, n - 1, backend=backend)
        assert got.dtype == torch.bfloat16
        assert_within_one_ulp(got, compose(ref, d, tree, q, n - 1))


@pytest.mark.parametrize("backend,resident", [("paged", False), ("oracle", False),
                                              ("auto", True), ("auto", False)])
def test_session_step_matches_manual_path(ref, backend, resident):
    """KVSession.step equals append + attention_decode bit for bit."""
    d = setup(ref, "adaptive", seed=5, resident=resident)
    sess = KVSession(d.spec, B, d.table, backend=backend, device="cpu")
    cache = tkv.init_compressed(d.spec, B, d.table, device="cpu")
    q = torch.from_numpy(d.rng.normal(0, 1, (B, 1, 4, d.spec.head_dim)).astype(np.float32))
    for t in range(9):
        k, v = torch.from_numpy(d.ks[:, t:t + 1]), torch.from_numpy(d.vs[:, t:t + 1])
        got = sess.step(q, k, v)
        tkv.append(d.spec, cache, k, v, t)
        want = tkv.attention_decode(d.spec, q, cache, t, backend=backend)
        assert torch.equal(bits(got), bits(want)), t
    assert sess.pos == 9


def test_backend_errors(ref):
    d = setup(ref, "single")
    cache = tkv.init_compressed(d.spec, B, d.table, device="cpu")
    q = torch.zeros(B, 1, 4, d.spec.head_dim)
    with pytest.raises(ValueError, match="unknown backend"):
        tkv.attention_decode(d.spec, q, cache, 0, backend="xla")
    with pytest.raises(ValueError, match="resident_decode"):
        tkv.attention_decode(d.spec, q, cache, 0, backend="resident")
    sess = KVSession(d.spec, B, d.table, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        sess.step(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="outside"):
        tkv.append(d.spec, cache, q[:, :, :2], q[:, :, :2], d.spec.n_pages * d.spec.page_tokens)
    w = setup(ref, "wide-row")                 # a row of two pages, one head a page
    wide = tkv.init_compressed(w.spec, B, w.table, device="cpu")
    qw = torch.from_numpy(w.rng.normal(0, 1, (B, 1, 4, w.spec.head_dim)).astype(np.float32))
    for pos in range(w.spec.max_len):
        tkv.append(w.spec, wide, torch.from_numpy(w.ks[:, pos:pos + 1]),
                   torch.from_numpy(w.vs[:, pos:pos + 1]), pos)
        orc = tkv.attention_decode(w.spec, qw, wide, pos, backend="oracle").float()
        assert orc.shape == (B, 1, 4 * 128)
        for backend in ("paged", "auto"):               # auto -> paged
            got = tkv.attention_decode(w.spec, qw, wide, pos, backend=backend).float()
            # paged is within half a bf16 ulp of float32 attention, the oracle
            # (its probabilities rounded to bf16) within another ulp
            assert float(((got - orc).abs() / orc.abs().clamp_min(1)).max()) \
                <= 2 ** -7 + 2 ** -8 + 1e-5, (backend, pos)


def test_session_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tkv.KVSpec(n_kv=2, head_dim=16, max_len=8, fr=tfr.FRConfig(**FR))
    table = interop.table_from_numpy(np.arange(14), np.full(14, 8), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVSession(spec, B, table)
    assert KVSession(spec, B, table, device="cpu").cache["k_tail"].device.type == "cpu"


# ---------------------------------------------------------------------------
# on the card: the warm paged step copies nothing from the host
# ---------------------------------------------------------------------------

#: (n_kv, groups, head_dim): one chip's share of mixtral-8x22b under 8-way
#: tensor parallelism, and musicgen-large whole; a window layer at
#: Trinity-Large-Preview's share (mixtral's geometry); deepseek-7b whole, a
#: row over two page slots
CARD_GEOMS = {"mixtral": (1, 6, 128), "musicgen": (32, 1, 64), "trinity-window": (1, 6, 128),
              "deepseek-7b": (32, 1, 128)}
#: the window of each window layer (tokens): 49, a ring of 4 slots of 16
#: tokens that the prefix wraps; the slot the flush step reuses lies wholly
#: before the plain step's window, so that step, run again after the flush,
#: reads what it read before
CARD_WINDOWS = {"trinity-window": 49}
#: counters a checked step reports, as differences
STEP_COUNTERS = ("uploads", "launches.attn", "launches.encode", "table_prep.miss",
                 "launches.attn_multipage")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_GEOMS))
def test_warm_paged_step_makes_no_blocking_copy_on_card(name):
    """A 2-layer paged cache at a decode cell's KV geometry, warmed by one
    plain and one flush step (the first a cold memo miss): a warm plain step
    and a warm flush step upload nothing, miss no prepared table and make no
    synchronising call, and the plain step gives the cold step's outputs bit
    for bit.  musicgen's page holds one token, so each of its steps flushes.
    A window layer's steps run the ring instantiation and its flush reuses a
    ring slot.  deepseek-7b's row fills two page slots a token: each step
    flushes, and each launch counts in ``launches.attn_multipage``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    n_kv, groups, hd = CARD_GEOMS[name]
    pt = tkv.KVSpec(n_kv, hd, max_len=1).page_tokens
    ctx = 8 * pt
    plain_pos, flush_pos = ctx, ctx + max(pt - 1, 1)
    spec = tkv.KVSpec(n_kv, hd, max_len=flush_pos + 1, window=CARD_WINDOWS.get(name, 0))
    gen = torch.Generator(device=dev).manual_seed(0)
    means = 2 * torch.randn(n_kv, hd, generator=gen, device=dev)

    def kv(n):
        noise = torch.randn(B, n, n_kv, hd, generator=gen, device=dev)
        return (means + 0.1 * noise).to(torch.bfloat16)

    prefixes = [(kv(ctx), kv(ctx)) for _ in range(2)]
    table = tfr.fit_fr_bases(tfr.bf16_to_words(torch.cat(prefixes[0])).reshape(-1), spec.fr)
    caches = []
    for k, v in prefixes:
        cache = tkv.init_compressed(spec, B, table, device=dev)
        tkv.extend(spec, cache, k, v, 0)
        caches.append(cache)
    toks = {pos: [(kv(1), kv(1), torch.randn(B, 1, n_kv * groups, hd, generator=gen, device=dev)
                   .to(torch.bfloat16)) for _ in caches] for pos in (plain_pos, flush_pos)}

    def step(pos):
        outs = []
        for cache, (k, v, q) in zip(caches, toks[pos]):
            tkv.append(spec, cache, k, v, pos)
            outs.append(tkv.attention_decode(spec, q, cache, pos, backend="auto"))
        return outs

    def counters():
        c = obs.snapshot(spans=False)["counters"]
        return {key: c[key] for key in STEP_COUNTERS}

    def checked(pos):
        before = counters()
        with obs.recording():
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs = step(pos)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        after = counters()
        return outs, {key: after[key] - before[key] for key in STEP_COUNTERS}

    t_enc.table_cache_clear()
    t_pa._inv_sqrt.cache_clear()
    before = counters()
    cold = [out.clone() for out in step(plain_pos)]
    torch.cuda.synchronize()
    assert counters()["table_prep.miss"] - before["table_prep.miss"] == 1
    step(flush_pos)

    warm, got = checked(plain_pos)
    flushes = 2 * len(caches) if pt == 1 else 0
    multipage = len(caches) if spec.pages_per_row > 1 else 0
    assert got == {"uploads": 0, "launches.attn": len(caches), "launches.encode": flushes,
                   "table_prep.miss": 0, "launches.attn_multipage": multipage}
    for w, c in zip(warm, cold):
        assert torch.equal(w.view(torch.int16), c.view(torch.int16))
    _, got = checked(flush_pos)
    assert got == {"uploads": 0, "launches.attn": len(caches),
                   "launches.encode": 2 * len(caches), "table_prep.miss": 0,
                   "launches.attn_multipage": multipage}
