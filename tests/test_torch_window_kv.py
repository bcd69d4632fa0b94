"""Sliding-window layers on the compressed KV path (``KVSpec.window``): the
ring of page slots, the plain kernel's ring mode and the window's masks,
held against the plain float32 windowed reference
(``repro_torch.serving.reference``) on seeded K, V and queries at small
sizes on the CPU, where ``backend="paged"`` runs kernel C's plain version.

Tolerances.  The data is the cache family's (per-channel means N(0, 1) x 2,
tokens N(0, 0.1)), which the codec keeps with no word dropped (each test
checks ``words.dropped``), so the port's attention differs from the
reference's float32 only by rounding.  ``paged`` computes in float32 and
rounds its output to bf16: at most half a bf16 ulp, 2^-8 of |out|, plus
float32 order (``TOL_PAGED``).  ``oracle`` also rounds the probabilities to
bf16 before P.V, as the reference package's oracle does: V's channels keep
their sign across tokens here, so that adds at most another 2^-8 of |out|
(``TOL_ORACLE``).  A gap is |out - ref| / max(1, |ref|), as the benchmark's.

Queries are N(0, 4^2) a channel and lean toward the keys at ``pos`` (the
raw tail), ``pos - W + 1`` (the window's first) and ``pos - W`` (just out of
it), each logit about 8 above the rest, so that serving the window as full
attention, an off-by-one at either end, or reading the slot the latest
flush reused moves the output far past the tolerance.
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from repro_torch import obs
from repro_torch.core import gbdi_fr as tfr
from repro_torch.kernels import gbdi_paged_attn as t_pa
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.reference import window_attention

B = 2
TOL_PAGED = 2 ** -8 + 1e-5
TOL_ORACLE = 2 ** -7 + 1e-5
LEAN_LOGIT = 8.0
FR256 = tfr.FRConfig(word_bits=16, page_words=256, num_bases=14, width_set=(8,),
                     bucket_caps=(256,), outlier_cap=16)
FR128 = tfr.FRConfig(word_bits=16, page_words=128, num_bases=14, width_set=(8,),
                     bucket_caps=(128,), outlier_cap=16)
# (fr, n_kv, hd, groups): page_tokens 4 (a row of 64 words) and 1 (a row of 128)
GEOMS = {"pt4": (FR256, 2, 32, 2), "pt1": (FR128, 2, 64, 1)}
# (geometry, window, tokens): windows a multiple of the page, not one, and
# inside one page; every case runs past three laps of its ring
CASES = {"pt4-multiple": ("pt4", 12, 60), "pt4-not-multiple": ("pt4", 10, 56),
         "pt4-within-a-page": ("pt4", 3, 40), "pt1-window-6": ("pt1", 6, 30)}


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


@dataclasses.dataclass
class Run:
    """Seeded tokens of one layer (2, B, L, Kv, hd) bf16, their noise about
    the channel means, and the table fitted to them."""

    kv: torch.Tensor
    noise_k: torch.Tensor
    table: object
    gen: torch.Generator


def make_run(fr, n_kv: int, hd: int, L: int, seed: int) -> Run:
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(2, 1, 1, n_kv, hd, generator=g) * 2
    kv = (means + 0.1 * torch.randn(2, B, L, n_kv, hd, generator=g)).to(torch.bfloat16)
    table = tfr.fit_fr_bases(tfr.bf16_to_words(kv).reshape(-1), fr)
    return Run(kv, kv[0].float() - means[0], table, g)


def query(run: Run, pos: int, window: int, groups: int) -> torch.Tensor:
    """(B, 1, Kv * G, hd) bf16: N(0, 4^2) plus the leans of the module doc."""
    _, _, n_kv, hd = run.noise_k.shape
    q = torch.randn(B, n_kv, groups, hd, generator=run.gen) * 4
    lean = LEAN_LOGIT / (0.1 ** 2 * math.sqrt(hd))
    for p in {pos, pos - window + 1, pos - window} if window else {pos}:
        if p >= 0:
            q += lean * run.noise_k[:, p, :, None, :]
    return q.reshape(B, 1, n_kv * groups, hd).to(torch.bfloat16)


def gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    out = out.reshape(ref.shape).float()
    return float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max())


def decode_gaps(spec: tkv.KVSpec, run: Run, groups: int, prefix: int, window: int,
                backends=("paged", "oracle")) -> dict[str, float]:
    """Write ``prefix`` tokens by ``extend``, then append and attend at every
    later position: the widest gap of each backend from the reference at
    ``window`` (which may differ from the spec's, to plant a fault)."""
    L = run.kv.shape[2]
    cache = tkv.init_compressed(spec, B, run.table, device="cpu")
    worst = dict.fromkeys(backends, 0.0)
    with obs.recording():
        tkv.extend(spec, cache, run.kv[0, :, :prefix], run.kv[1, :, :prefix], 0)
        for pos in range(prefix, L):
            tkv.append(spec, cache, run.kv[0, :, pos:pos + 1], run.kv[1, :, pos:pos + 1], pos)
            q = query(run, pos, window, groups)
            ref = window_attention(q[:, 0], run.kv[0], run.kv[1], pos, window)
            for be in backends:
                out = tkv.attention_decode(spec, q, cache, pos, backend=be)
                worst[be] = max(worst[be], gap(out, ref))
        assert obs.snapshot(spans=False)["counters"]["words.dropped"] == 0
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_window_layer_matches_reference(case):
    """A prefix longer than the window written by ``extend`` (ending inside
    a page), then an append and a decode at every later position, flush
    steps included, across three or more laps of the ring."""
    geom, window, L = CASES[case]
    fr, n_kv, hd, groups = GEOMS[geom]
    spec = tkv.KVSpec(n_kv, hd, max_len=L, fr=fr, window=window)
    pt, R = spec.page_tokens, spec.n_pages
    assert R == math.ceil(window / pt) and L // pt >= 4 * R
    prefix = window + pt + 1
    got = decode_gaps(spec, make_run(fr, n_kv, hd, L, seed=L + window), groups, prefix, window)
    assert got["paged"] <= TOL_PAGED, got
    assert got["oracle"] <= TOL_ORACLE, got


def _ring_bounds_with(change):
    real = t_pa.ring_bounds

    def patched(S, pos, pt, window):
        n_valid, cur, lo = real(S, pos, pt, window)
        return change(S, pos, pt, n_valid, cur, lo) if window else (n_valid, cur, lo)
    return patched


def _reused_slot_read(S, pos, pt, n_valid, cur, lo):
    """A flush step's reused slot read as the page it now holds, which the
    raw tail holds too: the ring's pages counted up to the current one."""
    if pos % pt == pt - 1:
        return min(S, cur + 1), cur + 1, lo
    return n_valid, cur, lo


#: faults of the ring's masks, planted in ``gbdi_paged_attn.ring_bounds``
RING_FAULTS = {
    "reused_slot_read": _reused_slot_read,
    "lo_one_early": lambda S, pos, pt, n, cur, lo: (n, cur, max(0, lo - 1)),
    "lo_one_late": lambda S, pos, pt, n, cur, lo: (n, cur, lo + 1),
}


@pytest.mark.parametrize("fault", list(RING_FAULTS) + ["served_as_full"])
def test_window_faults_fail_the_tolerance(fault, monkeypatch):
    """The window served as full attention, the reused slot read, and the
    window's first position off by one each way: the paged backend leaves
    the tolerance far behind on the case whose window is not whole pages."""
    geom, window, L = CASES["pt4-not-multiple"]
    fr, n_kv, hd, groups = GEOMS[geom]
    spec = tkv.KVSpec(n_kv, hd, max_len=L, fr=fr, window=window)
    if fault == "served_as_full":
        spec = dataclasses.replace(spec, window=0)
    else:
        monkeypatch.setattr(t_pa, "ring_bounds", _ring_bounds_with(RING_FAULTS[fault]))
    run = make_run(fr, n_kv, hd, L, seed=L + window)
    got = decode_gaps(spec, run, groups, window + 5, window, backends=("paged",))
    assert got["paged"] > 10 * TOL_PAGED, got


def test_ring_bounds_name_the_page_each_slot_holds():
    """Against a replay of every flush: before each decode position, each
    slot read holds the page ``ring_bounds``' formula names, except the slot
    a flush step has just reused, whose named page lies wholly before the
    window; every page of the window's full pages sits in its slot."""
    for pt, window in ((4, 12), (4, 10), (4, 3), (1, 6), (16, 4096)):
        R = math.ceil(window / pt)
        held: dict[int, int] = {}
        for pos in range(0, (4 * R + 3) * pt):
            if pos % pt == pt - 1:                       # the append flushes page pos // pt
                held[(pos // pt) % R] = pos // pt
            n_valid, cur, lo = t_pa.ring_bounds(R, pos, pt, window)
            assert n_valid == min(R, cur) and lo == max(0, pos - window + 1)
            for s in range(n_valid):
                named = cur - 1 - (cur - 1 - s) % R
                if held[s] != named:
                    assert held[s] == cur and pos % pt == pt - 1
                    assert (named + 1) * pt <= lo
            for page in range(lo // pt, cur):
                assert held[page % R] == page


def test_trinity_pattern_of_window_and_full_layers():
    """Four layers as Trinity-Large-Preview lays them out (three sliding,
    then one full), each a cache of its own spec over one table."""
    fr, n_kv, hd, groups = GEOMS["pt4"]
    window, L = 10, 52
    specs = [tkv.KVSpec(n_kv, hd, max_len=L, fr=fr, window=w) for w in (window, window, window, 0)]
    assert [s.n_pages for s in specs] == [3, 3, 3, 13]
    runs = [make_run(fr, n_kv, hd, L, seed=100 + i) for i in range(4)]
    table = runs[0].table
    caches = [tkv.init_compressed(s, B, table, device="cpu") for s in specs]
    prefix = 21
    worst = 0.0
    with obs.recording():
        for spec, cache, run in zip(specs, caches, runs):
            tkv.extend(spec, cache, run.kv[0, :, :prefix], run.kv[1, :, :prefix], 0)
        for pos in range(prefix, L):
            for spec, cache, run in zip(specs, caches, runs):
                tkv.append(spec, cache, run.kv[0, :, pos:pos + 1], run.kv[1, :, pos:pos + 1], pos)
                q = query(run, pos, spec.window, groups)
                ref = window_attention(q[:, 0], run.kv[0], run.kv[1], pos, spec.window)
                worst = max(worst, gap(tkv.attention_decode(spec, q, cache, pos, backend="auto"),
                                       ref))
        snap = obs.snapshot()
    assert snap["counters"]["words.dropped"] == 0
    assert worst <= TOL_PAGED
    # the three window layers each overwrote a slot at every flush past the ring's first lap
    assert snap["counters"]["pages.evicted"] == 3 * (L // 4 - 3)
    assert sum(1 for s in snap["spans"] if s[0] == "kv_cache.window") == 3 * (L - prefix)


def _caches_equal(a: dict, b: dict) -> None:
    for side in "kv":
        for key, t in a[f"{side}_pages"].items():
            assert torch.equal(t, b[f"{side}_pages"][key]), (side, key)
        assert torch.equal(a[f"{side}_tail"].view(torch.int16), b[f"{side}_tail"].view(torch.int16))


@pytest.mark.parametrize("geom,window,splits", [
    ("pt4", 10, (0, 7, 9, 40, 41, 53)),      # a first extend past the ring, one inside a page
    ("pt4", 12, (0, 3, 33, 34, 60)),
    ("pt1", 6, (0, 13, 14, 29, 30)),
    ("wide-row", 5, (0, 9, 11, 24)),         # a row of two pages: slots wrap two at a time
])
def test_extend_equals_appends_bit_for_bit(geom, window, splits):
    """``extend`` over any split leaves the ring, the tail and the evicted
    count as the same tokens appended one by one."""
    if geom == "wide-row":
        fr, n_kv, hd = FR128, 2, 128
    else:
        fr, n_kv, hd, _ = GEOMS[geom]
    L = splits[-1]
    spec = tkv.KVSpec(n_kv, hd, max_len=L, fr=fr, window=window)
    run = make_run(fr, n_kv, hd, L, seed=7 * L)
    appended = tkv.init_compressed(spec, B, run.table, device="cpu")
    for pos in range(L):
        tkv.append(spec, appended, run.kv[0, :, pos:pos + 1], run.kv[1, :, pos:pos + 1], pos)
    evicted = obs.snapshot(spans=False)["counters"]["pages.evicted"]
    assert evicted == max(0, L // spec.page_tokens - spec.n_pages)
    obs.reset()
    extended = tkv.init_compressed(spec, B, run.table, device="cpu")
    for a, b in zip(splits, splits[1:]):
        tkv.extend(spec, extended, run.kv[0, :, a:b], run.kv[1, :, a:b], a)
    _caches_equal(appended, extended)
    assert obs.snapshot(spans=False)["counters"]["pages.evicted"] == evicted
    # and the oracle reads the window back by position
    K, V, valid = tkv.read_full(spec, extended, L - 1)
    assert valid.sum() == min(window, L)
    kv = torch.stack([K, V])[:, :, valid]
    want = run.kv[:, :, valid[:L]]           # the codec dropped no word of these tokens
    assert torch.equal(kv.view(torch.int16), want.view(torch.int16))


def test_ring_compressed_bytes():
    """A window layer keeps ``ceil(W / pt)`` slots a side, no more than
    ``max_len`` needs, and the bytes count the ring and the tail."""
    fr, n_kv, hd, _ = GEOMS["pt4"]
    full = tkv.KVSpec(n_kv, hd, max_len=64, fr=fr)
    ring = tkv.KVSpec(n_kv, hd, max_len=64, fr=fr, window=10)
    page, tail = fr.compressed_bytes_per_page(), 2 * B * 4 * 64 * 2
    assert (full.n_pages, ring.n_pages, ring.n_positions) == (16, 3, 64)
    assert full.compressed_bytes(B) == 2 * B * 16 * page + tail
    assert ring.compressed_bytes(B) == 2 * B * 3 * page + tail
    assert ring.compressed_bytes_upto(B, 8) == 2 * B * 2 * page + tail
    assert ring.compressed_bytes_upto(B, 64) == ring.compressed_bytes(B)
    assert ring.raw_bytes(B) == 2 * B * 10 * 64 * 2
    assert tkv.KVSpec(n_kv, hd, max_len=64, fr=fr, window=100).n_pages == 16
    # Trinity-Large-Preview's window layer on one chip: 256 slots of 3,332 B a side and row
    trinity = tkv.KVSpec(1, 128, max_len=16384, window=4096)
    assert trinity.n_pages == 256
    assert trinity.compressed_bytes(128) == 2 * 128 * (256 * 3332 + 16 * 128 * 2)


def test_resident_decode_and_negative_window_refused():
    with pytest.raises(ValueError, match="resident_decode"):
        tkv.KVSpec(1, 128, max_len=64, resident_decode=True, window=16)
    with pytest.raises(ValueError, match="window"):
        tkv.KVSpec(1, 128, max_len=64, window=-1)


def test_window_past_max_len_is_full_attention():
    """A window no shorter than the cache never wraps: the ring path gives
    the full layer's blobs and outputs bit for bit, so ``window=0`` (the
    default every existing caller keeps) runs the code it ran before."""
    fr, n_kv, hd, groups = GEOMS["pt4"]
    L = 40
    run = make_run(fr, n_kv, hd, L, seed=5)
    outs = []
    caches = []
    for window in (0, L):
        spec = tkv.KVSpec(n_kv, hd, max_len=L, fr=fr, window=window)
        cache = tkv.init_compressed(spec, B, run.table, device="cpu")
        tkv.extend(spec, cache, run.kv[0, :, :13], run.kv[1, :, :13], 0)
        got = []
        for pos in range(13, L):
            tkv.append(spec, cache, run.kv[0, :, pos:pos + 1], run.kv[1, :, pos:pos + 1], pos)
            q = torch.randn(B, 1, n_kv * groups, hd, generator=torch.Generator().manual_seed(pos))
            got.append(tkv.attention_decode(spec, q.to(torch.bfloat16), cache, pos, backend="paged"))
        outs.append(torch.stack(got))
        caches.append(cache)
    _caches_equal(*caches)
    assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))


def test_plain_ring_state_matches_float32_over_its_pages():
    """The plain kernel's ring mode against float32 attention over the
    decoded pages the window reaches, slot by slot, at positions before the
    ring fills, at a flush and after wraps (state within float32 order)."""
    fr, n_kv, hd, groups = GEOMS["pt4"]
    pt, R, window = 4, 5, 18
    run = make_run(fr, n_kv, hd, R * pt, seed=11)
    pages = {}
    for i, side in enumerate("kv"):
        words = tfr.bf16_to_words(run.kv[i]).reshape(-1, fr.page_words)
        blob = tfr.fr_encode(words, run.table, fr)
        pages[side] = {k: v.reshape((B, R) + v.shape[1:]) for k, v in blob.items()
                       if k in tkv.PAGE_KEYS}
    dec = [tfr.words_to_bf16(tfr.fr_decode({k: v.reshape((B * R,) + v.shape[2:])
                                            for k, v in pages[s].items()}, run.table, fr))
           .float().reshape(B, R * pt, n_kv, hd) for s in "kv"]
    q = torch.randn(B, n_kv, groups, hd, generator=torch.Generator().manual_seed(1)) * 4
    for pos in (9, 3 * pt - 1, 7 * pt + 2, 8 * pt - 1, 19 * pt + 1):
        acc, m, l = t_pa.paged_attention_decode_plain(q, pages["k"], pages["v"], run.table, pos,
                                                      fr, n_kv=n_kv, hd=hd, groups=groups,
                                                      chunk_slots=2, window=window)
        n_valid, cur, lo = t_pa.ring_bounds(R, pos, pt, window)
        slot = torch.arange(R * pt) // pt
        page = cur - 1 - torch.remainder(cur - 1 - slot, R)
        tok = page * pt + torch.arange(R * pt) % pt
        live = (slot < n_valid) & (tok >= lo) & (tok < cur * pt)
        logits = torch.einsum("bkgh,btkh->bkgt", q, dec[0]) * t_pa.inv_sqrt(hd, "cpu")
        logits = torch.where(live, logits, t_pa.MASKED)
        m_ref = logits.max(-1).values
        p = torch.where(live, torch.exp(logits - m_ref[..., None]), 0.0)
        torch.testing.assert_close(m, m_ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(l, p.sum(-1), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(acc, torch.einsum("bkgt,btkh->bkgh", p, dec[1]),
                                   rtol=1e-5, atol=1e-5)
