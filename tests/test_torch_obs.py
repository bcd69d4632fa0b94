"""The port's recorder (``repro_torch.obs``): spans on the KV cache's decode
path, recorded only under ``obs.recording()`` or a torch profiler session;
the ring of the newest spans; the counters that moved into it (launches,
the table memo's hits and misses, blocking uploads, the words a flush
encoded and dropped, a window layer's evicted pages); a window layer's
span."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch._device import upload
from repro_torch.core import gbdi_fr as tfr
from repro_torch.core.format import BaseTable
from repro_torch.kernels import gbdi_encode as t_enc
from repro_torch.kernels import gbdi_paged_attn as t_pa
from repro_torch.serving import kv_cache as tkv

B, KV, HD = 2, 2, 64                      # a row of 128 words: 16 tokens a page
SPEC = tkv.KVSpec(KV, HD, max_len=48)
PT = SPEC.page_tokens


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _cache(table: BaseTable | None = None) -> dict:
    if table is None:
        g = torch.Generator().manual_seed(0)
        words = tfr.bf16_to_words(torch.randn(4096, generator=g))
        table = tfr.fit_fr_bases(words, SPEC.fr)
    return tkv.init_compressed(SPEC, B, table, device="cpu")


def _tokens(n: int, seed: int, scale: float = 1.0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, B, 1, KV, HD, generator=g) * scale).to(torch.bfloat16)


def _steps(cache: dict, ks: torch.Tensor, vs: torch.Tensor, q: torch.Tensor, pos0: int) -> None:
    for s in range(ks.shape[0]):
        tkv.append(SPEC, cache, ks[s], vs[s], pos0 + s)
        tkv.attention_decode(SPEC, q, cache, pos0 + s)


def _names(snap: dict) -> list[str]:
    return [s[0] for s in snap["spans"]]


def _q() -> torch.Tensor:
    return torch.randn(B, 1, 2 * KV, HD, generator=torch.Generator().manual_seed(3))


def test_off_records_no_span():
    cache, ks, vs = _cache(), _tokens(PT, 1), _tokens(PT, 2)
    _steps(cache, ks, vs, _q(), 0)            # the last step flushes a page
    snap = obs.snapshot()
    assert snap["spans"] == [] and snap["spans_dropped"] == 0
    assert obs.span("kv_cache.append") is obs.span("paged_attn")   # the shared no-op
    assert snap["counters"]["words.encoded"] == 2 * B * SPEC.fr.page_words
    assert snap["counters"]["words.dropped"] == 0                  # counted only while recording


def _check_decode_spans(snap: dict) -> None:
    spans = snap["spans"]
    by = {}
    for i, (name, a, b, parent) in enumerate(spans):
        assert a <= b, (name, a, b)
        by.setdefault(name, []).append(i)
        if parent >= 0:
            assert spans[parent][1] <= a and b <= spans[parent][2]
    assert set(by) == {"kv_cache.append", "kv_cache.flush", "kv_cache.attention_decode",
                       "kv_cache.tail_merge"}            # on the CPU: no wrapper, no upload
    assert len(by["kv_cache.append"]) == len(by["kv_cache.attention_decode"]) == PT
    assert len(by["kv_cache.flush"]) == 1 and len(by["kv_cache.tail_merge"]) == PT
    for i in by["kv_cache.flush"]:
        assert spans[spans[i][3]][0] == "kv_cache.append"
    for i in by["kv_cache.tail_merge"]:
        assert spans[spans[i][3]][0] == "kv_cache.attention_decode"
    for i in by["kv_cache.append"] + by["kv_cache.attention_decode"]:
        assert spans[i][3] == -1
    # the calls alternate, the flush inside the last append
    top = [spans[i][0] for i in by["kv_cache.append"] + by["kv_cache.attention_decode"]]
    assert sorted(top) == sorted(["kv_cache.append", "kv_cache.attention_decode"] * PT)


def test_recording_records_the_decode_spans():
    cache, ks, vs = _cache(), _tokens(PT, 1), _tokens(PT, 2)
    with obs.recording():
        _steps(cache, ks, vs, _q(), 0)
    _check_decode_spans(obs.snapshot())
    n = len(obs.snapshot()["spans"])
    tkv.attention_decode(SPEC, _q(), cache, PT - 1)       # recording ended
    assert len(obs.snapshot()["spans"]) == n


def test_a_profiler_session_records_the_decode_spans():
    from torch.profiler import ProfilerActivity, profile

    cache, ks, vs = _cache(), _tokens(PT, 1), _tokens(PT, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(cache, ks, vs, _q(), 0)
    _check_decode_spans(obs.snapshot())
    n = len(obs.snapshot()["spans"])
    _steps(cache, ks[:1], vs[:1], _q(), PT)               # the session ended
    assert len(obs.snapshot()["spans"]) == n


def test_the_ring_keeps_the_newest_spans():
    extra = 5
    with obs.recording():
        for i in range(obs.SPAN_CAP + extra - 2):
            with obs.span(f"s{i}"):
                pass
        with obs.span("outer"):           # its child lands past the ring's end
            with obs.span("inner"):
                pass
    snap = obs.snapshot()
    assert snap["spans_dropped"] == extra
    assert len(snap["spans"]) == obs.SPAN_CAP
    assert snap["spans"][0][0] == f"s{extra}"
    assert [s[0] for s in snap["spans"][-2:]] == ["outer", "inner"]
    assert snap["spans"][-1][3] == obs.SPAN_CAP - 2 and snap["spans"][-2][3] == -1
    obs.reset()
    with obs.recording():
        with obs.span("parent"):
            for i in range(obs.SPAN_CAP):
                with obs.span("child"):
                    pass
    spans = obs.snapshot()["spans"]
    assert spans[-1][0] == "child" and spans[-1][3] == -1     # the parent was overwritten


def test_counters_are_a_fixed_set():
    obs.count("uploads", 2)
    obs.count("uploads")
    assert obs.snapshot(spans=False) == {"counters": {**dict.fromkeys(obs.COUNTERS, 0),
                                                      "uploads": 3}}
    with pytest.raises(KeyError):
        obs.count("uploads.typo")
    obs.reset("uploads")
    assert obs.snapshot(spans=False)["counters"]["uploads"] == 0


def test_device_counts_fold_while_recording(monkeypatch):
    monkeypatch.setattr(obs, "PENDING_CAP", 3)
    obs.count("words.dropped", torch.tensor([7], dtype=torch.int32))   # not recording
    with obs.recording():
        for n in range(1, 8):
            obs.count("words.dropped", torch.tensor([n, 1], dtype=torch.int32))
    assert len(obs._pending) < 3
    assert obs.snapshot(spans=False)["counters"]["words.dropped"] == sum(range(1, 8)) + 7
    assert obs._pending == []


def test_words_dropped_counts_the_flushes_dropped_outliers():
    """A table whose one base sits far from the tokens makes most words of a
    page outliers, past the 64 a page keeps: the recorder counts what the
    encode dropped, page for page as fr_encode does."""
    table = BaseTable(torch.zeros(SPEC.fr.num_bases, dtype=torch.int32),
                      torch.full((SPEC.fr.num_bases,), 8, dtype=torch.int32))
    cache = _cache(table)
    ks, vs = _tokens(2 * PT, 4, 100.0), _tokens(2 * PT, 5, 100.0)
    with obs.recording():
        for s in range(2 * PT):
            tkv.append(SPEC, cache, ks[s], vs[s], s)
    counters = obs.snapshot()["counters"]
    want, pages = 0, 0
    for p in range(2):
        for x in (ks, vs):
            rows = x[p * PT:(p + 1) * PT, :, 0].transpose(0, 1)        # (B, PT, Kv, hd)
            words = tfr.bf16_to_words(rows).reshape(-1, SPEC.fr.page_words)
            blob = tfr.fr_encode(words, table, SPEC.fr)
            want += int(blob["n_dropped"].sum())
            pages += words.shape[0]
            assert (blob["n_out"] == SPEC.fr.outlier_cap).all()
    assert want > 0
    assert counters["words.dropped"] == want
    assert counters["words.encoded"] == pages * SPEC.fr.page_words


WINDOW_SPEC = tkv.KVSpec(KV, HD, max_len=96, window=2 * PT)    # a ring of 2 slots


def test_window_span_nests_under_attention_decode():
    """A window layer's decode opens ``kv_cache.window`` inside
    ``kv_cache.attention_decode``, around the tail merge; a full layer's
    does not, and the existing spans keep their places."""
    cache = tkv.init_compressed(WINDOW_SPEC, B, _cache()["table"], device="cpu")
    ks, vs = _tokens(PT, 1), _tokens(PT, 2)
    with obs.recording():
        for s in range(PT):
            tkv.append(WINDOW_SPEC, cache, ks[s], vs[s], s)
            tkv.attention_decode(WINDOW_SPEC, _q(), cache, s)
    spans = obs.snapshot()["spans"]
    names = [sp[0] for sp in spans]
    assert names.count("kv_cache.window") == names.count("kv_cache.attention_decode") == PT
    for i, (name, a, b, parent) in enumerate(spans):
        if name == "kv_cache.window":
            assert spans[parent][0] == "kv_cache.attention_decode"
            assert spans[parent][1] <= a and b <= spans[parent][2]
        if name == "kv_cache.tail_merge":
            assert spans[parent][0] == "kv_cache.window"
    obs.reset()
    with obs.recording():
        _steps(_cache(), ks, vs, _q(), 0)
    _check_decode_spans(obs.snapshot())


#: a row of 4 x 64 = 256 words over two page slots of 128 words, a token a page
MULTIPAGE_SPEC = tkv.KVSpec(4, HD, max_len=8, fr=tfr.FRConfig(
    word_bits=16, page_words=128, num_bases=14, width_set=(8,), bucket_caps=(128,),
    outlier_cap=16))


def test_multipage_span_nests_under_attention_decode():
    """A layer whose rows span several page slots opens
    ``kv_cache.multipage`` inside ``kv_cache.attention_decode``, around the
    tail merge, once a call; on the CPU no launch is counted, so
    ``launches.attn_multipage`` stays 0 with ``launches.attn``."""
    spec = MULTIPAGE_SPEC
    assert spec.pages_per_row == 2 and spec.page_tokens == 1
    cache = tkv.init_compressed(spec, B, _cache()["table"], device="cpu")
    g = torch.Generator().manual_seed(5)
    ks, vs = (torch.randn(4, B, 1, 4, HD, generator=g).to(torch.bfloat16) for _ in "kv")
    q = torch.randn(B, 1, 8, HD, generator=g)
    with obs.recording():
        for s in range(4):
            tkv.append(spec, cache, ks[s], vs[s], s)
            tkv.attention_decode(spec, q, cache, s)
    snap = obs.snapshot()
    spans = snap["spans"]
    names = [sp[0] for sp in spans]
    assert names.count("kv_cache.multipage") == names.count("kv_cache.attention_decode") == 4
    assert "kv_cache.window" not in names
    for name, a, b, parent in spans:
        if name == "kv_cache.multipage":
            assert spans[parent][0] == "kv_cache.attention_decode"
            assert spans[parent][1] <= a and b <= spans[parent][2]
        if name == "kv_cache.tail_merge":
            assert spans[parent][0] == "kv_cache.multipage"
    assert snap["counters"]["launches.attn_multipage"] == snap["counters"]["launches.attn"] == 0


def test_pages_evicted_counts_flushes_into_a_held_ring_slot():
    """Flushes of the ring's first lap count nothing; each later one counts
    one, whatever the batch, by ``append`` and by ``extend`` alike, and
    while not recording too (an int count); full layers count none."""
    table = _cache()["table"]
    n = 5 * PT                                   # five pages: three past a ring of two
    ks, vs = _tokens(n, 3), _tokens(n, 4)
    cache = tkv.init_compressed(WINDOW_SPEC, B, table, device="cpu")
    for s in range(n):
        tkv.append(WINDOW_SPEC, cache, ks[s], vs[s], s)
        if s == 2 * PT - 1:
            assert obs.snapshot(spans=False)["counters"]["pages.evicted"] == 0
    assert obs.snapshot(spans=False)["counters"]["pages.evicted"] == 3
    obs.reset()
    cache = tkv.init_compressed(WINDOW_SPEC, B, table, device="cpu")
    rows = [x[:, :, 0].transpose(0, 1) for x in (ks, vs)]           # (B, n, Kv, hd)
    tkv.extend(WINDOW_SPEC, cache, rows[0][:, :PT + 3], rows[1][:, :PT + 3], 0)
    tkv.extend(WINDOW_SPEC, cache, rows[0][:, PT + 3:], rows[1][:, PT + 3:], PT + 3)
    assert obs.snapshot(spans=False)["counters"]["pages.evicted"] == 3
    obs.reset()
    _steps(_cache(), ks[:2 * PT], vs[:2 * PT], _q(), 0)
    assert obs.snapshot(spans=False)["counters"]["pages.evicted"] == 0


def test_table_cache_info_reads_the_counters():
    cfg = tfr.FRConfig(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
                       bucket_caps=(64, 192), outlier_cap=16)
    table = BaseTable(torch.arange(6, dtype=torch.int32) * 999,
                      torch.tensor([4, 8, 4, 8, 4, 8], dtype=torch.int32))
    t_enc.table_cache_clear()
    t_enc.prepare_table(table, cfg, torch.device("cpu"))
    t_enc.prepare_table(table, cfg, torch.device("cpu"))
    assert t_enc.table_cache_info() == {"hits": 1, "misses": 1, "size": 1}
    counters = obs.snapshot(spans=False)["counters"]
    assert (counters["table_prep.hit"], counters["table_prep.miss"]) == (1, 1)
    t_enc.table_cache_clear()
    assert t_enc.table_cache_info() == {"hits": 0, "misses": 0, "size": 0}


@pytest.mark.parametrize("data, dtype", [
    (3, torch.int32),
    ([1, 2, 3, 4], torch.int32),
    (np.float32(1) / np.sqrt(np.float32(96)), torch.float32),
])
def test_upload_on_the_cpu_is_torch_tensor_and_counts_nothing(data, dtype):
    with obs.recording():
        got = upload(data, dtype=dtype, device="cpu")
        got_dev = upload(data, dtype=dtype, device=torch.device("cpu"))
    want = torch.tensor(data, dtype=dtype, device="cpu")
    for g in (got, got_dev):
        assert g.dtype == want.dtype and g.shape == want.shape and torch.equal(g, want)
    snap = obs.snapshot()
    assert snap["counters"]["uploads"] == 0 and snap["spans"] == []


def test_the_three_upload_sites_give_what_they_gave():
    """class_indices, kernel_meta and inv_sqrt, through the helper, equal
    their old torch.tensor forms bit for bit."""
    from repro_torch.core.format import class_indices

    widths = torch.tensor([4, 8, 5, 8], dtype=torch.int32)
    want = torch.full(widths.shape, 2, dtype=torch.int32)
    for i, w in enumerate((4, 8)):
        want = torch.where(widths == w, torch.tensor(i, dtype=torch.int32), want)
    assert torch.equal(class_indices(widths, (4, 8)), want)
    cfg = tkv.KV_FR
    caps = [c for prof in cfg.profiles for c in prof]
    offs = [o for p in range(cfg.num_profiles) for o in cfg.class_lane_offsets_for(p)]
    cost8 = [8 * cfg.compressed_bytes_for_profile(p) for p in range(cfg.num_profiles)]
    assert torch.equal(t_enc.kernel_meta(cfg, torch.device("cpu")),
                       torch.tensor(caps + offs + cost8, dtype=torch.int32))
    for hd in (64, 96, 128, 267):
        scale = np.float32(1) / np.sqrt(np.float32(hd))
        got = t_pa.inv_sqrt(hd, "cpu")
        assert got.dtype == torch.float32 and got.item() == float(scale)
