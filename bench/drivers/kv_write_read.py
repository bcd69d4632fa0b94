"""Whole-cache writes and reads of a compressed KV cache, in every layer of one
chip's share of a model: the prefill's cache write and the read-back that
offload, migration and a resident decode region need.

Set-up draws each layer's K and V for ``context`` tokens a row and fits the
base table.  The window runs pairs of operations, each ended by a
synchronise: a write, ``kv_cache.extend`` from position 0 in every layer,
then a read, ``kv_cache.read_full`` of every layer.  Write ``i`` puts source
layer ``(l + i) % layers`` into cache layer ``l``, so every write changes
every page and a write that did nothing would leave the last one's data
(or the warm-up's, drawn apart).

The check takes the layers and the page slots drawn from the seed: the
blobs the last write left (kernel A: equal, word for word, to the frozen
reference's encode of the same source pages) and the words the last read
returned there (kernel B: equal to the reference's decode of those blobs,
and to the raw tokens where the tail ring overlays the last page).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import inputs
from bench.common import SLOT_KEYS, fit_table, program_fr, sync, table_sample
from bench.reference import attention as ref_attn
from bench.reference import fr as ref_fr
from repro_torch.core.format import BaseTable
from repro_torch.serving import kv_cache as kvc


def source(st: dict, layer: int, tag: str = "source") -> torch.Tensor:
    """(2, B, context, Kv, hd) bf16: source layer ``layer``'s K and V."""
    g, T = st["geom"], st["context"]
    m = st["means"][layer].reshape(2, 1, 1, g.n_kv, g.head_dim)
    return inputs.kv_tokens(m, (2, g.batch, T, g.n_kv, g.head_dim), st["seed"], tag, layer)


def setup(cell, seed: int, device: torch.device) -> dict:
    g, tr = cell.geom(), cell.traffic
    T = tr["context"]
    if T % g.page_tokens:
        raise ValueError(f"context {T} must be whole pages of {g.page_tokens} tokens")
    spec = kvc.KVSpec(g.n_kv, g.head_dim, max_len=T, fr=program_fr(cell))
    st = {"cell": cell, "geom": g, "spec": spec, "seed": seed, "device": device, "context": T}
    L = g.n_layers
    st["means"] = inputs.channel_means(seed, L, g.n_kv, g.head_dim, device)
    st["src"] = [source(st, layer) for layer in range(L)]
    bases, widths = fit_table(cell, table_sample(cell, st["src"][0][0], st["src"][0][1]))
    st["table"] = (bases, widths)
    table = BaseTable(bases.to(device), widths.to(device))
    st["caches"] = [kvc.init_compressed(spec, g.batch, table, device=device) for _ in range(L)]
    rng = np.random.default_rng(inputs.sub_seed(seed, "check"))
    st["keep"] = sorted(rng.choice(L, size=min(L, tr["check_layers"]), replace=False).tolist())
    n_slots = T // g.page_tokens * g.pages_per_row
    n = min(g.batch * n_slots, tr["check_pages"])
    st["pages"] = {side: torch.as_tensor(np.sort(rng.choice(g.batch * n_slots, n, replace=False)))
                   for side in "kv"}
    # warm up both operations from a source no window write uses, so that a
    # write which left a slot as it was shows in the check
    warm = source(st, 0, "warm-up")
    for cache in st["caches"]:
        kvc.extend(spec, cache, warm[0], warm[1], 0)
        kvc.read_full(spec, cache, T - 1)
    del warm
    sync(device)
    return st


def window(st: dict, seconds: float, tracer) -> dict:
    spec, caches, T, dev = st["spec"], st["caches"], st["context"], st["device"]
    keep, L = set(st["keep"]), len(caches)
    trace_from, trace_n = 2, st["cell"].traffic["trace_ops"]
    writes: list[float] = []
    reads: list[float] = []
    kept: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
    deadline = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < deadline:      # whole pairs: a write, then a read of it
        i += 1
        if 2 * i - 2 == trace_from:
            tracer.begin()
        t0 = time.perf_counter()
        for layer in range(L):
            src = st["src"][(layer + i) % L]
            with tracer.span("extend"):
                kvc.extend(spec, caches[layer], src[0], src[1], 0)
        sync(dev)
        t1 = time.perf_counter()
        for layer in range(L):
            with tracer.span("read_full"):
                K, V, _ = kvc.read_full(spec, caches[layer], T - 1)
            if layer in keep:
                kept[layer] = (K, V)
        sync(dev)
        t2 = time.perf_counter()
        writes.append(t1 - t0)
        reads.append(t2 - t1)
        tracer.step("write", t0, t1)
        tracer.step("read", t1, t2)
        if 2 * i >= trace_from + trace_n:
            tracer.end()
    return {"writes": writes, "reads": reads, "kept": kept, "last_write": i,
            "steps_done": len(writes) + len(reads)}


def work(st: dict, rec: dict) -> tuple[int, int]:
    return rec["steps_done"], 0


def _raw_bytes(st: dict) -> int:
    """bf16 bytes of K and V in every layer: what one write takes in and one
    read returns."""
    g = st["geom"]
    return 2 * g.n_layers * g.batch * st["context"] * g.row_words * 2


def end_to_end(st: dict, rec: dict) -> dict:
    gib = _raw_bytes(st) / (1 << 30)
    w, r = rec["writes"], rec["reads"]
    return {"kv_write_gib_s": len(w) * gib / sum(w) if w else 0.0,
            "kv_read_gib_s": len(r) * gib / sum(r) if r else 0.0}


def release(st: dict, rec: dict) -> None:
    """Keep the checked layers' sampled slots and read words; free the rest."""
    pw = st["geom"].page_words
    idx = {side: st["pages"][side].to(st["device"]) for side in "kv"}
    st["slots"], st["read"] = {}, {}
    for layer in st["keep"]:
        cache = st["caches"][layer]
        st["slots"][layer] = {side: {k: t.flatten(0, 1)[idx[side]]
                                     for k, t in cache[f"{side}_pages"].items() if k in SLOT_KEYS}
                              for side in "kv"}
        K, V = rec["kept"][layer]
        st["read"][layer] = {side: ref_fr.bf16_to_words(x).reshape(-1, pw)[idx[side]]
                             for side, x in (("k", K), ("v", V))}
    rec["kept"].clear()
    for key in ("caches", "src"):
        st.pop(key, None)


def check(st: dict, rec: dict, control: bool = False) -> dict:
    """{name: (value, limit)}: ``blob_words``, words of the sampled slots'
    blobs that differ from the reference's encode of the source pages the
    last write put there; ``read_words``, words the read after it returned
    at those slots that differ from the reference's decode of its own blobs
    (raw tokens where the tail ring overlays the last page).  ``control``:
    the reference on the source rounded through float8 e4m3 stands in the
    program's place."""
    g, T, fr = st["geom"], st["context"], st["cell"].fr
    limits = st["cell"].traffic["limits"]
    bases, widths = (t.to(st["device"]) for t in st["table"])
    n_slots = T // g.page_tokens * g.pages_per_row
    tail_first = (T - 1) // g.page_tokens * g.pages_per_row    # slots the tail ring overlays
    blob_bad = read_bad = 0
    for layer in st["keep"]:
        src = source(st, (layer + rec["last_write"]) % g.n_layers)
        for si, side in enumerate("kv"):
            idx = st["pages"][side].to(st["device"])
            raw = ref_fr.bf16_to_words(src[si]).reshape(-1, g.page_words)[idx]
            want = ref_fr.encode_chunked(raw, bases, widths, fr)
            expect = ref_fr.decode_chunked(want, bases, widths, fr)
            expect = torch.where(((idx % n_slots) >= tail_first)[:, None], raw, expect)
            if control:
                low = ref_fr.bf16_to_words(ref_attn.to_fp8(ref_fr.words_to_bf16(raw)))
                got = ref_fr.encode_chunked(low, bases, widths, fr)
                got_words = ref_fr.bf16_to_words(ref_attn.to_fp8(ref_fr.words_to_bf16(expect)))
            else:
                got, got_words = st["slots"][layer][side], st["read"][layer][side]
            blob_bad += sum(int((got[k] != want[k]).sum()) for k in SLOT_KEYS)
            read_bad += int((got_words != expect).sum())
    return {"blob_words": (blob_bad, limits["blob_words"]),
            "read_words": (read_bad, limits["read_words"])}
