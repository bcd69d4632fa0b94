"""Decode rounds over a filled compressed KV cache, in every layer of one
chip's share of a model.

Set-up fills each layer's cache with ``context`` tokens a row through the
program's prefill write (``kv_cache.extend``) and draws every round's tokens
and queries.  The window runs rounds of ``round_steps`` decode steps at
positions ``context ..``; each round is a new set of requests over the
cached prefix, so the mean context does not grow with the program's speed.
Queries lean toward their own token's key (``queries`` in the mix), which
the raw tail holds, so the tail's share of the softmax is large enough that
a wrong merge shows.  Rounds alternate between two draws of tokens and
queries, so a round that wrote nothing would leave the other draw's state
behind.  A step
is ``kv_cache.append`` then ``kv_cache.attention_decode(backend="auto")``
in every layer, ended by a synchronise, as a server that copies each step's
tokens to the host.

The check takes the layers drawn from the seed, and in them the page blobs
each window flush wrote (kernel A: equal, word for word, to the frozen
reference's encode of the same tokens) and the attention output of every
step of their last round (kernel C and the raw-tail merge: against float32
attention over the reference's decode of the same pages and the raw tail).
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

#: draws of tokens and queries that rounds alternate between
VARIANTS = 2


def prefix(st: dict, layer: int) -> torch.Tensor:
    """(2, B, context, Kv, hd) bf16: layer ``layer``'s cached K and V."""
    g, T = st["geom"], st["context"]
    m = st["means"][layer].reshape(2, 1, 1, g.n_kv, g.head_dim)
    return inputs.kv_tokens(m, (2, g.batch, T, g.n_kv, g.head_dim), st["seed"], "prefix", layer)


def setup(cell, seed: int, device: torch.device) -> dict:
    g, tr = cell.geom(), cell.traffic
    T, S, V = tr["context"], tr["round_steps"], VARIANTS
    pt = g.page_tokens
    if T % pt or S % pt or g.n_heads % g.n_kv:
        raise ValueError(f"context {T} and round {S} must be whole pages of {pt} tokens")
    spec = kvc.KVSpec(g.n_kv, g.head_dim, max_len=T + S, fr=program_fr(cell))
    st = {"cell": cell, "geom": g, "spec": spec, "seed": seed, "device": device,
          "context": T, "steps": S, "variants": V}
    L = g.n_layers
    st["means"] = inputs.channel_means(seed, L, g.n_kv, g.head_dim, device)
    first = prefix(st, 0)
    bases, widths = fit_table(cell, table_sample(cell, first[0], first[1]))
    st["table"] = (bases, widths)
    table = BaseTable(bases.to(device), widths.to(device))
    caches = []
    for layer in range(L):
        kv = first if layer == 0 else prefix(st, layer)
        cache = kvc.init_compressed(spec, g.batch, table, device=device)
        kvc.extend(spec, cache, kv[0], kv[1], 0)
        caches.append(cache)
        del kv
    del first
    st["caches"] = caches
    means = st["means"].reshape(1, L, 2, 1, 1, g.n_kv, g.head_dim)
    st["kv"] = [inputs.kv_tokens(means, (S, L, 2, g.batch, 1, g.n_kv, g.head_dim), seed,
                                 "decode", v) for v in range(V)]
    qp = tr["queries"]
    st["q"] = [inputs.queries(st["kv"][v][:, :, 0].float().sub_(means[:, :, 0]), g.n_heads,
                              qp["std"], qp["own_key_logit"], seed, "q", v) for v in range(V)]
    st["args"] = [[[(st["kv"][v][s, layer, 0], st["kv"][v][s, layer, 1], st["q"][v][s, layer])
                    for layer in range(L)] for s in range(S)] for v in range(V)]
    rng = np.random.default_rng(inputs.sub_seed(seed, "check"))
    st["keep"] = sorted(rng.choice(L, size=min(L, tr["check_layers"]), replace=False).tolist())
    # warm up a flush step and a plain one in every layer; positions the
    # window later writes again before any read reaches them
    for s in sorted({pt - 1, 0}, reverse=True):
        for layer in range(L):
            k, v, q = st["args"][V - 1][s][layer]
            kvc.append(spec, caches[layer], k, v, T + s)
            kvc.attention_decode(spec, q, caches[layer], T + s, backend="auto")
    sync(device)
    return st


def window(st: dict, seconds: float, tracer) -> dict:
    spec, caches, args = st["spec"], st["caches"], st["args"]
    T, S, V, dev = st["context"], st["steps"], st["variants"], st["device"]
    pt, keep = st["geom"].page_tokens, set(st["keep"])
    trace_from, trace_n = 2, st["cell"].traffic["trace_steps"]
    layers = range(len(caches))
    kept: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}
    times: list[float] = []
    last = (0, -1)
    start = time.perf_counter()
    deadline, end = start + seconds, start
    r, done = 0, False
    while not done:
        args_v = args[r % V]
        for s in range(S):
            if time.perf_counter() >= deadline:
                done = True
                break
            if len(times) == trace_from:
                tracer.begin()
            pos = T + s
            step_args = args_v[s]
            t0 = time.perf_counter()
            for layer in layers:
                k, v, q = step_args[layer]
                with tracer.span("append"):
                    kvc.append(spec, caches[layer], k, v, pos)
                with tracer.span("attention_decode"):
                    out = kvc.attention_decode(spec, q, caches[layer], pos, backend="auto")
                if layer in keep:
                    kept[(layer, s)] = (out, r)
            sync(dev)
            end = time.perf_counter()
            times.append(end - t0)
            last = (r, s)
            tracer.step("decode", t0, end, pos=pos, flush=(pos + 1) % pt == 0)
            if len(times) == trace_from + trace_n:
                tracer.end()
        r += 1
    return {"times": times, "kept": kept, "last": last, "steps_done": len(times),
            "span_s": end - start}


def work(st: dict, rec: dict) -> tuple[int, int]:
    return rec["steps_done"] * st["geom"].batch, 0


def end_to_end(st: dict, rec: dict) -> dict:
    times = rec["times"]
    if not times:
        return {"decode_tok_s": 0.0, "step_p95_ms": float("nan")}
    return {"decode_tok_s": len(times) * st["geom"].batch / rec["span_s"],
            "step_p95_ms": float(np.percentile(np.asarray(times) * 1e3, 95))}


def release(st: dict, rec: dict) -> None:
    """Keep the checked layers' window page slots and tokens; free the rest."""
    g, T = st["geom"], st["context"]
    p0 = T // g.page_tokens * g.pages_per_row
    p1 = (T + st["steps"]) // g.page_tokens * g.pages_per_row
    st["slots"] = {layer: {side: {k: st["caches"][layer][f"{side}_pages"][k][:, p0:p1].clone()
                                  for k in SLOT_KEYS} for side in "kv"}
                   for layer in st["keep"]}
    st["tokens"] = {layer: [(st["kv"][v][:, layer].clone(), st["q"][v][:, layer].clone())
                            for v in range(st["variants"])] for layer in st["keep"]}
    for key in ("caches", "kv", "q", "args"):
        st.pop(key, None)


def _pages(x: torch.Tensor, g) -> torch.Tensor:
    """(B, T, Kv, hd) bf16 -> (B * T / page_tokens * pages_per_row, page_words) words."""
    return ref_fr.bf16_to_words(x).reshape(-1, g.page_words)


def _roundtrip(x: torch.Tensor, st: dict) -> tuple[dict, torch.Tensor]:
    """The reference's blobs of ``x`` (B, T, Kv, hd) and the bf16 they decode to."""
    g, fr = st["geom"], st["cell"].fr
    bases, widths = (t.to(x.device) for t in st["table"])
    blob = ref_fr.encode_chunked(_pages(x, g), bases, widths, fr)
    dec = ref_fr.decode_chunked(blob, bases, widths, fr)
    return blob, ref_fr.words_to_bf16(dec).reshape(x.shape)


def as_slots(blob: dict, batch: int) -> dict:
    """A reference blob of (batch * n, ...) pages as (batch, n, ...) slots."""
    return {k: blob[k].reshape((batch, -1) + blob[k].shape[1:]) for k in SLOT_KEYS}


def check(st: dict, rec: dict, control: bool = False) -> dict:
    """{name: (value, limit)}: ``blob_words``, the words of the page blobs
    the window's flushes wrote that differ from the reference's encode of the
    same tokens; ``attn_gap``, the widest gap of an output from float32
    attention over the reference's decode of the same pages and the raw tail,
    per unit of max(1, |reference|).  ``control``: the reference over a cache
    rounded through float8 e4m3 stands in the program's place."""
    g, T, S, V = st["geom"], st["context"], st["steps"], st["variants"]
    pt, ppr, limits = g.page_tokens, g.pages_per_row, st["cell"].traffic["limits"]
    r_last, s_last = rec["last"]
    blob_bad, attn_gap = 0, 0.0
    for layer in st["keep"]:
        kv = prefix(st, layer)
        pre = [_roundtrip(kv[i], st)[1] for i in range(2)]
        del kv
        wins = []
        for v in range(V):
            tok, q = st["tokens"][layer][v]             # (S, 2, B, 1, Kv, hd), (S, B, 1, H, hd)
            raw = tok[:, :, :, 0].permute(1, 2, 0, 3, 4).contiguous()   # (2, B, S, Kv, hd)
            rt = [_roundtrip(raw[i], st) for i in range(2)]
            wins.append((raw, rt, q))
        # the page slots of the window, as the last flush of each left them
        for j in range(S // pt):
            r = r_last if (j + 1) * pt - 1 <= s_last else r_last - 1
            if r < 0:
                continue
            raw, rt, _ = wins[r % V]
            for i, side in enumerate("kv"):
                want = as_slots(rt[i][0], g.batch)
                got = (as_slots(_roundtrip(ref_attn.to_fp8(raw[i]), st)[0], g.batch)
                       if control else st["slots"][layer][side])
                sl = slice(j * ppr, (j + 1) * ppr)
                blob_bad += sum(int((got[k][:, sl] != want[k][:, sl]).sum()) for k in SLOT_KEYS)
        # every output the window kept
        for (lay, s), (out, r) in sorted(rec["kept"].items()):
            if lay != layer:
                continue
            raw, rt, q = wins[r % V]
            cut = ((T + s) // pt) * pt - T
            ctx = [torch.cat([pre[i], rt[i][1][:, :cut], raw[i][:, cut:s + 1]], dim=1)
                   for i in range(2)]
            qs = q[s, :, 0]
            ref = ref_attn.attend(qs, ctx[0], ctx[1])
            got = (ref_attn.attend(qs, ref_attn.to_fp8(ctx[0]), ref_attn.to_fp8(ctx[1]))
                   if control else out.reshape(ref.shape).float())
            gap = ((got - ref).abs() / ref.abs().clamp_min(1.0)).max()
            attn_gap = max(attn_gap, float(gap))
    return {"blob_words": (blob_bad, limits["blob_words"]),
            "attn_gap": (attn_gap, limits["attn_gap"])}
