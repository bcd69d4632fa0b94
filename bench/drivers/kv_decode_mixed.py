"""Decode rounds over a filled compressed KV cache in every layer of one
chip's share of a model whose layers mix sliding-window and full attention.

Each layer's cache is built from its ``layer_types`` entry: a
``sliding_attention`` layer is ``KVSpec(window=sliding_window)``, whose
pages live in a ring of ``ceil(W / page_tokens)`` slots; a full layer keeps
every page.  Set-up writes the whole prompt of ``context`` tokens into every
layer through the program's prefill write (``kv_cache.extend``), as a
server's prefill does; a window layer's ring keeps its last pages.  The
window runs rounds of ``round_steps`` decode steps at positions ``context
..``, each round a new set of requests over the cached prefix, as
``kv_decode``.  A round's flushes overwrite ring slots that the next round
reads again, so before each round every window layer's ring slots that a
round writes are restored from a copy taken after the prefill (what a
prefix cache holds for a window layer), outside the step timer.  A step is
``kv_cache.append`` then ``kv_cache.attention_decode(backend="auto")`` in
every layer, ended by a synchronise.

Queries lean toward their own token's key (the raw tail) and, in window
layers, toward the prefix's keys at ``pos - W + 1`` (the window's first)
and ``pos - W`` (just out of it): an edge of the window off by one either
way moves the output by a large share.

The check draws one window layer and one full layer from the seed, and in
them compares the page blobs (kernel A) with the frozen reference's encode
of the same tokens: in a window layer every ring slot as the prefill and
the last flush into it left it, in a full layer the slots the window's
flushes wrote; and every output of the last round (kernel C, the ring's
masks and the raw-tail merge) with float32 attention over the window's
positions (or the whole context) of the reference's decode of the same
pages and the raw tail.  Everything else is ``kv_decode``'s, whose helpers
this driver uses.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import inputs
from bench.common import SLOT_KEYS, fit_table, program_fr, sync, table_sample
from bench.counts.window import SLIDING
from bench.drivers import kv_decode as base
from bench.reference import attention as ref_attn
from bench.reference import window_attention as ref_win
from repro_torch.core.format import BaseTable
from repro_torch.serving import kv_cache as kvc

VARIANTS = base.VARIANTS


def _specs(cell, max_len: int) -> list:
    """Each layer's KVSpec: the window spec is built first, so a program
    without window layers refuses the cell before anything is allocated."""
    c, g = cell.config, cell.geom()
    fr = program_fr(cell)
    window = kvc.KVSpec(g.n_kv, g.head_dim, max_len=max_len, fr=fr, window=c["sliding_window"])
    full = kvc.KVSpec(g.n_kv, g.head_dim, max_len=max_len, fr=fr)
    return [window if t == SLIDING else full for t in c["layer_types"]]


def _ring_slots(st: dict, spec) -> list[int]:
    """The slots a round's flushes write in a window layer's ring."""
    pt, T, S = st["geom"].page_tokens, st["context"], st["steps"]
    ppr = st["geom"].pages_per_row
    return sorted({(p % spec.n_pages) * ppr + j
                   for p in range(T // pt, (T + S) // pt) for j in range(ppr)})


def setup(cell, seed: int, device: torch.device) -> dict:
    g, tr = cell.geom(), cell.traffic
    T, S, V = tr["context"], tr["round_steps"], VARIANTS
    pt = g.page_tokens
    specs = _specs(cell, T + S)
    if len(specs) != g.n_layers:
        raise ValueError(f"{len(specs)} layer_types for {g.n_layers} layers")
    W = cell.config["sliding_window"]
    if T % pt or S % pt or g.n_heads % g.n_kv or T < W:
        raise ValueError(f"context {T} and round {S} must be whole pages of {pt} tokens, "
                         f"the context at least the window ({W})")
    st = {"cell": cell, "geom": g, "specs": specs, "seed": seed, "device": device,
          "context": T, "steps": S, "variants": V}
    L = g.n_layers
    st["means"] = inputs.channel_means(seed, L, g.n_kv, g.head_dim, device)
    first = base.prefix(st, 0)
    bases, widths = fit_table(cell, table_sample(cell, first[0], first[1]))
    st["table"] = (bases, widths)
    table = BaseTable(bases.to(device), widths.to(device))
    caches, edges, saved = [], {}, {}
    for layer in range(L):
        kv = first if layer == 0 else base.prefix(st, layer)
        spec = specs[layer]
        cache = kvc.init_compressed(spec, g.batch, table, device=device)
        kvc.extend(spec, cache, kv[0], kv[1], 0)
        caches.append(cache)
        if spec.window:
            # the keys' noise at positions T - W .. T - W + S, which the queries lean toward
            edges[layer] = kv[0][:, T - W:T - W + S + 1].float() - st["means"][layer, 0]
            idx = _ring_slots(st, spec)
            saved[layer] = {side: {k: t[:, idx].clone() for k, t in cache[f"{side}_pages"].items()}
                            for side in "kv"}
        del kv
    del first
    st["caches"], st["saved"] = caches, saved
    st["ring_slots"] = {layer: torch.tensor(_ring_slots(st, specs[layer]), device=device)
                        for layer in saved}
    means = st["means"].reshape(1, L, 2, 1, 1, g.n_kv, g.head_dim)
    st["kv"] = [inputs.kv_tokens(means, (S, L, 2, g.batch, 1, g.n_kv, g.head_dim), seed,
                                 "decode", v) for v in range(V)]
    qp = tr["queries"]
    st["q"] = [inputs.queries(st["kv"][v][:, :, 0].float().sub_(means[:, :, 0]), g.n_heads,
                              qp["std"], qp["own_key_logit"], seed, "q", v) for v in range(V)]
    lean = qp["edge_logit"] / (inputs.TOKEN_STD ** 2 * g.head_dim ** 0.5)
    for layer, e in edges.items():
        # step s (position T + s) leans toward positions T + s - W + 1 and T + s - W
        edge = (e[:, 1:] + e[:, :-1]).transpose(0, 1)                 # (S, B, Kv, hd)
        edge = edge.repeat_interleave(g.n_heads // g.n_kv, dim=-2).unsqueeze(2)
        for v in range(V):
            qv = st["q"][v]
            qv[:, layer] = (qv[:, layer].float() + lean * edge).to(torch.bfloat16)
    del edges
    st["args"] = [[[(st["kv"][v][s, layer, 0], st["kv"][v][s, layer, 1], st["q"][v][s, layer])
                    for layer in range(L)] for s in range(S)] for v in range(V)]
    rng = np.random.default_rng(inputs.sub_seed(seed, "check"))
    kinds = [[i for i, s in enumerate(specs) if s.window], [i for i, s in enumerate(specs)
                                                            if not s.window]]
    keep = [int(rng.choice(k)) for k in kinds if k]
    st["keep"] = sorted(keep[:tr["check_layers"]])
    # warm up a flush step and a plain one in every layer; positions the
    # window later writes again before any read reaches them, ring slots the
    # first round's restore puts back
    for s in sorted({pt - 1, 0}, reverse=True):
        for layer in range(L):
            k, v, q = st["args"][V - 1][s][layer]
            kvc.append(specs[layer], caches[layer], k, v, T + s)
            kvc.attention_decode(specs[layer], q, caches[layer], T + s, backend="auto")
    _restore(st)
    sync(device)
    return st


def _restore(st: dict) -> None:
    """Every window layer's ring slots that a round writes, as the prefill
    left them."""
    for layer, saved in st["saved"].items():
        idx = st["ring_slots"][layer]
        for side in "kv":
            pages = st["caches"][layer][f"{side}_pages"]
            for k, t in saved[side].items():
                pages[k][:, idx] = t


def window(st: dict, seconds: float, tracer) -> dict:
    specs, caches, args = st["specs"], st["caches"], st["args"]
    T, S, V, dev = st["context"], st["steps"], st["variants"], st["device"]
    pt, keep = st["geom"].page_tokens, set(st["keep"])
    trace_from, trace_n = 2, st["cell"].traffic["trace_steps"]
    layers = range(len(caches))
    kept: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}
    times: list[float] = []
    last = (0, -1)
    restore_s = 0.0
    start = time.perf_counter()
    deadline, end = start + seconds, start
    r, done = 0, False
    while not done:
        args_v = args[r % V]
        for s in range(S):
            if time.perf_counter() >= deadline:
                done = True
                break
            if s == 0 and r:            # round 0's rings were restored in set-up
                t0 = time.perf_counter()
                _restore(st)
                sync(dev)
                restore_s += time.perf_counter() - t0
            if len(times) == trace_from:
                tracer.begin()
            pos = T + s
            step_args = args_v[s]
            t0 = time.perf_counter()
            for layer in layers:
                k, v, q = step_args[layer]
                with tracer.span("append"):
                    kvc.append(specs[layer], caches[layer], k, v, pos)
                with tracer.span("attention_decode"):
                    out = kvc.attention_decode(specs[layer], q, caches[layer], pos, backend="auto")
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
            "span_s": end - start - restore_s}


work = base.work
end_to_end = base.end_to_end


def release(st: dict, rec: dict) -> None:
    """Keep the checked layers' page slots (a window layer's whole ring, a
    full layer's window slots) and tokens; free the rest."""
    g, T = st["geom"], st["context"]
    p0 = T // g.page_tokens * g.pages_per_row
    p1 = (T + st["steps"]) // g.page_tokens * g.pages_per_row
    slots = {}
    for layer in st["keep"]:
        cut = slice(None) if st["specs"][layer].window else slice(p0, p1)
        slots[layer] = {side: {k: st["caches"][layer][f"{side}_pages"][k][:, cut].clone()
                               for k in SLOT_KEYS} for side in "kv"}
    st["slots"] = slots
    st["tokens"] = {layer: [(st["kv"][v][:, layer].clone(), st["q"][v][:, layer].clone())
                            for v in range(st["variants"])] for layer in st["keep"]}
    for key in ("caches", "kv", "q", "args", "saved", "ring_slots"):
        st.pop(key, None)


def _checked_slots(st: dict, rec: dict, layer: int) -> list[tuple[str, int, int, int]]:
    """(source, variant, page, slot) for each slot the check reads: page
    ``page`` of the checked prefix (source ``prefix``) or of a round's
    tokens (``round``, drawn from ``variant``) that slot ``slot`` of the
    kept slots must hold.  A window layer's ring slots a round writes hold
    the last round's flush, or, where that round stopped before it, the
    prefill's page the restore put back; its other slots the prefill's
    pages.  A full layer's window slots hold the last flush into each."""
    g, T, S, V = st["geom"], st["context"], st["steps"], st["variants"]
    pt, spec = g.page_tokens, st["specs"][layer]
    R, first = spec.n_pages, T // pt - spec.n_pages     # the prefill's first page in the ring
    r_last, s_last = rec["last"]
    out = []
    for j in range(S // pt):
        reached = (j + 1) * pt - 1 <= s_last
        r = r_last if reached else r_last - 1
        page = T // pt + j
        if spec.window:
            out.append(("round", r % V, j, page % R) if reached
                       else ("prefix", 0, page - R - first, page % R))
        elif r >= 0:
            out.append(("round", r % V, j, j))
    if spec.window:
        written = {slot for *_, slot in out}
        out += [("prefix", 0, p - first, p % R) for p in range(first, T // pt)
                if p % R not in written]
    return out


def check(st: dict, rec: dict, control: bool = False) -> dict:
    """{name: (value, limit)} as ``kv_decode``'s: ``blob_words`` over every
    ring slot of the window layer and the window's slots of the full layer
    (:func:`_checked_slots`); ``attn_gap`` over every output of the last
    round, against float32 attention over the positions each query reaches.
    ``control``: the reference over a cache rounded through float8 e4m3
    stands in the program's place."""
    g, T, V = st["geom"], st["context"], st["variants"]
    pt, ppr, limits = g.page_tokens, g.pages_per_row, st["cell"].traffic["limits"]
    blob_bad = torch.zeros((), dtype=torch.int64, device=st["device"])
    attn_gap = 0.0
    for layer in st["keep"]:
        spec = st["specs"][layer]
        # a window layer's check reads the prefix from the ring's first page on
        a0 = T - spec.n_pages * pt if spec.window else 0
        kv = base.prefix(st, layer)[:, :, a0:]
        pre = [base._roundtrip(kv[i], st) for i in range(2)]
        blobs = {("prefix", 0): [base.as_slots(pre[i][0], g.batch) for i in range(2)]}
        if control:
            fp8 = {("prefix", 0): [base.as_slots(base._roundtrip(ref_attn.to_fp8(kv[i]), st)[0],
                                                 g.batch) for i in range(2)]}
        del kv
        wins = []
        for v in range(V):
            tok, q = st["tokens"][layer][v]             # (S, 2, B, 1, Kv, hd), (S, B, 1, H, hd)
            raw = tok[:, :, :, 0].permute(1, 2, 0, 3, 4).contiguous()   # (2, B, S, Kv, hd)
            rt = [base._roundtrip(raw[i], st) for i in range(2)]
            wins.append((raw, rt, q))
            blobs[("round", v)] = [base.as_slots(rt[i][0], g.batch) for i in range(2)]
            if control:
                fp8[("round", v)] = [base.as_slots(base._roundtrip(ref_attn.to_fp8(raw[i]), st)[0],
                                                   g.batch) for i in range(2)]
        for source, v, page, slot in _checked_slots(st, rec, layer):
            src = slice(page * ppr, (page + 1) * ppr)
            for i, side in enumerate("kv"):
                want = blobs[(source, v)][i]
                have, at = ((fp8[(source, v)][i], src) if control else
                            (st["slots"][layer][side], slice(slot * ppr, (slot + 1) * ppr)))
                for k in SLOT_KEYS:
                    blob_bad += (have[k][:, at] != want[k][:, src]).sum()
        # every output the window kept, over the positions its query reaches
        for (lay, s), (out, r) in sorted(rec["kept"].items()):
            if lay != layer:
                continue
            raw, rt, q = wins[r % V]
            pos = T + s
            cut = (pos // pt) * pt - T
            ctx = [torch.cat([pre[i][1], rt[i][1][:, :cut], raw[i][:, cut:s + 1]], dim=1)
                   for i in range(2)]
            qs = q[s, :, 0]
            ref = ref_win.window_attention(qs, ctx[0], ctx[1], pos - a0, spec.window)
            got = (ref_win.window_attention(qs, ref_attn.to_fp8(ctx[0]), ref_attn.to_fp8(ctx[1]),
                                            pos - a0, spec.window)
                   if control else out.reshape(ref.shape).float())
            gap = ((got - ref).abs() / ref.abs().clamp_min(1.0)).max()
            attn_gap = max(attn_gap, float(gap))
    return {"blob_words": (int(blob_bad), limits["blob_words"]),
            "attn_gap": (attn_gap, limits["attn_gap"])}
