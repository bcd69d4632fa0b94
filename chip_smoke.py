#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports the port (``src/repro_torch``) and nothing of the JAX package.
Phases, in order; any failure exits non-zero before the final line:

1. the card: name, count, power limit; build the three kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and print what ``-Xptxas -v`` reports;
2. encode and decode against their plain PyTorch versions on the card, bit
   for bit: every page of the two codec streams (in chunks), an adaptive
   multi-profile config, a forced spill/drop page set, a set of 30-base
   tables with ties, dead entries and wrapping deltas (16- and 32-bit
   words), the golden-CRC pages of the format's serialization, (decode
   only) blobs the encoder never writes, per word width, and the gradient
   ring's ``GRAD_FR`` (one 8-bit class, one 2,048-word bucket): bf16
   gradient words, and pages whose every word is an outlier past the cap;
3. the codec path through ``repro_torch.eval.run.evaluate_cell`` at 256 MiB
   per stream: ``ml_kvcache_bf16`` (16-bit config) and ``605.mcf_s`` (32-bit
   config), fit -> encode -> decode -> verify (mismatched words <= dropped),
   with each kernel's launch counter set to 0 just before and read after;
4. per codec kernel and stream: the kernel's time (CUDA events, warmed,
   median), its bytes bound on this card, and the plain version's time.  No
   single PyTorch call computes either function (``library_ms`` is null);
5. the paged-attention kernel against its plain version: the serving
   path's Llama-3-405B layer at full size, a Mixtral-8x22B layer, a
   4-token page, an adaptive two-profile config, a position where every
   page is masked, and a 512-channel head that the kernel splits into two
   channel chunks (tolerances at ``ATTN_TOL``); first, on every page
   slot of each case, its private batched page decode against the decode
   kernel, bit for bit (``gbdi_paged_attn.decode_pages``, which counts no
   launch);
6. the serving path through ``KVSession`` at the attention-layer width of
   Llama-3-405B (8 KV heads of 128, 128 query heads), batch 8, 32,768
   tokens, ``KV_FR``: prefill 32,760 tokens, then 7 decode steps, once with
   a plain spec (auto -> paged: encode + paged attention) and once with
   ``resident_decode`` (auto -> resident: encode + decode), every launch
   counter set to 0 just before and read after; the two backends' outputs
   agree to bf16 tolerance and ``read_full`` matches the raw K/V on > 98 %
   of words;
7. times: the paged-attention kernel at the phase-6 shape (CUDA events,
   warmed, median), its bound, its plain version, and as the library
   yardstick ``scaled_dot_product_attention`` over the same context held
   as a raw bf16 cache; then decode-all + that SDPA call, and the per-step
   latency (append + attend) of the paged, resident and oracle backends
   at contexts of 4,096 and 32,768; (b) the ring instantiation of the
   paged-attention kernel (a sliding-window layer) at :data:`RING`, against
   its plain version at each position, launches counted, and timed as above
   beside its plain version and SDPA (:func:`ring_attention`); in both 7
   (at :data:`CELL`, a full layer of the mixtral decode cell) and 7 (b), the
   kernel's tail form (the raw tail merged in C's merge kernel) against
   its plain version and against unfused C followed by the eager tail
   merge, within one bf16 ulp (a dropped or mis-masked tail shown to miss
   by more), its launches counted, and timed against the unfused pair with
   the host included (:func:`tail_form`); (c) kernel C over rows that span
   two page slots at :data:`MULTIPAGE`, the deepseek-7b decode cell's
   geometry (:func:`multipage_attention`): the state form against its plain
   version at the cell's first and last positions, timed beside its bound,
   its plain version and SDPA, the tail form as in 7 (a dropped tail and the
   head groups' slots swapped shown to miss), every launch counted in
   ``launches.attn_multipage``.  Phases 5, 7
   and 7 (b) also hold ``launches.attn_sliced`` to the rule of
   ``gbdi_paged_attn.token_slices``: a sliced launch where a shape takes more
   than one token slice (7 (b), the decode cells' G 6), none at the serving
   shape of 7;
8. the paper's suite (:func:`paper_suite`): every registered family (the
   twelve dump families, the four model-backed ML families, trained on the
   card, and ``ml_kvcache_bf16``) x {gbdi, bdi, fr} at 1 MiB fitted on the
   CPU's plain path, the model carried to the card, blobs, sizes and decodes
   held to the CPU's; ``evaluate(suite="all")`` on the card at 16 MiB per
   family with the card's fit (51 cells, all verified, the table with
   per-kind geomeans and the CSV lines); the 15 sweep configs (static and
   adaptive4) over ``605.mcf_s`` and ``ml_kvcache_bf16`` at 1 MiB, card
   blobs against the CPU's on carried tables, then the sweep's rows; the
   throughput rows of gbdi, bdi and fr at 16 MiB over the reference's five
   families; the launch counters of encode and decode set to 0 before the
   phase and read after, and the phase's wall time;
9. real dumps (:func:`dump_suite`): deepseek-7b at its published width with
   its depth cut to 2 layers is initialised on the card; the ingestion
   corpus of ``tests/ingest_corpus.py`` goes through the port's ingest CLI,
   beside a capture of this process (256 MiB at most) and a
   ``capture_pytree`` of that model's 2.49 GB of bf16 parameters sampled to
   256 MiB; ``evaluate(suite="dump")`` on the card at 16 MiB a family over
   gbdi, bdi and fr, every cell verified, then every dump family held to the
   CPU at 1 MiB on carried models; launches counted;
10. the model-backed ML families (:func:`ml_families`): the reduced model
   from one CPU init trained on the card and on the CPU (gradients at cosine
   >= 0.99, each family's ratio within 2 %); then the full-width model: one
   ``TokenPipeline`` batch (4 x 32), loss + backward and two AdamW steps,
   each timed, the four families at 256 MiB x {gbdi, bdi, fr} (verified,
   ratio, GiB/s), and three greedy decode steps through ``prefill`` and
   ``decode_step``; launches counted;
11. serving: (a) the scheduler suite's narrow float32 model from one CPU
   init carried to the card: the card's ``Engine`` gives the CPU's greedy
   tokens for a batched, a mid-decode and a mixed-length admit, and 30
   seeded submit/park/step ``Scheduler`` programs leave every request
   token-equal to its solo run on the card (:func:`serving_parity`); (b)
   the phase-9 full-width model behind ``Engine(batch_slots=8,
   max_len=128)`` and a ``Scheduler`` per accounting at a budget of 6 raw
   sequences, 10 requests filling the cache plus a late priority-1 one:
   peak resident 6 raw against 7 compressed, tokens/s, TTFT, ms a tick
   (:func:`serving_full_width`); (c) ``decode_microbench_torch --quick``
   and ``bench_kvcache_torch`` on the card (:func:`serving_scripts`), which
   launch kernels A, B and C; launches counted over the phase;
12. the front-end and the training path: (a) the ``ml_kvcache_bf16`` pages
   as a pinned host stream in 16 batches through ``encode_stream`` and
   ``decode_stream``, bit for bit against one kernel call, timed against a
   serial copy-then-encode, and ``devices=2`` / ``encode_pages_sharded(
   devices=3)`` on the one card (:func:`front_end`); (b) ``Trainer`` on
   deepseek-7b at full width (2 layers): 4 steps with GBDI checkpoints and
   the FR refit every 2, a run crashed at step 3 and resumed, crc32-equal to
   the uninterrupted one (:func:`full_width_trainer`); (c) two gloo ranks on
   the card, the compressed gradient ring against ``plain_pod_mean`` and one
   ``make_train_step(compress_grads=True)`` step (:func:`ring_on_card`);
   (d) ``bench_throughput_torch --quick``, ``bench_gradcomp_torch``,
   ``gradient_compression_demo_torch`` and ``launch.train`` killed and rerun,
   as subprocesses (:func:`slice_scripts`); launches counted in this process and
   read back from the ring's ranks;
13. the model zoo (:func:`model_zoo`): mixtral-8x22b, qwen3-moe-235b-a22b,
   zamba2-7b, xlstm-1.3b, paligemma-3b and musicgen-large, one at a time:
   (a) a narrow float32 copy card vs CPU on one carried init (logits, loss,
   prefill, a decode step); (b) at the published width with the depth of
   :data:`ZOO`, loss + backward and two in-place AdamW steps (finite, ms,
   peak memory); (c) prefill, three decode steps, serving consistency, and
   for the MoE, hybrid and ssm configs three requests through ``Engine``;
   (d) the trained parameters and serving caches captured as ``dump:``
   families, ``evaluate(suite="dump")`` over gbdi, bdi and fr (kernels A and
   B), each family held to the CPU; (e) kernel C in a ``KVSession`` at the
   attention geometries of mixtral, qwen3, paligemma, musicgen and
   deepseek-7b (a row over two page slots; one layer at full width, built
   for this step alone) over layer 0's K/V of a 2,048-token prompt, against
   its plain version and SDPA, timed, ``launches.attn_multipage`` equal to
   ``launches.attn`` for deepseek-7b and 0 for the rest; zamba2's
   ``KVSpec`` refused.  Launches counted over the sessions and the dump
   suite;
14. the launch tools: (a) ``repro_torch.launch.dryrun`` on this machine's
   host (fake tensors, nothing allocated) for every config at decode_32k and
   long_500k (the reference's skips) and deepseek-7b at train_4k and
   prefill_32k, both meshes, each cell's seconds and the ``roofline_torch``
   tables printed, and every parameter leaf of every config dividing under
   both meshes (:func:`dryrun_cells`); (b) deepseek-7b at full width (2
   layers): one ``make_train_step`` step at 4 x 32, one prefill at 8 x 128
   and one batch-8 decode step, each counted under ``FakeTensorMode`` and
   live on the card (equal), timed, its share bound / time held to
   :data:`SHARE_MAX` (:func:`count_on_card`); (c) a world of one under NCCL:
   ``distribute_tree`` and ``ckpt.load(shardings=(mesh, specs))`` on a
   (1, 1) mesh, crc32-equal to a plain load (:func:`dtensor_on_card`); (d)
   the worked example's page through kernels A and B, held to their plain
   versions and to the worked example's bytes (:func:`worked_example_on_card`);
   launches counted over (d);
15. the analysis gate (:func:`analysis_gate`): (a) ``python -m
   repro_torch.analysis`` over this checkout with ``analysis-baseline-torch.json``
   (no new finding, no stale entry; the count a checker, ``--list-checks``);
   (b) the shared-memory and occupancy model of kernels A, B and C at each
   representative config, with the libraries' own shared bytes, the
   runtime's blocks an SM and ``-Xptxas -v``'s registers and spills, printed
   beside the card's name and power limit (formula = library, model blocks
   >= runtime blocks, every row ok); (c) kernels A and B at each codec config
   of the report on seeded pages, bit for bit against their plain versions,
   and kernel C at each attention geometry within ``ATTN_TOL``; launches
   counted over (c).

It ends with one ``{"kernels": [...]}`` line (the paged-attention kernel's
ring instantiation on a row of its own, ``gbdi_paged_attn.ring``, and its
rows over two page slots on another, ``gbdi_paged_attn.multipage``), then
the ``{"ok": true, ...}`` line.  Exit code 2: no CUDA device.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

STREAM_BYTES = 256 << 20
#: phase 8: per-family bytes of the card-vs-CPU checks and of the sweep, and
#: of the full suite (4x the 4 MiB of benchmarks/bench_compression.py)
CHECK_BYTES = 1 << 20
SUITE_BYTES = 16 << 20
#: phases 9-10: the cap of a process capture, the sample of a parameter-tree
#: capture and the size of the full-width model's family streams (the codec
#: path's 256 MiB)
CAPTURE_BYTES = 256 << 20
#: phases 9-10: deepseek-7b at its published width, depth cut to two layers
#: (1.244e9 parameters, 2.49 GB in bf16)
FULL_ARCH, FULL_LAYERS = "deepseek-7b", 2
CHUNK_PAGES = 4096
TIMING_REPEATS = 10
GOLDEN_CRCS = [3381184247, 1710504446, 3996448536]
#: integer instructions per second the card can issue at most: the data
#: sheet's 67 TFLOP/s float32 counts a fused multiply-add as two operations
INT_OPS_S = 33.5e12
#: float32 operations per second outside the tensor cores (H100 SXM data sheet)
F32_OPS_S = 67e12
#: kernel vs plain paged attention, both float32 summed in other orders over up
#: to 32K tokens: max |acc/l - plain|, |m - m_p| / (1 + |m_p|), |l - l_p| / l_p
ATTN_TOL = {"out": 1e-4, "m": 1e-5, "l": 1e-4}
#: the serving path: Llama-3-405B's attention layer (src/repro/configs/llama3_405b.py:
#: n_kv_heads 8, head_dim 16384 / 128 = 128, 128 query heads), batch 8, 32,768 tokens
SERVE = {"batch": 8, "n_kv": 8, "hd": 128, "heads": 128, "max_len": 32768, "prefill": 32760,
         "steps": 7}
#: phase 7 (b): kernel C's ring instantiation at the benchmark cell
#: trinity-large-preview.decode-16k's geometry (one chip's share under 8-way
#: tensor parallelism: 1 KV head of 128, 6 query heads, 16-token pages), batch
#: 128, a window of 4,096 tokens in a ring of 256 page slots; positions before
#: the ring fills, at a page's first token, at a flush and mid-page once the
#: ring has wrapped nearly four times (the times at the last)
RING = {"batch": 128, "n_kv": 1, "hd": 128, "groups": 6, "window": 4096,
        "positions": (3207, 16320, 16383, 16360)}
#: phase 7: kernel C's tail form at a full layer of the benchmark cell
#: mixtral-8x22b.decode-32k (one chip's share: 1 KV head of 128, 6 query
#: heads, 16-token pages), batch 32 over 2,048 page slots, at a position whose
#: tail holds 9 tokens
CELL = {"batch": 32, "n_kv": 1, "hd": 128, "groups": 6, "slots": 2048, "pos": 32760}
#: phase 7 (c): kernel C over rows that span two page slots, at the benchmark
#: cell deepseek-7b.decode-4k's geometry (32 KV heads of 128, one query head a
#: KV head: a 4,096-word row over two 2,048-word slots of 16 heads each),
#: batch 32 over 4,096 tokens a row, at the first and the last position of the
#: cell's rounds (the times at the last)
MULTIPAGE = {"batch": 32, "n_kv": 32, "hd": 128, "groups": 1, "tokens": 4096,
             "positions": (4032, 4095)}
#: phase 7 (c): tokens a row the plain version decodes at once (2 x 32 x 512
#: page slots of K and V)
MULTIPAGE_PLAIN_CHUNK = 512
SEED = 12


def log(*args: object) -> None:
    print(*args, flush=True)


#: the launch counters of repro_torch.obs, by the kernel module that counts them
LAUNCH_COUNTERS = {"gbdi_encode": "launches.encode", "gbdi_decode": "launches.decode",
                   "gbdi_paged_attn": "launches.attn"}


def launch_counts(*mods: str) -> dict[str, int]:
    """Kernel launches counted so far, by kernel module."""
    from repro_torch import obs

    counters = obs.snapshot(spans=False)["counters"]
    return {m: counters[LAUNCH_COUNTERS[m]] for m in mods}


def sliced_launches() -> int:
    """Kernel C launches counted so far whose attention ran in token slices."""
    from repro_torch import obs

    return obs.snapshot(spans=False)["counters"]["launches.attn_sliced"]


def reset_launches(*mods: str) -> None:
    from repro_torch import obs

    obs.reset(*(LAUNCH_COUNTERS[m] for m in mods))


def handmade_blobs(cfg, n_pages: int, seed: int):
    """(blob, bases, widths) as numpy int32 arrays of blobs the encoder never
    writes: random ptr and delta lanes, every code 0 (the first base, class
    0) on a quarter of the pages, full-int32 outlier values, outlier indices
    strictly rising in the page, rising through negative and off-page
    values, random (repeating, falling) or all one index, n_out from -3 to
    cap + 3, profile ids from -1 to num_profiles, and table entries of a
    width outside the width set."""
    import numpy as np

    rng = np.random.default_rng(seed)
    P, cap, nb = cfg.page_words, cfg.outlier_cap, cfg.num_bases

    def u32(*shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)

    bases = rng.integers(0, 1 << 16, nb).astype(np.int32) if cfg.word_bits == 16 else u32(nb)
    widths = rng.choice(list(cfg.width_set) + [3], nb).astype(np.int32)
    widths[0] = cfg.width_set[0]
    ptrs = u32(n_pages, cfg.ptr_lanes)
    ptrs[::4] = 0
    q = n_pages // 4
    idx = np.concatenate([
        np.sort(rng.random((q, P)).argsort(axis=1)[:, :cap], axis=1),
        np.sort(rng.random((q, P + 16)).argsort(axis=1)[:, :cap], axis=1) - 8,
        rng.integers(-8, P + 8, (q, cap)),
        np.repeat(rng.integers(0, P, (n_pages - 3 * q, 1)), cap, axis=1),
    ])
    blob = {"ptrs": ptrs, "deltas": u32(n_pages, cfg.delta_lanes), "out_vals": u32(n_pages, cap),
            "out_idx": idx[rng.permutation(n_pages)].astype(np.int32),
            "n_out": rng.integers(-3, cap + 4, n_pages).astype(np.int32)}
    if cfg.num_profiles > 1:
        blob["profile"] = rng.integers(-1, cfg.num_profiles + 1, n_pages).astype(np.int32)
    return blob, bases, widths


def blob_diff(a: dict, b: dict) -> list[str]:
    """Names of the fields where two codec blobs differ (tensors compared on
    the host, ints and configs by value; keys starting with ``_`` skipped)."""
    import torch

    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        if k.startswith("_"):
            continue
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            same = x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        else:
            same = x == y
        if not same:
            bad.append(k)
    return bad


def attn_errors(acc, m, l, pacc, pm, pl) -> dict:
    """Kernel C's (acc, m, l) against the plain version's, as ``ATTN_TOL``
    bounds them: max |acc/l - plain| over rows with a valid token, |m - m_p|
    / (1 + |m_p|), |l - l_p| / l_p.  Raises if a row with no valid token is
    not (0, -1e30, 0)."""
    from repro_torch.kernels import gbdi_paged_attn as pa_mod

    live = pl > 0
    dead = ~live
    if not ((m[dead] == pa_mod.MASKED).all() and (l[dead] == 0).all()
            and (acc[dead] == 0).all()):
        raise AssertionError("a row with no valid token is not (0, -1e30, 0)")
    return {"out": float((acc[live] / l[live][:, None] - pacc[live] / pl[live][:, None])
                         .abs().max()) if live.any() else 0.0,
            "m": float(((m - pm).abs() / (1 + pm.abs())).max()),
            "l": float(((l - pl).abs() / pl)[live].max()) if live.any() else 0.0}


def bf16_ulps(got, want):
    """``|got - want|`` elementwise in bf16 ulps of ``max(1, |want|)``: the
    resolution at which the benchmark's ``attn_gap`` (``|d| / max(1, |ref|)``)
    reads an output, so a rounding flip counts one and a near-zero output's
    float32 noise counts next to nothing."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1))) - 7)
    return (got.float() - w).abs() / ulp


def tail_launches() -> int:
    """Kernel C launches counted so far whose merge took the raw tail."""
    from repro_torch import obs

    return obs.snapshot(spans=False)["counters"]["launches.attn_tail"]


def cell_pages(card, batch: int, n_kv: int, hd: int, n_slots: int, seed: int):
    """(ks, vs, pk, pv, table, gen): seeded channel-structured bf16 K/V of
    ``n_slots`` pages a row (tokens where a row spans ``ppr`` page slots,
    which then fill ``n_slots * ppr`` slots; phase 5's structure), the table
    fitted to the first row's first 32 tokens, the page slots kernel A
    encodes, and the generator, for the queries."""
    import torch

    from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases
    from repro_torch.kernels import gbdi_encode as enc_mod
    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving import kv_cache as kvc

    cfg = kvc.KV_FR
    pt, ppr = pa_mod.attn_layout(cfg, n_kv, hd)
    gen = torch.Generator(device=card).manual_seed(seed)
    means = torch.randn(1, 1, n_kv, hd, generator=gen, device=card) * 2

    def tokens():     # (batch, n_slots * pt, n_kv, hd)
        noise = torch.randn(batch, n_slots * pt, n_kv, hd, generator=gen, device=card)
        return (means + 0.1 * noise).to(torch.bfloat16)

    ks, vs = tokens(), tokens()
    table = fit_fr_bases(bf16_to_words(torch.cat([ks[0, :32].reshape(-1),
                                                  vs[0, :32].reshape(-1)])), cfg)

    def slots(x):
        words = bf16_to_words(x).reshape(-1, cfg.page_words).contiguous()
        return {k: v.reshape((batch, n_slots * ppr) + v.shape[1:])
                for k, v in enc_mod.gbdi_encode(words, table, cfg).items()
                if k not in ("n_spilled", "n_dropped")}

    return ks, vs, slots(ks), slots(vs), table, gen


def tail_form(card, event_ms, label: str, q, pk, pv, table, pos: int, geom: dict, gen,
              wrong=None) -> dict:
    """Phases 7, 7 (b) and 7 (c): kernel C's tail form (``paged_attention_decode_tail``:
    the raw tail ring scored and merged in C's merge kernel, bf16 out) at
    ``pos``, over a seeded tail ring of independent ``2 * randn`` K and V rows
    (so the tail carries weight beside the pages), held within one bf16 ulp
    against its plain version (``paged_attention_decode_tail_plain``) and
    against unfused C followed by the eager tail merge.  The check is shown
    to bite: the output with the tail dropped, those with the tail's mask
    ending one position early or late (where a page holds several tokens),
    and those ``wrong(k_tail, v_tail)`` gives by name, each miss the plain
    version by more than an ulp.  One ``launches.attn_tail`` a tail-form call and none for C
    alone; then both timed in turns with the host included (CUDA events
    around the call on an idle card), median and min of ``TIMING_REPEATS``.
    Returns the times and the launches of C and of its tail form, counted
    over all of the above."""
    import torch

    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving import kv_cache as kvc

    cfg, window = kvc.KV_FR, geom.get("window", 0)
    B, n_kv, hd = q.shape[0], geom["n_kv"], geom["hd"]
    pt = pa_mod.page_tokens(cfg, n_kv, hd)
    shifts = (-1, 1) if pt > 1 else ()      # a one-token tail has no mask to shift
    if shifts and not 0 < pos % pt < pt - 1:
        raise ValueError(f"[{label}] pos {pos} leaves no room to shift the tail's mask in page")
    kt, vt = ((2 * torch.randn(B, pt, n_kv, hd, generator=gen, device=card)).to(torch.bfloat16)
              for _ in "kv")
    c0, t0 = launch_counts("gbdi_paged_attn")["gbdi_paged_attn"], tail_launches()

    def fused():
        return pa_mod.paged_attention_decode_tail(q, pk, pv, table, pos, cfg, k_tail=kt,
                                                  v_tail=vt, **geom)

    def unfused():
        state = pa_mod.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
        return pa_mod.tail_merge(q, state, kt, vt, pos, window=window)

    got = fused()
    if tail_launches() != t0 + 1:
        raise AssertionError(f"[{label}] the tail form counted {tail_launches() - t0} tail launches")
    acc, m, l = state = pa_mod.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
    unf = pa_mod.tail_merge(q, state, kt, vt, pos, window=window)
    if tail_launches() != t0 + 1:
        raise AssertionError(f"[{label}] C alone counted a tail launch")
    want = pa_mod.paged_attention_decode_tail_plain(q, pk, pv, table, pos, cfg, k_tail=kt,
                                                    v_tail=vt, **geom)
    ulps = {"plain": float(bf16_ulps(got, want).max()), "unfused": float(bf16_ulps(got, unf).max())}
    rel = float(((got.float() - want.float()).abs() / want.float().abs().clamp(min=1)).max())
    if max(ulps.values()) > 1 or not got.isfinite().all():
        raise AssertionError(f"[{label}] tail form vs plain and vs unfused C + eager merge: "
                             f"{ulps} bf16 ulps")
    wrongs = {"tail dropped": (acc / l[..., None]).to(torch.bfloat16),
              **{f"mask to {pos + d}": pa_mod.tail_merge(q, state, kt, vt, pos + d, window=window)
                 for d in shifts},
              **(wrong(kt, vt) if wrong else {})}
    misses = {k: float(bf16_ulps(w, want).max()) for k, w in wrongs.items()}
    if min(misses.values()) <= 1:
        raise AssertionError(f"[{label}] a wrong tail passes the one-ulp check: {misses} ulps")
    times = {"fused": [], "unfused": []}
    fused(), unfused()
    for _ in range(TIMING_REPEATS):
        for name, fn in (("fused", fused), ("unfused", unfused)):
            times[name].append(event_ms(fn))
    launches = launch_counts("gbdi_paged_attn")["gbdi_paged_attn"] - c0
    tails = tail_launches() - t0
    if tails != TIMING_REPEATS + 2:
        raise AssertionError(f"[{label}] {tails} tail launches for {TIMING_REPEATS + 2} calls")
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    low = {k: min(v) for k, v in times.items()}
    log(f"[{label}] tail form at pos {pos} ({geom}): {med['fused']:.4f} ms (median of "
        f"{TIMING_REPEATS}, min {low['fused']:.4f}) against unfused C + the eager tail merge "
        f"{med['unfused']:.4f} ms (min {low['unfused']:.4f}), host included; outputs within "
        f"{ulps} bf16 ulp of plain / unfused (widest |d| / max(1, |out|) from plain {rel:.3g}); "
        f"wrong tails miss by {misses} ulps; {launches} launches of C, {tails} in the tail form "
        f"({card_tag(card)})")
    return {"ms": med["fused"], "min_ms": low["fused"], "unfused_ms": med["unfused"],
            "unfused_min_ms": low["unfused"], "ulps": ulps["plain"], "launches": launches,
            "tail_launches": tails}


def cell_tail_form(card, event_ms, batch: int = CELL["batch"]) -> dict:
    """Phase 7: :func:`tail_form` at :data:`CELL`, a full layer of the mixtral
    decode cell."""
    import torch

    n_kv, hd, G = CELL["n_kv"], CELL["hd"], CELL["groups"]
    _, _, pk, pv, table, gen = cell_pages(card, batch, n_kv, hd, CELL["slots"], SEED + 4)
    q = torch.randn(batch, n_kv, G, hd, generator=gen, device=card) * 4
    return tail_form(card, event_ms, "7", q, pk, pv, table, CELL["pos"],
                     dict(n_kv=n_kv, hd=hd, groups=G), gen)


def ring_attention(card, event_ms, peak: float, batch: int = RING["batch"]) -> dict:
    """Phase 7 (b): kernel C's ring instantiation (``window`` > 0) over a
    ring of ``ceil(window / page_tokens)`` slots of seeded channel-structured
    bf16 K/V, at each of ``RING["positions"]`` against its plain version
    within ``ATTN_TOL``, one launch a call; then at the last position its
    time (CUDA events, warmed, median), its bound on this card (bytes: the
    pages holding tokens of ``[lo, cur * pt)``, q and the state; operations
    as phase 7 over those tokens), its plain version's time and, as the
    library yardstick, SDPA over as many tokens held raw.  Returns the
    ``kernels`` line's fields, launches included.  Last, the tail form at
    that position (:func:`tail_form`), its launches counted in the row."""
    import torch

    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving import kv_cache as kvc

    cfg = kvc.KV_FR
    n_kv, hd, G, W = RING["n_kv"], RING["hd"], RING["groups"], RING["window"]
    geom = dict(n_kv=n_kv, hd=hd, groups=G, window=W)
    pt = pa_mod.page_tokens(cfg, n_kv, hd)
    R, H = -(-W // pt), n_kv * G
    ks, vs, pk, pv, table, gen = cell_pages(card, batch, n_kv, hd, R, SEED + 3)
    q = torch.randn(batch, n_kv, G, hd, generator=gen, device=card) * 4

    def attend():
        return pa_mod.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)

    def attn_launches() -> int:
        return launch_counts("gbdi_paged_attn")["gbdi_paged_attn"]

    errs, launches, sliced0 = {"out": 0.0, "m": 0.0, "l": 0.0}, 0, sliced_launches()
    for pos in RING["positions"]:
        n_valid, cur, lo = pa_mod.ring_bounds(R, pos, pt, W)
        before = attn_launches()
        got = attend()
        n = attn_launches() - before
        want = pa_mod.paged_attention_decode_plain(q, pk, pv, table, pos, cfg, **geom)
        err = attn_errors(*got, *want)
        if n != 1 or any(err[k] > ATTN_TOL[k] for k in ATTN_TOL):
            raise AssertionError(f"[7b] pos {pos}: {n} launches, ring kernel vs plain {err} "
                                 f"(tolerances {ATTN_TOL})")
        launches += n
        for k, v in err.items():
            errs[k] = max(errs[k], v)
        step = ("a flush step, its slot reused" if pos % pt == pt - 1
                else "before the ring fills" if cur < R else f"{pos % pt} into page {cur}")
        log(f"[7b] ring pos {pos} ({step}): page {cur}, window from {lo}, {n_valid} slots "
            f"read (ring wrapped {cur // R} times): max|acc/l| err {err['out']:.3g}, m rel err "
            f"{err['m']:.3g}, l rel err {err['l']:.3g}")

    def median_ms(fn):
        fn()
        times = sorted(event_ms(fn) for _ in range(TIMING_REPEATS))
        return times[len(times) // 2]

    _, cur, lo = pa_mod.ring_bounds(R, pos, pt, W)
    n_pages, T = cur - lo // pt, cur * pt - lo          # the pages holding [lo, cur * pt)
    before = attn_launches()
    ms = median_ms(attend)
    launches += attn_launches() - before
    plain_ms = event_ms(lambda: pa_mod.paged_attention_decode_plain(q, pk, pv, table, pos, cfg,
                                                                    **geom))
    page_bytes = 4 * (cfg.ptr_lanes + cfg.delta_lanes + 2 * cfg.outlier_cap + 1)
    n_bytes = 2 * batch * n_pages * page_bytes + q.numel() * 4 + batch * H * (hd + 2) * 4
    bytes_ms = n_bytes / peak * 1e3
    ops_ms = (4.0 * batch * H * T * hd / F32_OPS_S
              + 4.0 * 2 * batch * n_pages * cfg.page_words / INT_OPS_S) * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = q.reshape(batch, H, 1, hd).to(torch.bfloat16)
    Kr, Vr = (x[:, :T].permute(0, 2, 1, 3).contiguous() for x in (ks, vs))
    lib_ms = median_ms(lambda: sdpa(qh, Kr, Vr, enable_gqa=True))
    sliced = sliced_launches() - sliced0
    ts = pa_mod.token_slices(H, hd, pa_mod.pass_slots(cfg, n_kv=n_kv, hd=hd, groups=G) * pt)
    if sliced != (launches if ts > 1 else 0):
        raise AssertionError(f"[7b] {sliced} of {launches} launches sliced at {ts} token slices")
    tail = tail_form(card, event_ms, "7b", q, pk, pv, table, pos, geom, gen)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": lib_ms,
           "launches": launches + tail["launches"], "max_abs_err": errs["out"]}
    log(f"[7b] ring instantiation at B={batch} Kv={n_kv} G={G} hd={hd}, window {W} in {R} "
        f"slots, pos {pos} ({n_pages} pages, {T} tokens): {ms:.4f} ms (median of "
        f"{TIMING_REPEATS}); bound {row['bound_ms']:.4f} ms by {row['bound_by']} (bytes "
        f"{bytes_ms:.4f} ms = {n_bytes} B / {peak:.3g} B/s; operations {ops_ms:.4f} ms); "
        f"roofline share {row['bound_ms'] / ms:.3f}; plain {plain_ms:.3f} ms; SDPA over {T} raw "
        f"tokens {lib_ms:.4f} ms; {launches} launches ({sliced} in {ts} token slices); largest "
        f"errors {errs} ({card_tag(card)})")
    return row


def multipage_attention(card, event_ms, peak: float, batch: int = MULTIPAGE["batch"]) -> dict:
    """Phase 7 (c): kernel C over rows that span several page slots, at
    :data:`MULTIPAGE` (the deepseek-7b decode cell's geometry): seeded
    channel-structured bf16 K/V in page slots ``t * ppr + j``; at each of
    ``MULTIPAGE["positions"]`` the state form against its plain version
    within ``ATTN_TOL``, one launch a call; then at the last its time (CUDA
    events, warmed, median) beside its bound on this card (bytes: every
    valid token's ``ppr`` slots, q and the state; operations as phase 7),
    its plain version's time and SDPA over as many tokens held raw; last the
    tail form (:func:`tail_form`), shown to bite on the head groups' slots
    swapped too.  Every C launch of the phase is counted in
    ``launches.attn_multipage`` as in ``launches.attn``.  Returns the
    ``kernels`` line's fields, launches included."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving import kv_cache as kvc

    cfg = kvc.KV_FR
    n_kv, hd, G, T = (MULTIPAGE[k] for k in ("n_kv", "hd", "groups", "tokens"))
    geom = dict(n_kv=n_kv, hd=hd, groups=G)
    pt, ppr = pa_mod.attn_layout(cfg, n_kv, hd)
    if (pt, ppr) != (1, 2):
        raise AssertionError(f"[7c] {n_kv} x {hd} rows lay out as {pt} tokens a page, "
                             f"{ppr} slots a row, not one token over two slots")
    H = n_kv * G
    ks, vs, pk, pv, table, gen = cell_pages(card, batch, n_kv, hd, T, SEED + 5)
    q = torch.randn(batch, n_kv, G, hd, generator=gen, device=card) * 4

    def counted() -> dict:
        c = obs.snapshot(spans=False)["counters"]
        return {k: c[f"launches.{k}"] for k in ("attn", "attn_multipage")}

    def attend():
        return pa_mod.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)

    def plain(pk, pv):
        return pa_mod.paged_attention_decode_plain(q, pk, pv, table, pos, cfg,
                                                   chunk_slots=MULTIPAGE_PLAIN_CHUNK, **geom)

    c0, errs = counted(), {"out": 0.0, "m": 0.0, "l": 0.0}
    for pos in MULTIPAGE["positions"]:
        before = counted()["attn"]
        got = attend()
        n = counted()["attn"] - before
        err = attn_errors(*got, *plain(pk, pv))
        if n != 1 or any(err[k] > ATTN_TOL[k] for k in ATTN_TOL):
            raise AssertionError(f"[7c] pos {pos}: {n} launches, kernel vs plain {err} "
                                 f"(tolerances {ATTN_TOL})")
        for k, v in err.items():
            errs[k] = max(errs[k], v)
        log(f"[7c] pos {pos}: {pos // pt} tokens in {pos // pt * ppr} page slots a row: "
            f"max|acc/l| err {err['out']:.3g}, m rel err {err['m']:.3g}, l rel err "
            f"{err['l']:.3g}")

    def median_ms(fn):
        fn()
        times = sorted(event_ms(fn) for _ in range(TIMING_REPEATS))
        return times[len(times) // 2]

    n_valid = pos // pt
    ms = median_ms(attend)
    plain_ms = event_ms(lambda: plain(pk, pv))
    page_bytes = 4 * (cfg.ptr_lanes + cfg.delta_lanes + 2 * cfg.outlier_cap + 1)
    n_bytes = 2 * batch * n_valid * ppr * page_bytes + q.numel() * 4 + batch * H * (hd + 2) * 4
    bytes_ms = n_bytes / peak * 1e3
    ops_ms = (4.0 * batch * H * n_valid * pt * hd / F32_OPS_S
              + 4.0 * 2 * batch * n_valid * ppr * cfg.page_words / INT_OPS_S) * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = q.reshape(batch, H, 1, hd).to(torch.bfloat16)
    Kr, Vr = (x[:, :n_valid * pt].permute(0, 2, 1, 3).contiguous() for x in (ks, vs))
    lib_ms = median_ms(lambda: sdpa(qh, Kr, Vr, enable_gqa=True))
    del Kr, Vr

    def swapped(pages):   # token t's head groups read each other's slots
        return {k: v.reshape((batch, T, ppr) + v.shape[2:]).flip(2).reshape(v.shape)
                for k, v in pages.items()}

    def wrong(kt, vt):
        return {"head groups swapped": pa_mod.paged_attention_decode_tail_plain(
            q, swapped(pk), swapped(pv), table, pos, cfg, k_tail=kt, v_tail=vt, **geom)}

    tail = tail_form(card, event_ms, "7c", q, pk, pv, table, pos, geom, gen, wrong=wrong)
    c1 = counted()
    launches = c1["attn"] - c0["attn"]
    if c1["attn_multipage"] - c0["attn_multipage"] != launches:
        raise AssertionError(f"[7c] {c1['attn_multipage'] - c0['attn_multipage']} multipage "
                             f"launches of {launches}")
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": lib_ms,
           "launches": launches, "max_abs_err": errs["out"], "tail_ms": tail["ms"],
           "tail_ulps": tail["ulps"]}
    log(f"[7c] rows over {ppr} page slots at B={batch} Kv={n_kv} G={G} hd={hd}, pos {pos} "
        f"({n_valid} tokens, {n_valid * ppr} slots a row): {ms:.4f} ms (median of "
        f"{TIMING_REPEATS}) against a bound of {row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"(bytes {bytes_ms:.4f} ms = {n_bytes} B / {peak:.3g} B/s; operations {ops_ms:.4f} ms); "
        f"roofline share {row['bound_ms'] / ms:.3f}; plain {plain_ms:.3f} ms; SDPA over "
        f"{n_valid * pt} raw tokens {lib_ms:.4f} ms; tail form {tail['ms']:.4f} ms within "
        f"{tail['ulps']:.3g} ulp of plain; {launches} launches, all counted multipage; largest "
        f"errors {errs} ({card_tag(card)})")
    return row


def hold_to_cpu(workloads: list, card, n_bytes: int, tag: str) -> None:
    """Every workload x {gbdi, bdi, fr} fitted once on the CPU's plain path,
    the model or table carried to ``card``: the card's blobs and sizes equal
    the CPU's, and the card decodes its blob within the dropped words."""
    from repro_torch.eval.codecs import default_codecs

    cpu, on_card = default_codecs("cpu"), default_codecs(str(card))
    for wl in workloads:
        data = wl.generate(n_bytes, 0)
        for cname in ("gbdi", "bdi", "fr"):
            ref, dut = cpu.make(cname, wl.word_bits), on_card.make(cname, wl.word_bits)
            words = ref.stream(data)
            model = ref.fit(words)                 # the plain fit, carried to the card
            pb = ref.encode(words, model)
            kwords = dut.stream(data)
            kb = dut.encode(kwords, model.to(card) if model is not None else None)
            bad = blob_diff(pb, kb)
            if bad:
                raise AssertionError(f"[{tag}] {wl.name}/{cname}: card blob differs in {bad}")
            if ref.size_bits(pb) != dut.size_bits(kb):
                raise AssertionError(f"[{tag}] {wl.name}/{cname}: size {dut.size_bits(kb)} != "
                                     f"{ref.size_bits(pb)}")
            mism = int((dut.decode(kb) != kwords).sum())
            if mism > dut.dropped_words(kb):
                raise AssertionError(f"[{tag}] {wl.name}/{cname}: {mism} words differ after "
                                     f"decode > {dut.dropped_words(kb)} dropped")
        log(f"[{tag}] {wl.name}: gbdi, bdi, fr blobs and sizes equal the CPU's on the carried "
            f"model ({n_bytes} B); decoded on the card within drops")


def paper_suite(card, check_bytes: int = CHECK_BYTES, suite_bytes: int = SUITE_BYTES) -> list:
    """Phase 8, the paper's suite: (a) every family x {gbdi, bdi, fr} fitted
    once on the CPU's plain path and encoded on ``card`` and on the CPU with
    that model or table, blob for blob, ratio for ratio, then decoded on
    ``card``; (b) ``evaluate(suite="all")`` on ``card`` at ``suite_bytes``
    per family with the card's own fit, every cell verified; (c) every
    sweep config (static and adaptive4) over two streams of ``check_bytes``,
    the card's blobs against the CPU's on one carried table, then the
    sweep's rows on ``card``.  Returns the suite's cells; raises on any
    disagreement."""
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import FRCodec, default_codecs
    from repro_torch.eval.workloads import default_workloads

    reg = default_workloads(device=str(card))
    on_card = default_codecs(str(card))
    t0 = time.perf_counter()
    hold_to_cpu(list(reg), card, check_bytes, "8a")
    log(f"[8a] {len(reg)} families x 3 codecs in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cells = eval_run.evaluate(reg, on_card, suite="all", codecs="gbdi,bdi,fr",
                              n_bytes=suite_bytes, seed=0, repeats=3)
    bad = [f"{c.workload}/{c.codec}: {c.error}" for c in cells if not c.verified]
    if bad or len(cells) != 3 * len(reg):
        raise AssertionError(f"[8b] {len(cells)} cells, failed: {bad}")
    log(f"[8b] evaluate(suite='all', codecs='gbdi,bdi,fr') at {suite_bytes} B per family: "
        f"{len(cells)} cells verified in {time.perf_counter() - t0:.1f} s")
    log(eval_run.format_table(cells))
    for line in eval_run.csv_lines(cells):
        log(line)

    t0 = time.perf_counter()
    names = ("605.mcf_s", "ml_kvcache_bf16")
    grid = eval_run.sweep_grid("static,adaptive4")
    for point in grid:
        for wname in names:
            wl = reg.get(wname)
            cfg = point.config(wl.word_bits)
            ref = FRCodec(word_bits=wl.word_bits, device="cpu", cfg=cfg)
            dut = FRCodec(word_bits=wl.word_bits, device=str(card), cfg=cfg)
            data = wl.generate(check_bytes, 0)
            words = ref.stream(data)
            table = ref.fit(words)
            bad = blob_diff(ref.encode(words, table), dut.encode(dut.stream(data), table.to(card)))
            if bad:
                raise AssertionError(f"[8c] {wname} k{point.num_bases} shape {point.shape_idx} "
                                     f"{point.profile_set}: card blob differs in {bad}")
    log(f"[8c] {len(grid)} sweep configs x {len(names)} streams: card blobs equal the CPU's "
        f"field for field on carried tables ({check_bytes} B)")
    rows = eval_run.sweep(reg, suite=",".join(names), device=str(card), n_bytes=check_bytes,
                          profile_sets="static,adaptive4")
    if len(rows) != len(grid) or not all(r["verified"] for r in rows):
        raise AssertionError(f"[8c] sweep rows: {[(r['config'], r['verified']) for r in rows]}")
    log(eval_run.format_sweep_table(rows))
    log(f"[8c] sweep in {time.perf_counter() - t0:.1f} s")
    return cells


def card_tag(card) -> str:
    """The device's name and, for a card, its power limit, as each time's tag."""
    import torch

    from repro_torch.eval import run as eval_run

    return (f"{eval_run.device_name(torch.device(card))}, {eval_run.power_limit()}"
            if torch.device(card).type == "cuda" else str(card))


def write_corpus(out: Path) -> list[Path]:
    """The ingestion corpus of ``tests/ingest_corpus.py`` (an ELF64 core in
    both byte orders, a ``.npz``, a raw ``.bin``, a pickled tree), plus a
    bf16 ``.npy`` whose bits come from a torch bf16 tensor: the corpus's own
    builder needs ``ml_dtypes``.  Saved as 2-byte void (``V2``), which is how
    numpy reads a bf16 ``.npy`` written with ``ml_dtypes``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from ingest_corpus import build_bin, build_elf_core, build_npz, build_pytree_pickle

    out.mkdir(parents=True, exist_ok=True)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 96)) * 0.05)
    bits = w.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.save(out / "weights_bf16.npy", bits.view(np.dtype("V2")))
    return [build_elf_core(out / "mini_core.elf"),
            build_elf_core(out / "mini_core_be.elf", endian="big"),
            out / "weights_bf16.npy", build_npz(out / "columns.npz"),
            build_bin(out / "counters.bin"), build_pytree_pickle(out / "params.pkl")]


def dump_suite(card, model, dump_dir: Path, check_bytes: int = CHECK_BYTES,
               suite_bytes: int = SUITE_BYTES, capture_bytes: int = CAPTURE_BYTES) -> list:
    """Phase 9, real dumps: the corpus ingested by the port's CLI, a capture of
    this process (``capture_bytes`` at most) and a ``capture_pytree`` of
    ``model``'s parameters sampled to ``capture_bytes``, all saved as
    containers in ``dump_dir``; ``evaluate(suite="dump")`` on ``card`` at
    ``suite_bytes`` per family over gbdi, bdi and fr, every cell verified;
    then every dump family held to the CPU at ``check_bytes`` on carried
    models.  Returns the suite's cells."""
    from repro_torch.eval import ingest
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import default_codecs
    from repro_torch.eval.ingest.__main__ import main as ingest_main
    from repro_torch.eval.workloads import default_workloads

    t0 = time.perf_counter()
    paths = write_corpus(dump_dir.parent / "corpus")
    fams = ingest_main([*map(str, paths), "--dump-dir", str(dump_dir)])
    log(f"[9] ingested {fams} in {time.perf_counter() - t0:.1f} s (host; {card_tag(card)})")
    t0 = time.perf_counter()
    proc = ingest.capture_process(os.getpid(), allow=True, max_bytes=capture_bytes,
                                  name="chip_smoke_proc")
    proc.save(dump_dir / f"{proc.name}.npz")
    log(f"[9] capture_process(own pid): {proc.n_bytes} B in {len(proc.segments)} maps "
        f"({proc.meta['skipped_maps']} skipped), saved in {time.perf_counter() - t0:.1f} s "
        f"(host; {card_tag(card)})")
    t0 = time.perf_counter()
    name = f"{model.cfg.arch_id}_{model.cfg.n_layers}l_params"
    image = sampled_image(model.params(), name, f"capture_pytree({model.cfg.arch_id}, "
                          f"{model.cfg.n_layers} layers)", capture_bytes)
    image.save(dump_dir / f"{name}.npz")
    log(f"[9] capture_pytree: {image.meta['sampled_from']} B in {image.meta['n_arrays']} leaves "
        f"(word_bits {image.word_bits}) sampled to {image.n_bytes} B, saved in "
        f"{time.perf_counter() - t0:.1f} s (host; {card_tag(card)})")
    del image

    reg = default_workloads(str(dump_dir), device=str(card))
    dumps = reg.select("dump")
    t0 = time.perf_counter()
    cells = eval_run.evaluate(reg, default_codecs(str(card)), suite="dump", codecs="gbdi,bdi,fr",
                              n_bytes=suite_bytes, seed=0, repeats=3)
    bad = [f"{c.workload}/{c.codec}: {c.error}" for c in cells if not c.verified]
    if bad or len(cells) != 3 * len(dumps) or len(dumps) != len(paths) + 2:
        raise AssertionError(f"[9] {len(dumps)} dump families, {len(cells)} cells, failed: {bad}")
    log(f"[9] evaluate(suite='dump', codecs='gbdi,bdi,fr') at {suite_bytes} B per family: "
        f"{len(cells)} cells verified in {time.perf_counter() - t0:.1f} s ({card_tag(card)})")
    log(eval_run.format_table(cells))
    for line in eval_run.csv_lines(cells):
        log(line)
    t0 = time.perf_counter()
    hold_to_cpu(dumps, card, check_bytes, "9")
    log(f"[9] {len(dumps)} dump families x 3 codecs held to the CPU in "
        f"{time.perf_counter() - t0:.1f} s ({card_tag(card)})")
    return cells


def ml_families(card, model, stream_bytes: int = CAPTURE_BYTES, check_bytes: int = CHECK_BYTES,
                decode_steps: int = 3) -> dict:
    """Phase 10, the model-backed ML families: (a) the reduced deepseek-7b
    from one CPU init carried to ``card``, trained there and on the CPU by
    the families' recipe: every gradient leaf at cosine >= 0.99 (bf16 op
    order differs), and each family's gbdi/bdi/fr ratio at ``check_bytes``
    within 2 %; (b) ``model``
    (full width): one ``TokenPipeline`` batch, loss + backward, two AdamW
    steps, each timed; the four families at ``stream_bytes`` x gbdi/bdi/fr,
    verified; ``decode_steps`` greedy steps through ``prefill`` and
    ``decode_step``.  Returns the step times in ms."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import default_codecs
    from repro_torch.eval.workloads import (MODEL_FAMILIES, default_workloads, ml_streams,
                                            train_state)
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw

    def sync() -> None:
        if card.type == "cuda":
            torch.cuda.synchronize(card)

    # (a) the reduced model, one init, on the CPU and on the card
    cfg = reduced(ARCHS["deepseek-7b"])
    cpu_model = build_model(cfg, "cpu")
    cpu_model.init(torch.Generator().manual_seed(SEED))
    card_model = build_model(cfg, card)
    card_model.set_params(interop.params_from_numpy(interop.params_to_numpy(cpu_model.params()),
                                                    card))
    states = {"cpu": train_state(cpu_model, 0), "card": train_state(card_model, 0)}
    for (path, a), b in zip(tree_flatten_with_path(states["cpu"][1]),
                            tree_leaves(states["card"][1])):
        a, b = a.float(), b.float().cpu()
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        if not cos >= 0.99:
            raise AssertionError(f"[10a] gradient {path}: card vs CPU cosine {cos}")
    wl_reg = default_workloads("/nonexistent", device="cpu")
    cells = {}
    for dev_name, (params, grads, state) in states.items():
        streams = ml_streams(params, grads, state, check_bytes)
        codecs = default_codecs("cpu" if dev_name == "cpu" else str(card))
        cells[dev_name] = [
            eval_run.evaluate_cell(wl_reg.get(n), codecs.make(c, wl_reg.get(n).word_bits),
                                   streams[n], repeats=1)
            for n in MODEL_FAMILIES for c in ("gbdi", "bdi", "fr")]
    for a, b in zip(cells["cpu"], cells["card"]):
        if not (a.verified and b.verified
                and abs(b.compression_ratio - a.compression_ratio) <= 0.02 * a.compression_ratio):
            raise AssertionError(f"[10a] {a.workload}/{a.codec}: card CR {b.compression_ratio} vs "
                                 f"CPU {a.compression_ratio} ({b.error or a.error})")
        log(f"[10a] {a.workload}/{a.codec}: CR card {b.compression_ratio:.4f}, CPU "
            f"{a.compression_ratio:.4f} ({check_bytes} B; one init carried, trained on each)")
    log("[10a] reduced deepseek-7b trained on the card and on the CPU from one init: every "
        "gradient leaf at cosine >= 0.99, every family's ratio within 2 %")
    del cpu_model, card_model, states

    # (b) full width
    times = {}

    def timed(label: str, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[label] = (time.perf_counter() - t0) * 1e3
        return out

    mcfg = model.cfg
    pipe = TokenPipeline(PipelineConfig(mcfg.vocab_size, 32, 4, seed=0))
    batch = {"tokens": pipe.batch_at(0)["tokens"]}
    if card.type == "cuda":
        torch.cuda.reset_peak_memory_stats(card)
    loss = timed("loss_backward", lambda: _loss_backward(model, batch))
    if not np.isfinite(loss):
        raise AssertionError(f"[10b] loss {loss}")
    params = model.params()
    grads = tree_map(lambda p: p.grad, params)
    state = adamw.init_state(params)
    acfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    for i in range(2):
        params, state, metrics = timed(f"adamw_step{i + 1}",
                                       lambda: adamw.apply_updates(acfg, params, grads, state))
    n_params = sum(p.numel() for p in tree_leaves(params))
    peak = torch.cuda.max_memory_allocated(card) if card.type == "cuda" else 0
    log(f"[10b] {mcfg.arch_id} at full width, {mcfg.n_layers} layers ({n_params} parameters, "
        f"{mcfg.dtype}): loss {loss:.4f}; loss + backward {times['loss_backward']:.1f} ms, AdamW "
        f"steps {times['adamw_step1']:.1f} / {times['adamw_step2']:.1f} ms (grad norm "
        f"{float(metrics['grad_norm']):.4f}, lr {float(metrics['lr']):.3g}); peak memory "
        f"{peak} B (host clock, synchronised; {card_tag(card)})")

    t0 = time.perf_counter()
    streams = ml_streams(params, grads, state, stream_bytes)
    log(f"[10b] the four families' streams at {stream_bytes} B in "
        f"{time.perf_counter() - t0:.1f} s ({card_tag(card)})")
    codecs = default_codecs(str(card))
    for n in MODEL_FAMILIES:
        wl = wl_reg.get(n)
        for cname in ("gbdi", "bdi", "fr"):
            cell = eval_run.evaluate_cell(wl, codecs.make(cname, wl.word_bits), streams[n],
                                          repeats=1)
            if not cell.verified:
                raise AssertionError(f"[10b] {n}/{cname}: {cell.error}")
            gib = cell.n_bytes / (1 << 30)
            log(f"[10b] {n}/{cname} ({cell.word_bits}-bit words, {cell.n_bytes} B): CR "
                f"{cell.compression_ratio:.4f}, bits/word {cell.bits_per_word:.3f}, encode "
                f"{gib / cell.encode_s:.3f} GiB/s, decode {gib / cell.decode_s:.3f} GiB/s, "
                f"fit {cell.fit_s:.2f} s, exact {cell.exact_frac:.5f} ({cell.device}, "
                f"{cell.power_limit})")
        streams.pop(n)

    model.set_params(params)              # the trained weights serve the decode
    del grads, state
    cache = model.init_cache(4, 32 + decode_steps)
    cache, logits = timed("prefill", lambda: model.prefill(batch, cache))
    tok = logits[:, -1].float().argmax(-1)
    tokens = []
    for i in range(decode_steps):
        logits, cache = timed(f"decode{i}", lambda: model.decode_step(
            {"tokens": tok[:, None]}, cache, 32 + i))
        if not (logits.shape == (4, 1, mcfg.vocab_size) and logits.float().isfinite().all()):
            raise AssertionError(f"[10b] decode step {i}: logits {tuple(logits.shape)}")
        tok = logits[:, 0].float().argmax(-1)
        tokens.append(tok.tolist())
    log(f"[10b] prefill of 4 x 32 tokens {times['prefill']:.1f} ms; greedy decode "
        + ", ".join(f"{times[f'decode{i}']:.1f}" for i in range(decode_steps))
        + f" ms a step (host clock, synchronised; {card_tag(card)}); tokens {tokens}")
    return times


def _load_script(rel: str):
    """A script of the checkout (``benchmarks/``, ``examples/``) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(rel).stem,
                                                  Path(__file__).resolve().parent / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: phase 11 (a): the max_new choices of the reference's scheduler suite
#: (tests/test_serving_scheduler.py; 14 overruns its cache ceiling of 16)
SERVE_MAX_NEW = (1, 2, 3, 6, 14)
#: phase 11 (a): seeded scheduler programs held to solo parity on the card
SERVE_PROGRAMS = 30
#: phase 11 (b): examples/serve_demo.py's shape with max_len cut from 512 to
#: 128; each request's prompt plus max_new fills the cache
SERVE_MAX_LEN, SERVE_PROMPT, SERVE_REQUESTS = 128, 12, 10


def serving_parity(card) -> int:
    """Phase 11 (a): the narrow float32 deepseek-7b of the scheduler suite,
    initialised once on the CPU and carried to ``card``.  The card's
    ``Engine`` gives the CPU's greedy tokens for a batched admit, a
    mid-decode admit and a mixed-length admit; then ``SERVE_PROGRAMS`` seeded
    submit/park/step programs drive a ``Scheduler`` on ``card`` to drain,
    every request token-equal to its solo single-slot run on ``card`` and
    ``resident_bytes`` back at 0.  Returns the requests checked."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scheduler import RequestState, Scheduler

    cfg = dataclasses.replace(reduced(ARCHS["deepseek-7b"]), dtype="float32", d_model=64,
                              n_heads=2, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
    cpu_model = build_model(cfg, "cpu")
    cpu_model.init(torch.Generator().manual_seed(0))
    card_model = build_model(cfg, card)
    card_model.set_params(interop.params_from_numpy(interop.params_to_numpy(cpu_model.params()),
                                                    card))
    rng = np.random.default_rng(4)
    p8, p6, p5 = (rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 6, 5))

    def cases(model):
        """(label, every request's tokens) of the three admit shapes."""
        out = []
        eng = Engine(model, batch_slots=3, max_len=64)
        reqs = [Request(i, p, max_new=5) for i, p in enumerate((p8, p8[::-1].copy(), p6))]
        eng.admit(reqs)
        while eng.tick():
            pass
        out.append(("batched admit", [r.out for r in reqs]))
        eng = Engine(model, batch_slots=2, max_len=64)
        r1, r2 = Request(0, p8.copy(), max_new=6), Request(1, p6.copy(), max_new=4)
        eng.admit([r1])
        eng.tick()
        eng.tick()
        eng.admit([r2])
        while eng.tick():
            pass
        out.append(("mid-decode admit", [r1.out, r2.out]))
        eng = Engine(model, batch_slots=2, max_len=64)
        reqs = [Request(0, p8.copy(), max_new=6), Request(1, p5.copy(), max_new=6)]
        eng.admit(reqs)
        while eng.tick():
            pass
        out.append(("mixed-length admit", [r.out for r in reqs]))
        return out

    for (label, want), (_, got) in zip(cases(cpu_model), cases(card_model)):
        if got != want:
            raise AssertionError(f"[11a] {label}: card tokens {got} != CPU tokens {want}")
        log(f"[11a] {label}: card tokens equal the CPU's on the carried float32 model {got}")

    max_len = 16
    pool = np.random.default_rng(1234)
    prompts = [pool.integers(0, 128, n).astype(np.int32) for n in (2, 3, 4, 2, 3, 4)]
    solo_cache: dict[tuple[int, int], list[int]] = {}

    def solo(pi: int, mn: int) -> list[int]:
        if (pi, mn) not in solo_cache:
            eng = Engine(card_model, batch_slots=1, max_len=max_len)
            req = Request(0, prompts[pi].copy(), max_new=mn)
            eng.admit([req])
            while eng.tick():
                pass
            solo_cache[(pi, mn)] = req.out
        return solo_cache[(pi, mn)]

    per_seq = card_model.n_kv_layers * card_model.kv_cache_spec(max_len).compressed_bytes(1)
    checked = evictions = 0
    for seed in range(SERVE_PROGRAMS):
        rng = np.random.default_rng(seed)
        slots, budget_seqs = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        sched = Scheduler(Engine(card_model, batch_slots=slots, max_len=max_len),
                          byte_budget=budget_seqs * per_seq)
        n_req = int(rng.integers(2, 6))
        pending = [(int(rng.integers(0, len(prompts))),
                    SERVE_MAX_NEW[int(rng.integers(0, len(SERVE_MAX_NEW)))],
                    int(rng.integers(0, 3))) for _ in range(n_req)]
        submitted = []
        for _ in range(3 * n_req):
            op = int(rng.integers(0, 4))
            if op == 0 and pending:
                pi, mn, pr = pending.pop()
                submitted.append((pi, mn, sched.submit(prompts[pi], max_new=mn, priority=pr)))
            elif op == 1:
                live = [r for _, _, r in submitted if r.state is RequestState.DECODING]
                if live:
                    sched.park(live[int(rng.integers(0, len(live)))].rid)
            else:
                sched.step()
        for pi, mn, pr in pending:
            submitted.append((pi, mn, sched.submit(prompts[pi], max_new=mn, priority=pr)))
        sched.run(max_ticks=2000)
        for pi, mn, req in submitted:
            if req.state is not RequestState.DONE or req.out != solo(pi, mn):
                raise AssertionError(f"[11a] program {seed}, request {req.rid}: {req.state.name} "
                                     f"{req.out} != solo {solo(pi, mn)}")
        if sched.resident_bytes != 0:
            raise AssertionError(f"[11a] program {seed}: resident_bytes {sched.resident_bytes}")
        checked += len(submitted)
        evictions += sched.counters["evicted"]
    log(f"[11a] {SERVE_PROGRAMS} seeded scheduler programs on the card: {checked} requests, each "
        f"token-equal to its solo single-slot run; {evictions} evictions resumed; "
        "resident_bytes drained to 0 each time")
    return checked


def serving_full_width(card, model) -> dict:
    """Phase 11 (b): ``model`` (deepseek-7b at full width, bf16) behind
    ``Engine(batch_slots=8, max_len=SERVE_MAX_LEN)`` and a ``Scheduler``
    under each accounting, with a budget of 6 raw sequences:
    ``SERVE_REQUESTS`` requests of a ``SERVE_PROMPT``-token prompt whose
    final context fills the cache, then after 3 steps one priority-1
    request; drained.  Every request gets its ``max_new`` tokens, the
    priority-1 request is never evicted, ``resident_bytes`` drains to 0.
    A throwaway engine first runs one prefill and one tick at these shapes,
    so neither timed run pays the first call.  Returns per accounting the
    counters, tokens/s, TTFT, ms per tick and wall time (host clock; every
    tick ends with its tokens on the host)."""
    import statistics

    import numpy as np

    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scheduler import Scheduler

    spec = model.kv_cache_spec(SERVE_MAX_LEN)
    raw_seq = model.n_kv_layers * spec.raw_bytes(1)
    budget = 6 * raw_seq
    max_new = SERVE_MAX_LEN - SERVE_PROMPT
    rng = np.random.default_rng(SEED)
    vocab = model.cfg.vocab_size
    warm = Engine(model, batch_slots=8, max_len=SERVE_MAX_LEN)
    warm.admit([Request(0, np.arange(SERVE_PROMPT, dtype=np.int32), max_new=2)])
    warm.tick()
    del warm
    out = {}
    for accounting in ("raw", "compressed"):
        eng = Engine(model, batch_slots=8, max_len=SERVE_MAX_LEN)
        sched = Scheduler(eng, byte_budget=budget, accounting=accounting)
        t0 = time.perf_counter()
        reqs = [sched.submit(rng.integers(0, vocab, SERVE_PROMPT).astype(np.int32),
                             max_new=max_new) for _ in range(SERVE_REQUESTS)]
        for _ in range(3):
            sched.step()
        vip = sched.submit(rng.integers(0, vocab, SERVE_PROMPT).astype(np.int32),
                           max_new=max_new, priority=1)
        sched.run()
        wall = time.perf_counter() - t0
        c = dict(sched.counters)
        allr = reqs + [vip]
        if not all(len(r.out) == max_new and 0 <= min(r.out) and max(r.out) < vocab
                   for r in allr):
            raise AssertionError(f"[11b] {accounting}: a request did not get {max_new} tokens "
                                 "in the vocabulary")
        if vip.evictions or sched.resident_bytes:
            raise AssertionError(f"[11b] {accounting}: priority-1 evictions {vip.evictions}, "
                                 f"resident_bytes {sched.resident_bytes}")
        ttft = sorted(r.first_token_t - r.submit_t for r in allr)
        out[accounting] = {
            "bytes_per_seq": sched.bytes_per_seq, "reserve": reqs[0]._reserved,
            "peak_resident": c["peak_resident"], "evicted": c["evicted"],
            "resumed": c["resumed"], "tokens": c["tokens"], "ticks": sched.ticks,
            "wall_s": wall, "tokens_s": c["tokens"] / wall,
            "ttft_ms_median": statistics.median(ttft) * 1e3, "ttft_ms_max": ttft[-1] * 1e3,
            "ms_per_tick": wall / sched.ticks * 1e3,
            "vip_wait_ticks": vip.admit_tick - vip.submit_tick}
        o = out[accounting]
        log(f"[11b] {accounting:>10}: budget {budget} B (6 raw sequences), a request reserves "
            f"{o['reserve']} B -> peak resident {o['peak_resident']}, evictions {o['evicted']}, "
            f"resumes {o['resumed']}, {o['tokens']} tokens in {o['ticks']} ticks, "
            f"{o['wall_s']:.3f} s: {o['tokens_s']:.1f} tokens/s, TTFT median "
            f"{o['ttft_ms_median']:.2f} ms, max {o['ttft_ms_max']:.2f} ms, "
            f"{o['ms_per_tick']:.3f} ms a tick; priority-1 request waited {o['vip_wait_ticks']} "
            f"ticks (host clock; {card_tag(card)})")
    return out


def serving_scripts(card) -> None:
    """Phase 11 (c): the two ``KVSession`` benchmark scripts on ``card``,
    for their kernel launches and the attention check; their times at the
    reference's toy sizes are launch-bound and not reported.
    ``decode_microbench_torch --quick``: ``resident`` flushes run the encode
    and decode kernels, ``full`` (the oracle backend) the decode kernel over
    every page each attend.  ``bench_kvcache_torch``: 96 single-token pages
    through the encode kernel, then ``auto`` on a cache with no resident
    region, which is the paged-attention kernel; its output is held to the
    same run on the CPU (plain versions), with the base table fitted on the
    card carried over so both compress the same pages, within bf16
    tolerance."""
    import torch

    art = _load_script("benchmarks/decode_microbench_torch.py").main(
        ["--quick", "--json", ""])
    if not (len(art["rows"]) == 4 and all(0 < r["us_best"] <= r["us_per_token"]
                                          for r in art["rows"])):
        raise AssertionError(f"[11c] decode_microbench rows {art['rows']}")
    log(f"[11c] decode_microbench_torch --quick ({art['device']}, {art['power_limit']}): "
        f"{len(art['rows'])} rows (contexts x resident/full)")
    kv = _load_script("benchmarks/bench_kvcache_torch.py")
    got = kv.main([])
    cpu = kv.run("cpu", bases=got["bases"].to("cpu"))
    diff = float((got["out"].float().cpu() - cpu["out"].float()).abs().max())
    torch.testing.assert_close(got["out"].float().cpu(), cpu["out"].float(), rtol=1.6e-2,
                               atol=1e-2)
    if not got["max_rel"] < 0.01:
        raise AssertionError(f"[11c] bench_kvcache attention error {got['max_rel']} (CPU "
                             f"{cpu['max_rel']})")
    log(f"[11c] bench_kvcache_torch: attention error on the card max_abs {got['max_abs']:.4f}, "
        f"max_rel {got['max_rel']:.4f} (CPU plain {cpu['max_abs']:.4f}, {cpu['max_rel']:.4f}); "
        f"card vs CPU output max abs diff {diff:.4g} (bf16 tolerance rtol 1.6e-2, atol 1e-2)")


#: phase 12: batches of the front-end's host stream, repeats of its timing,
#: the trainer's steps and checkpoint interval, the ring's world
STREAM_BATCHES, STREAM_REPEATS = 16, 5
TRAIN_STEPS, TRAIN_EVERY, TRAIN_FAIL_AT = 4, 2, 3
RING_WORLD = 2


def front_end(card, cfg, pages, table) -> dict:
    """Phase 12 (a): ``pages`` (a codec stream's int32 pages on ``card``)
    as a pinned host stream in :data:`STREAM_BATCHES` batches through
    ``encode_stream`` and back through ``decode_stream``, every blob and
    word equal to one ``ops.encode_pages`` / ``decode_pages`` call; the
    stream's time against a serial copy-then-encode from the same pinned
    batches (CUDA events, medians of :data:`STREAM_REPEATS`, in turns); and
    ``devices=2`` (the card twice) and ``encode_pages_sharded(devices=3)``
    against the single call."""
    import torch

    from repro_torch.kernels import ops, pipeline

    want = ops.encode_pages(pages, table, cfg)
    words = ops.decode_pages(want, table, cfg)
    host = torch.empty(pages.shape, dtype=pages.dtype, pin_memory=True)
    host.copy_(pages)
    batches = torch.tensor_split(host, STREAM_BATCHES)
    bounds = [0]
    for b in batches:
        bounds.append(bounds[-1] + b.shape[0])

    def check(label: str, got: dict) -> None:
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"[12a] {label}: field {k} differs from one encode call")

    blobs = list(pipeline.encode_stream(batches, table, cfg, device=card))
    check("encode_stream", {k: torch.cat([b[k] for b in blobs]) for k in want})
    host_blobs = [{k: want[k][lo:hi].cpu().pin_memory() for k in want}
                  for lo, hi in zip(bounds, bounds[1:])]
    got = torch.cat(list(pipeline.decode_stream(host_blobs, table, cfg, device=card)))
    if not torch.equal(got, words):
        raise AssertionError("[12a] decode_stream words differ from one decode call")
    check("devices=2", pipeline.encode_pages(pages, table, cfg, devices=2))
    check("encode_pages_sharded(devices=3)",
          pipeline.encode_pages_sharded(pages, table, cfg, devices=3))
    if not torch.equal(pipeline.decode_pages(want, table, cfg, devices=2), words):
        raise AssertionError("[12a] decode_pages(devices=2) differs from one decode call")
    del blobs, host_blobs, got, words

    def serial():
        for b in batches:
            ops.encode_pages(b.to(card, non_blocking=True), table, cfg)

    def streamed():
        for _ in pipeline.encode_stream(batches, table, cfg, device=card):
            pass

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(card)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    serial()
    streamed()
    times = {"serial": [], "stream": []}
    for i in range(STREAM_REPEATS):
        order = ("serial", "stream") if i % 2 == 0 else ("stream", "serial")
        for name in order:
            times[name].append(event_ms(serial if name == "serial" else streamed))
    copy_ms = sorted(event_ms(lambda: [b.to(card, non_blocking=True) for b in batches])
                     for _ in range(STREAM_REPEATS))[STREAM_REPEATS // 2]
    enc_ms = sorted(event_ms(lambda: ops.encode_pages(pages, table, cfg))
                    for _ in range(STREAM_REPEATS))[STREAM_REPEATS // 2]
    nbytes = host.numel() * host.element_size()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    out = {"bytes": nbytes, "serial_ms": med["serial"], "stream_ms": med["stream"],
           "copy_ms": copy_ms, "encode_ms": enc_ms,
           "serial_gib_s": nbytes / (1 << 30) / (med["serial"] / 1e3),
           "stream_gib_s": nbytes / (1 << 30) / (med["stream"] / 1e3)}
    log(f"[12a] encode_stream / decode_stream of {pages.shape[0]} pages ({nbytes} B of int32 "
        f"word pages, pinned, {STREAM_BATCHES} batches) bit-identical to one encode and one "
        "decode call; devices=2 and encode_pages_sharded(devices=3) identical too")
    log(f"[12a] double-buffered stream {med['stream']:.3f} ms ({out['stream_gib_s']:.2f} GiB/s) "
        f"vs serial copy-then-encode {med['serial']:.3f} ms ({out['serial_gib_s']:.2f} GiB/s), "
        f"medians of {STREAM_REPEATS} in turns (all: stream "
        + ", ".join(f"{t:.3f}" for t in times["stream"]) + "; serial "
        + ", ".join(f"{t:.3f}" for t in times["serial"]) + f"); the copies alone {copy_ms:.3f} "
        f"ms, one encode of all pages {enc_ms:.3f} ms (CUDA events; {card_tag(card)})")
    return out


def _crc_tree(tree) -> dict:
    """crc32 of each leaf's bytes, keyed by its path (host threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch._tree import path_str, tree_flatten_with_path
    from repro_torch.interop import params_to_numpy

    leaves = [(path_str(p), t) for p, t in tree_flatten_with_path(tree)]
    with ThreadPoolExecutor(8) as pool:
        crcs = pool.map(lambda kv: zlib.crc32(params_to_numpy(kv[1]).tobytes()), leaves)
        return dict(zip((k for k, _ in leaves), crcs))


def full_width_trainer(card, ckpt_root: Path) -> dict:
    """Phase 12 (b): deepseek-7b at its published width (:data:`FULL_LAYERS`
    layers, bf16) under ``Trainer`` with the phase-10 batch (4 x 32):
    :data:`TRAIN_STEPS` steps with a checkpoint and an FR refit every
    :data:`TRAIN_EVERY`; then a run that crashes at :data:`TRAIN_FAIL_AT`
    and one that resumes from its checkpoint.  The resumed run's parameters
    and moments must equal the uninterrupted run's (crc32 of each leaf).
    Returns the step and checkpoint times, the stored bytes, the peak
    memory, the refit table and the wall time (host clock around
    synchronised work)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import trainer as trainer_mod

    def sync() -> None:
        if card.type == "cuda":
            torch.cuda.synchronize(card)

    times = {"step_ms": [], "save_s": [], "load_s": []}
    saves = []

    def timed(fn, label: str, scale: float):
        def wrapper(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            times[label].append((time.perf_counter() - t0) * scale)
            return out
        return wrapper

    class TimedCkpt:
        latest_step = staticmethod(ckpt.latest_step)
        load = staticmethod(timed(ckpt.load, "load_s", 1.0))

        @staticmethod
        def save(*args, **kw):
            stats = timed(ckpt.save, "save_s", 1.0)(*args, **kw)
            saves.append(stats)
            return stats

    t_all = time.perf_counter()
    cfg = dataclasses.replace(get_config(FULL_ARCH), n_layers=FULL_LAYERS)
    model = build_model(cfg, card)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab_size, 32, 4, seed=0))
    acfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    def trainer(ckpt_dir: Path, fail_at: int = -1):
        tr = trainer_mod.Trainer(model, acfg, pipe, trainer_mod.TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_EVERY, ckpt_dir=str(ckpt_dir),
            log_every=1, refit_fr_every=TRAIN_EVERY, fail_at_step=fail_at))
        tr.step_fn = timed(tr.step_fn, "step_ms", 1e3)
        return tr

    real_ckpt = trainer_mod.ckpt
    trainer_mod.ckpt = TimedCkpt
    if card.type == "cuda":
        torch.cuda.reset_peak_memory_stats(card)
    try:
        tr = trainer(ckpt_root / "straight")
        params, opt = tr.run(seed=SEED)
        want = _crc_tree({"params": params, "opt": opt})
        fr_bases = tr.fr_bases
        losses = [h["loss"] for h in tr.history if "loss" in h]
        del params, opt, tr
        crashing = trainer(ckpt_root / "crash", fail_at=TRAIN_FAIL_AT)
        try:
            crashing.run(seed=SEED)
            raise AssertionError(f"[12b] no failure was injected at step {TRAIN_FAIL_AT}")
        except trainer_mod.SimulatedFailure:
            pass
        del crashing
        resumed = trainer(ckpt_root / "crash")
        params, opt = resumed.run(seed=SEED)
        got = _crc_tree({"params": params, "opt": opt})
        resumed_from = resumed.history[0]["step"]
        del params, opt, resumed
    finally:
        trainer_mod.ckpt = real_ckpt
    peak = torch.cuda.max_memory_allocated(card) if card.type == "cuda" else 0
    del model
    if card.type == "cuda":
        torch.cuda.empty_cache()
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]]
        raise AssertionError(f"[12b] resumed run differs from the uninterrupted one in {bad}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[12b] losses {losses}")
    manifest = json.loads((ckpt_root / "straight" / f"step_{TRAIN_STEPS}" / "manifest.json")
                          .read_text())
    codecs = {k: e["codec"] for k, e in manifest["leaves"].items()}
    out = {"losses": losses, "resumed_from": resumed_from, "leaves": len(want),
           "fr_bases": fr_bases.bases.tolist(), "fr_widths": fr_bases.widths.tolist(),
           "saves": saves, "peak": peak, "wall_s": time.perf_counter() - t_all, **times}
    st = saves[0]
    log(f"[12b] {FULL_ARCH} at full width, {FULL_LAYERS} layers, {cfg.dtype}: Trainer "
        f"{TRAIN_STEPS} steps (batch 4 x 32), checkpoint and FR refit every {TRAIN_EVERY}; "
        f"losses {[round(v, 4) for v in losses]}; a run crashed at step {TRAIN_FAIL_AT} and "
        f"resumed from step {resumed_from}: all {len(want)} leaves (parameters and moments) "
        "crc32-equal to the uninterrupted run")
    log("[12b] step ms " + ", ".join(f"{t:.1f}" for t in times["step_ms"])
        + "; checkpoint save s " + ", ".join(f"{t:.2f}" for t in times["save_s"])
        + "; load s " + ", ".join(f"{t:.2f}" for t in times["load_s"])
        + f"; bytes raw {st['bytes_raw']}, stored {st['bytes_stored']}, ratio {st['ratio']:.4f} "
        "(later saves: " + ", ".join(f"{s['bytes_stored']} B, {s['ratio']:.4f}" for s in saves[1:])
        + f"); peak memory {peak} B; refit fr_bases {out['fr_bases']} widths "
        f"{out['fr_widths']}; wall {out['wall_s']:.1f} s (host clock, synchronised; "
        f"{card_tag(card)})")
    log(f"[12b] step-{TRAIN_STEPS} checkpoint codecs: "
        + ", ".join(f"{k} {c}" for k, c in codecs.items()))
    return out


def _hold_ring_leaves(grads, table) -> list[dict]:
    """Kernels A and B against their plain versions on the ring's own
    inputs: each gradient leaf encoded as the ring encodes it
    (``collectives._encode_leaf``: its bf16 words in ``GRAD_FR`` pages, one
    pipeline call) and decoded as the ring decodes it
    (``pipeline.decode_pages``), against ``gbdi_encode_plain`` on the same
    pages and ``gbdi_decode_plain`` on the same blob, :data:`CHUNK_PAGES`
    pages at a time.  Raises unless every blob field (``n_dropped``
    included) and every word is equal bit for bit.  Returns per leaf its
    pages, the words the kernel's and the plain encode dropped, and the
    words that do not come back as they went in."""
    import torch

    from repro_torch._tree import path_str, tree_flatten_with_path
    from repro_torch.core.gbdi_fr import bf16_to_words
    from repro_torch.distributed import collectives
    from repro_torch.kernels import gbdi_decode as dec_mod
    from repro_torch.kernels import gbdi_encode as enc_mod
    from repro_torch.kernels import pipeline

    def diff(a, b) -> int:
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    cfg = collectives.GRAD_FR
    rows = []
    for p, g in tree_flatten_with_path(grads):
        kb = collectives._encode_leaf(g, table)
        kw = pipeline.decode_pages(kb, table, cfg)
        words = bf16_to_words(g.reshape(-1))
        words = torch.nn.functional.pad(words, (0, (-words.numel()) % cfg.page_words))
        words = words.reshape(-1, cfg.page_words)
        row = {"leaf": path_str(p), "words": g.numel(), "pages": words.shape[0], "enc_err": 0,
               "dec_err": 0, "kernel_dropped": int(kb["n_dropped"].sum()), "plain_dropped": 0,
               "lost": 0}
        for i in range(0, words.shape[0], CHUNK_PAGES):
            sl = slice(i, i + CHUNK_PAGES)
            pb = enc_mod.gbdi_encode_plain(words[sl], table, cfg)
            if set(pb) != set(kb):
                raise AssertionError(f"[12c] {row['leaf']}: blob keys {sorted(kb)} != {sorted(pb)}")
            row["enc_err"] = max(row["enc_err"], *(diff(kb[k][sl], pb[k]) for k in pb))
            pw = dec_mod.gbdi_decode_plain({k: v[sl] for k, v in kb.items()}, table, cfg)
            row["dec_err"] = max(row["dec_err"], diff(kw[sl], pw))
            row["plain_dropped"] += int(pb["n_dropped"].sum())
            row["lost"] += int((pw != words[sl]).sum())
        if row["enc_err"] or row["dec_err"] or row["kernel_dropped"] != row["plain_dropped"]:
            raise AssertionError(f"[12c] {row['leaf']}: kernels differ from plain on the ring's "
                                 f"leaf: {row}")
        rows.append(row)
        del kb, kw, words
    return rows


def _ring_rank(rank: int, world: int, payload: dict) -> dict:
    """Phase 12 (c), one rank: the full-width model from the shared seed on
    ``payload['device']``, the gradients of this rank's batch, kernels A and
    B held to their plain versions on every leaf as the ring encodes it
    (:func:`_hold_ring_leaves`, before the counts are zeroed), the ring mean
    under the refit table against ``plain_pod_mean``, the ring under a table
    fitted on rank 0's gradients, then one ``make_train_step(compress_grads=
    True)`` step; returns counts, errors, times, launches and crc32s."""
    import torch
    import torch.distributed as dist

    from repro_torch import interop
    from repro_torch._tree import path_str, tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed import collectives
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import train_step

    card = torch.device(payload["device"])

    def sync() -> None:
        if card.type == "cuda":
            torch.cuda.synchronize(card)

    cfg = dataclasses.replace(get_config(FULL_ARCH), n_layers=FULL_LAYERS)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(SEED))
    state = adamw.init_state(params)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab_size, 32, 2, seed=0))
    batch = pipe.batch_at(0, host=rank, n_hosts=world)
    refit = interop.table_from_numpy(*payload["fr_bases"], device=card)
    loss, grads = train_step._grads(model, batch)
    names = [path_str(p) for p, _ in tree_flatten_with_path(grads)]
    n_grad = sum(t.numel() for _, t in tree_flatten_with_path(grads))
    sync()
    t0 = time.perf_counter()
    held = _hold_ring_leaves(grads, refit)
    sync()
    reset_launches("gbdi_encode", "gbdi_decode")
    out = {"rank": rank, "loss": float(loss), "ring": {}, "n_grad": n_grad, "held": held,
           "held_s": time.perf_counter() - t0}

    dist.barrier()
    sync()
    t0 = time.perf_counter()
    plain = collectives.plain_pod_mean(grads)
    sync()
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3

    def ring(label: str, table) -> None:
        stats = {}
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        comp = collectives.compressed_pod_mean(grads, table, stats=stats)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        leaves = []
        for name, c, p in zip(names, (t for _, t in tree_flatten_with_path(comp)),
                              (t for _, t in tree_flatten_with_path(plain))):
            cf, pf = c.float(), p.float()
            err = float((cf - pf).abs().max())
            scale = float(pf.abs().max())
            leaves.append({"leaf": name, "mismatched": int((c != p).sum()), "max_err": err,
                           "max_plain": scale, "within_tol": err <= 2e-2 * scale + 1e-6,
                           "all_zero": bool((cf == 0).all()), "finite": bool(cf.isfinite().all())})
        out["ring"][label] = {"ms": ms, **stats, "leaves": leaves}
        del comp

    ring("refit", refit)
    # a table fitted on rank 0's gradient words (the refit's sample rule), shared
    if rank == 0:
        big = [g for g in (t for _, t in tree_flatten_with_path(grads)) if g.numel() > 4096]
        sample = torch.cat([g.reshape(-1)[:4096] for g in big[:8]])
        gtab = fit_fr_bases(bf16_to_words(sample), collectives.GRAD_FR)
        shared = torch.stack([gtab.bases.cpu(), gtab.widths.cpu()])
    else:
        shared = torch.zeros((2, collectives.GRAD_FR.num_bases), dtype=torch.int32)
    dist.broadcast(shared, src=0)
    out["grad_fit_bases"] = shared[0].tolist()
    ring("grad_fit", interop.table_from_numpy(shared[0].numpy(), shared[1].numpy(), device=card))
    del grads, plain
    model.set_params(params)
    step = train_step.make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                               total_steps=10),
                                      compress_grads=True, fr_bases=refit)
    sync()
    t0 = time.perf_counter()
    new_params, _, metrics = step(params, state, batch)
    sync()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["step_loss"] = float(metrics["loss"])
    out["finite"] = all(bool(t.float().isfinite().all()) for _, t in tree_flatten_with_path(new_params))
    out["crc"] = {path_str(p): zlib.crc32(interop.params_to_numpy(t).tobytes())
                  for p, t in tree_flatten_with_path(new_params)}
    out["launches"] = launch_counts("gbdi_encode", "gbdi_decode")
    out["peak"] = torch.cuda.max_memory_allocated(card) if card.type == "cuda" else 0
    return out


def ring_on_card(card, fr_bases: tuple) -> dict:
    """Phase 12 (c): :func:`_ring_rank` on :data:`RING_WORLD` gloo ranks,
    each a process with its own CUDA context on ``card``.  Gates: on each
    rank, before its ring runs, kernels A and B equal their plain versions
    bit for bit on every leaf as the ring encodes and decodes it (blobs,
    ``n_dropped`` included, and words), so the words the ring drops are the
    format's, not the kernel's; the ring
    mean under the refit table equals ``plain_pod_mean`` on every word the
    other rank's encode did not drop (GBDI-FR is lossless in capacity), so
    a rank's mismatched words are at most the other rank's dropped words;
    each rank launched kernels A and B; every updated parameter is finite.
    Reported: the reference test's bf16-transport tolerance per leaf, the
    same under a table fitted on the gradients, the crc32 agreement of the
    two ranks' updated parameters, wire bytes, times and peak memory."""
    from repro_torch.distributed.spawn import run_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(_ring_rank, RING_WORLD,
                         {"device": str(card), "fr_bases": fr_bases},
                         init_dir=tmp, timeout_s=900.0)
    wall = time.perf_counter() - t0
    for r, out in enumerate(outs):
        held = out["held"]
        log(f"[12c] rank {r}: kernels A and B bit-identical to plain on all {len(held)} "
            f"gradient leaves as the ring encodes them ({sum(h['pages'] for h in held)} GRAD_FR "
            f"pages, refit table; {out['held_s']:.1f} s); words dropped per leaf, kernel / plain "
            "encode (words that do not come back): "
            + ", ".join(f"{h['leaf']} {h['kernel_dropped']}/{h['plain_dropped']} ({h['lost']}) of "
                        f"{h['words']}" for h in held))
        other = outs[(r - 1) % RING_WORLD]
        for label, ring in out["ring"].items():
            mism = sum(leaf["mismatched"] for leaf in ring["leaves"])
            ok = sum(leaf["within_tol"] and not leaf["all_zero"] for leaf in ring["leaves"])
            log(f"[12c] rank {r} {label} table: exchange {ring['ms']:.1f} ms, wire "
                f"{ring['wire_bytes']} B sent, {ring['n_dropped']} words dropped by this rank's "
                f"encode; {mism} words differ from plain_pod_mean; reference bf16-transport "
                f"tolerance (2e-2 max|plain| + 1e-6, not all zero) held on {ok} of "
                f"{len(ring['leaves'])} leaves")
            for leaf in ring["leaves"]:
                if not leaf["finite"]:
                    raise AssertionError(f"[12c] rank {r} {label} {leaf['leaf']}: not finite")
            if label == "refit" and mism > other["ring"][label]["n_dropped"]:
                raise AssertionError(f"[12c] rank {r}: {mism} words differ from plain_pod_mean, "
                                     f"more than the {other['ring'][label]['n_dropped']} the "
                                     "other rank dropped")
        if not (out["launches"]["gbdi_encode"] > 0 and out["launches"]["gbdi_decode"] > 0):
            raise AssertionError(f"[12c] rank {r} launches {out['launches']}")
        if not out["finite"]:
            raise AssertionError(f"[12c] rank {r}: updated parameters not finite")
    same = sum(outs[0]["crc"][k] == outs[1]["crc"][k] for k in outs[0]["crc"])
    n = outs[0]["n_grad"]
    log(f"[12c] cross-pod wire bytes a rank: GBDI-FR ring {outs[0]['ring']['refit']['wire_bytes']} "
        f"B against a bf16 all-reduce payload of {2 * n} B and a float32 one of {4 * n} B "
        f"({n} gradient elements)")
    log(f"[12c] {RING_WORLD} gloo ranks on {card} ({card_tag(card)}): losses "
        f"{[round(o['loss'], 4) for o in outs]}; plain_pod_mean "
        + ", ".join(f"{o['plain_ms']:.1f}" for o in outs) + " ms; compressed train step "
        + ", ".join(f"{o['step_ms']:.1f}" for o in outs) + " ms; updated parameters crc32-equal "
        f"across ranks on {same} of {len(outs[0]['crc'])} leaves; launches "
        f"{[o['launches'] for o in outs]}; peak memory {[o['peak'] for o in outs]} B; "
        f"wall {wall:.1f} s")
    return {"outs": outs, "wall_s": wall, "crc_equal": same,
            "err": {"gbdi_encode": max(h["enc_err"] for o in outs for h in o["held"]),
                    "gbdi_decode": max(h["dec_err"] for o in outs for h in o["held"])}}


def slice_scripts(card, ckpt_root: Path) -> None:
    """Phase 12 (d): the slice's scripts as subprocesses on the card:
    ``bench_throughput_torch --quick`` (its five codecs' rows),
    ``bench_gradcomp_torch`` (its two lines), ``gradient_compression_demo_torch``
    and ``launch.train`` on the reduced deepseek-7b for 6 steps, killed after a
    checkpoint and run again, which resumes from it."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def run(args: list[str], timeout: float = 600.0) -> str:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"[12d] {args} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        log(f"[12d] {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
        return proc.stdout

    out = run(["benchmarks/bench_throughput_torch.py", "--quick", "--json", ""])
    codecs = {line.split("/")[1].rsplit("_", 1)[0] for line in out.splitlines()
              if line.startswith("throughput/")}
    if codecs != {"gbdi", "bdi", "fr", "fr_xla", "fr_kernel"}:
        raise AssertionError(f"[12d] throughput rows for {sorted(codecs)}")
    for line in out.splitlines():
        if line.startswith("throughput/fr"):
            log(f"    {line}")
    out = run(["benchmarks/bench_gradcomp_torch.py"])
    lines = [line for line in out.splitlines() if line.startswith("gradcomp/")]
    if [line.split(",")[0] for line in lines] != ["gradcomp/wire_bytes", "gradcomp/fidelity"]:
        raise AssertionError(f"[12d] bench_gradcomp_torch printed {out!r}")
    for line in lines:
        log(f"    {line}")
    out = run(["examples/gradient_compression_demo_torch.py"])
    for line in out.splitlines():
        log(f"    {line}")

    ck = ckpt_root / "cli"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", FULL_ARCH, "--reduced",
           "--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
           "--ckpt-dir", str(ck)]
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while not (ck / "LATEST").exists() and proc.poll() is None:
            if time.monotonic() > deadline:
                raise AssertionError("[12d] launch.train wrote no checkpoint in 300 s")
            time.sleep(0.01)
        running = proc.poll() is None
        proc.kill()
    finally:
        proc.wait(timeout=60)
        proc.stdout.close()
    killed_at = int((ck / "LATEST").read_text())
    if not running or killed_at >= 6:
        raise AssertionError(f"[12d] launch.train ended before the kill (checkpoint {killed_at})")
    out = run(cmd[1:])
    steps = [int(line.split()[1]) for line in out.splitlines() if line.startswith("step")]
    if not steps or steps[0] != killed_at or (ck / "LATEST").read_text() != "6":
        raise AssertionError(f"[12d] the rerun did not resume from step {killed_at}:\n{out}")
    log(f"[12d] launch.train killed after its step-{killed_at} checkpoint; the rerun resumed "
        f"there and finished at step 6:")
    for line in out.splitlines():
        log(f"    {line}")


#: phase 13: the six configs past the dense family at their published widths
#: (src/repro/configs/*, bf16), each with the depth on the card: cut only where
#: 80 GB forces it (about 12 B a trained parameter: bf16 weights and
#: gradients, float32 AdamW moments)
ZOO = {"mixtral-8x22b": 1, "qwen3-moe-235b-a22b": 1, "zamba2-7b": 18, "xlstm-1.3b": 48,
       "paligemma-3b": 18, "musicgen-large": 48}
#: phase 13 (b): the training batch, 4 x 32 positions (paligemma's 256 patches
#: go ahead of its 32 tokens); qwen3 trains on 4 x 512 so that T * top_k =
#: 16,384 > 8,192 takes the MoE capacity path
ZOO_BATCH, ZOO_SEQ = 4, {"qwen3-moe-235b-a22b": 512}
#: phase 13 (c): the configs whose requests also run through Engine ticks
ZOO_ENGINE = ("mixtral-8x22b", "qwen3-moe-235b-a22b", "zamba2-7b", "xlstm-1.3b")
#: phase 13 (c): serving consistency, decode at S against the forward at S + 1.
#: In bf16 every logit within ZOO_SERVE_BF16_TOL x (1 + |logit|), the
#: rtol = atol = 0.15 of tests/test_models_smoke.py; on a float32 copy of the
#: full-width weights within ZOO_SERVE_TOL of max(1, |logit|)
ZOO_SERVE_BF16_TOL, ZOO_SERVE_TOL = 0.15, 1e-2
#: phase 13 (c): configs whose bf16 consistency is reported, not held: 48
#: xLSTM layers amplify bf16 rounding to 11-40 % of the logits' norm (float32:
#: 0.03-0.07 %; NVIDIA H100 80GB HBM3, 700.00 W), and the reference's own bf16
#: drifts as far at that depth (tests/test_torch_families.py::
#: test_xlstm_bf16_decode_at_full_depth_drifts_as_the_reference)
ZOO_BF16_DRIFT = ("xlstm-1.3b",)
#: phase 13 (a): card vs CPU on a narrow float32 copy, relative to max(1, |x|)
ZOO_F32_TOL = 1e-3
#: phase 13 (d): each capture's sample, and the dump suite's bytes a family
ZOO_CAPTURE_BYTES, ZOO_SUITE_BYTES = 64 << 20, 16 << 20
#: phase 13 (e): kernel C at these configs' attention geometries, over the
#: K/V that layer 0 writes for a 2,048-token prompt at batch 4; a config not
#: in ZOO (deepseek-7b, whose row spans two page slots) is built at full
#: width with one layer for this step alone
ZOO_ATTN, ZOO_PROMPT = ("mixtral-8x22b", "qwen3-moe-235b-a22b", "paligemma-3b",
                        "musicgen-large", "deepseek-7b"), 2048


def zoo_batch(cfg, batch: int, seq: int, card, seed: int = SEED) -> dict:
    """A seeded batch of ``seq`` text positions in the family's layout on
    ``card``: token ids from ``TokenPipeline``; paligemma's 256 patch
    embeddings ahead of them; musicgen's frame embeddings and 4 codebook
    targets."""
    import torch

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    gen = torch.Generator(device=card).manual_seed(seed)
    if cfg.family == "audio":
        return {"frame_embeds": torch.randn(batch, seq, cfg.d_model, generator=gen, device=card),
                "targets": torch.randint(0, cfg.vocab_size, (batch, seq, cfg.n_codebooks),
                                         generator=gen, device=card)}
    toks = TokenPipeline(PipelineConfig(cfg.vocab_size, seq, batch, seed=seed)).batch_at(0)
    out = {"tokens": torch.as_tensor(toks["tokens"], device=card)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn(batch, cfg.n_patches, cfg.d_model, generator=gen,
                                          device=card)
    return out


def _next_input(cfg, logits, card, gen) -> dict:
    """A decode step's input: the greedy tokens (audio: fresh frames)."""
    import torch

    if cfg.family == "audio":
        return {"frame_embeds": torch.randn(logits.shape[0], 1, cfg.d_model, generator=gen,
                                            device=card)}
    return {"tokens": logits[:, -1].float().argmax(-1)[:, None]}


def zoo_parity(card, arch: str) -> None:
    """Phase 13 (a): the reduced float32 copy of ``arch`` from one CPU init,
    carried to ``card``: logits, loss, a prefill and one decode step equal
    the CPU's within :data:`ZOO_F32_TOL` of max(1, |x|) (the loss: 1e-5
    relative)."""
    import dataclasses as dc

    import torch

    from repro_torch import interop
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.api import build_model

    cfg = dc.replace(reduced(ARCHS[arch]), dtype="float32")
    models = {"cpu": build_model(cfg, "cpu")}
    models["cpu"].init(torch.Generator().manual_seed(SEED))
    models["card"] = build_model(cfg, card)
    models["card"].set_params(interop.params_from_numpy(
        interop.params_to_numpy(models["cpu"].params()), card))
    batch = zoo_batch(cfg, 2, 32, "cpu")
    out, step = {}, None
    for where, m in models.items():            # the CPU first: its step feeds both
        b = {k: v.to(m.device) for k, v in batch.items()}
        with torch.no_grad():
            cache, pre = m.prefill(b, m.init_cache(2, 34))
            step = step or ({"frame_embeds": batch["frame_embeds"][:, :1]}
                            if cfg.family == "audio" else _next_input(cfg, pre, "cpu", None))
            dec, _ = m.decode_step({k: v.to(m.device) for k, v in step.items()}, cache, 32)
            out[where] = {"logits": m.forward(b), "prefill": pre, "decode": dec,
                          "loss": m.loss(b)[0]}
            out[where] = {k: v.float().cpu() for k, v in out[where].items()}
    errs = []
    for name in ("logits", "prefill", "decode"):
        a, b = out["card"][name], out["cpu"][name]
        err = float((a - b).abs().max())
        errs.append(f"{name} {err:.3g}")
        if not err <= ZOO_F32_TOL * max(1.0, float(b.abs().max())):
            raise AssertionError(f"[13a] {arch}: card vs CPU {name} differ by {err}")
    lc, lp = float(out["card"]["loss"]), float(out["cpu"]["loss"])
    if not abs(lc - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"[13a] {arch}: loss card {lc} vs CPU {lp}")
    log(f"[13a] {arch} reduced float32 ({cfg.n_layers} layers, d_model {cfg.d_model}), one CPU "
        f"init carried to the card: max |card - CPU| {', '.join(errs)}; loss {lc:.6f} vs "
        f"{lp:.6f}")


def zoo_train(card, model, batch: dict) -> dict:
    """Phase 13 (b): two steps of the port's train step
    (``make_train_step``: loss, backward, the in-place AdamW update) on the
    full-width ``model``, from fresh AdamW moments; each step's loss and
    gradient norm finite (the norm is finite only if every gradient is),
    then every parameter finite.  Returns the steps' losses, gradient norms
    and times (ms, host clock around synchronised steps) and the peak
    memory."""
    import numpy as np
    import torch

    from repro_torch._tree import path_str, tree_flatten_with_path
    from repro_torch.optim import adamw
    from repro_torch.training import train_step

    params = model.params()
    state = adamw.init_state(params)
    step = train_step.make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                               total_steps=10))
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for i in range(2):
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize(card)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        if not (np.isfinite(out["loss"][-1]) and np.isfinite(out["grad_norm"][-1])):
            raise AssertionError(f"[13b] {model.cfg.arch_id}: step {i + 1} loss "
                                 f"{out['loss'][-1]}, gradient norm {out['grad_norm'][-1]}")
    bad = [path_str(k) for k, p in tree_flatten_with_path(params) if not bool(p.isfinite().all())]
    if bad:
        raise AssertionError(f"[13b] {model.cfg.arch_id}: non-finite parameters {bad}")
    out["peak"] = torch.cuda.max_memory_allocated(card)
    del state
    return out


def _decode_vs_forward(model, batch: dict, prefix: int, S: int, gen) -> tuple:
    """Prefill ``batch``, three decode steps; returns (the cache, the step
    logits, times in ms, max |decode at S - forward at S + 1|, that
    forward's largest |logit|, relative L2 error per row, the largest
    |decode - forward| / (1 + |forward|) of any logit)."""
    import torch

    cfg, card = model.cfg, model.device
    times = {}

    def timed(label, fn):
        torch.cuda.synchronize(card)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(card)
        times[label] = (time.perf_counter() - t0) * 1e3
        return r

    cache, logits = timed("prefill", lambda: model.prefill(batch, model.init_cache(
        ZOO_BATCH, prefix + S + 4)))
    steps, outs = [], []
    for i in range(3):
        steps.append(_next_input(cfg, logits, card, gen))
        logits, cache = timed(f"decode{i}", lambda: model.decode_step(steps[-1], cache,
                                                                      prefix + S + i))
        if not bool(logits.float().isfinite().all()):
            raise AssertionError(f"[13c] {cfg.arch_id}: decode step {i} logits not finite")
        outs.append(logits)
    if cfg.family == "audio":
        full = {"frame_embeds": torch.cat([batch["frame_embeds"], steps[0]["frame_embeds"]], 1),
                "targets": torch.nn.functional.pad(batch["targets"], (0, 0, 0, 1))}
    else:
        full = {**batch, "tokens": torch.cat([batch["tokens"], steps[0]["tokens"]], 1)}
    with torch.no_grad():
        fwd = model.forward(full)[:, -1].float()
    d = outs[0][:, 0].float() - fwd
    rel = (d.flatten(1).norm(dim=1) / fwd.flatten(1).norm(dim=1)).tolist()
    worst = float((d.abs() / (1 + fwd.abs())).max())
    return cache, outs, times, float(d.abs().max()), float(fwd.abs().max()), rel, worst


def zoo_serve(card, model) -> tuple[dict, dict]:
    """Phase 13 (c): prefill of the training batch's shape and three greedy
    decode steps (timed); serving consistency, the first step held to the
    forward at S + 1: in bf16 within :data:`ZOO_SERVE_BF16_TOL` (but for
    :data:`ZOO_BF16_DRIFT`, reported), and on a float32 copy of the
    (trained) weights within :data:`ZOO_SERVE_TOL` of max(1, |logit|); for
    :data:`ZOO_ENGINE`, three requests through ``Engine`` ticks.  Returns
    (the bf16 serving cache, times in ms)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, Request

    cfg = model.cfg
    S = 32
    batch = zoo_batch(cfg, ZOO_BATCH, S, card, seed=SEED + 1)
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    cache, _, times, err16, _, rel16, worst16 = _decode_vs_forward(
        model, batch, prefix, S, torch.Generator(device=card).manual_seed(SEED))
    if cfg.arch_id not in ZOO_BF16_DRIFT and not worst16 <= ZOO_SERVE_BF16_TOL:
        raise AssertionError(f"[13c] {cfg.arch_id}: bf16 decode at {prefix + S} differs from the "
                             f"forward at {prefix + S + 1} by {worst16} x (1 + |logit|)")
    f32 = build_model(dc.replace(cfg, dtype="float32"), card)
    f32.set_params(tree_map(lambda p: p.detach().float(), model.params()))
    _, _, _, err, scale, rel, _ = _decode_vs_forward(
        f32, batch, prefix, S, torch.Generator(device=card).manual_seed(SEED))
    del f32
    torch.cuda.empty_cache()
    if not err <= ZOO_SERVE_TOL * max(1.0, scale):
        raise AssertionError(f"[13c] {cfg.arch_id}: float32 decode at {prefix + S} differs from "
                             f"the forward at {prefix + S + 1} by {err} (largest |logit| {scale})")
    log(f"[13c] {cfg.arch_id}: prefill of {ZOO_BATCH} x {prefix + S} {times['prefill']:.1f} ms, "
        "decode " + ", ".join(f"{times[f'decode{i}']:.1f}" for i in range(3)) + " ms a step "
        f"(bf16); decode at {prefix + S} vs the forward at {prefix + S + 1}, float32 copy: max "
        f"|diff| {err:.4g} of {scale:.4g}, relative L2 a row {max(rel):.3g} (tolerance "
        f"{ZOO_SERVE_TOL} of max(1, |logit|)); bf16: max |diff| {err16:.4g}, "
        f"{worst16:.4g} x (1 + |logit|) ("
        + ("reported only" if cfg.arch_id in ZOO_BF16_DRIFT else f"tolerance {ZOO_SERVE_BF16_TOL}")
        + f"), relative L2 a row {min(rel16):.3g}-{max(rel16):.3g} ({card_tag(card)})")
    if cfg.arch_id in ZOO_ENGINE:
        rng = np.random.default_rng(SEED)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 12).astype(np.int32), max_new=4)
                for i in range(3)]
        eng = Engine(model, batch_slots=4, max_len=32)
        t0 = time.perf_counter()
        eng.admit(reqs)
        ticks = 0
        while eng.tick():
            ticks += 1
        if not all(r.done and len(r.out) == 4 for r in reqs):
            raise AssertionError(f"[13c] {cfg.arch_id}: engine outputs {[r.out for r in reqs]}")
        log(f"[13c] {cfg.arch_id}: Engine(batch_slots=4): 3 requests of 12 tokens, 4 new each, "
            f"in {ticks + 1} ticks, {(time.perf_counter() - t0) * 1e3:.1f} ms ({card_tag(card)}); "
            f"tokens {[r.out for r in reqs]}")
        del eng
    return cache, times


def zoo_attention(card, model, counted: dict) -> tuple[dict, object]:
    """Phase 13 (e): a 2,048-token prompt at batch 4 (paligemma: 256 patches
    + 1,792 tokens) prefilled into ``model``, three greedy decode steps; layer
    0's K/V into a ``KVSession`` built from ``model.kv_cache_spec``, whose
    three steps (append + kernel C) are the counted path; at each step
    kernel C against its plain version within ``ATTN_TOL`` and the step
    against SDPA over the raw cache; then C and SDPA timed.  Every launch of
    C over rows that span several page slots is counted in
    ``launches.attn_multipage`` too, and no other.  Adds the session's
    launches to ``counted``; returns the geometry's row and the prompt's
    serving cache captured and sampled (:func:`sampled_image`)."""
    import torch

    from repro_torch import obs
    from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases
    from repro_torch.eval import run as eval_run
    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import KVSession

    cfg = model.cfg
    Kv, hd, H = cfg.n_kv_heads, cfg.head_dim_, cfg.n_heads
    G, B, T, steps = H // Kv, ZOO_BATCH, ZOO_PROMPT, 3
    attn0 = {k: obs.snapshot(spans=False)["counters"][f"launches.{k}"]
             for k in ("attn", "attn_multipage")}
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    gen = torch.Generator(device=card).manual_seed(SEED + 2)
    batch = zoo_batch(cfg, B, T - prefix, card, seed=SEED + 2)
    cache, logits = model.prefill(batch, model.init_cache(B, T + steps))
    for i in range(steps):
        logits, cache = model.decode_step(_next_input(cfg, logits, card, gen), cache, T + i)
    image = sampled_image(cache, f"{cfg.arch_id}-cache",
                          f"capture_pytree({cfg.arch_id} serving cache, {T + steps} tokens)",
                          ZOO_CAPTURE_BYTES)
    layer0 = cache["periods"]["slot0"]
    ks, vs = layer0["k"][0], layer0["v"][0]                       # (B, T + 3, Kv, hd)
    del cache, logits
    spec = model.kv_cache_spec(T + steps)
    sample = torch.cat([ks[0, :32].reshape(-1), vs[0, :32].reshape(-1)])
    table = fit_fr_bases(bf16_to_words(sample), spec.fr)
    qs = torch.randn(steps, B, 1, H, hd, generator=gen, device=card)
    sess = KVSession(spec, B, table, device=card)
    mods = ("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")

    def count(fn):
        before = launch_counts(*mods)
        out = fn()
        for k, n in launch_counts(*mods).items():
            counted[k] += n - before[k]
        return out

    count(lambda: sess.prefill(ks[:, :T], vs[:, :T]))
    geom = dict(n_kv=Kv, hd=hd, groups=G)
    errs = {"out": 0.0, "m": 0.0, "l": 0.0, "sdpa": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i in range(steps):
        pos = T + i
        out = count(lambda: sess.step(qs[i], ks[:, pos:pos + 1], vs[:, pos:pos + 1]))
        c = sess.cache
        qg = qs[i].reshape(B, Kv, G, hd).contiguous()
        got = pa_mod.paged_attention_decode(qg, c["k_pages"], c["v_pages"], c["table"], pos,
                                            spec.fr, **geom)
        want = pa_mod.paged_attention_decode_plain(qg, c["k_pages"], c["v_pages"], c["table"],
                                                   pos, spec.fr, **geom)
        for k, v in attn_errors(*got, *want).items():
            errs[k] = max(errs[k], v)
        if any(errs[k] > ATTN_TOL[k] for k in ATTN_TOL):
            raise AssertionError(f"[13e] {cfg.arch_id} step {i}: kernel C vs plain {errs}")
        ref = sdpa(qs[i].reshape(B, H, 1, hd).to(torch.bfloat16),
                   ks[:, :pos + 1].permute(0, 2, 1, 3), vs[:, :pos + 1].permute(0, 2, 1, 3),
                   enable_gqa=True).reshape(B, 1, H * hd)
        errs["sdpa"] = max(errs["sdpa"], float((out.float() - ref.float()).abs().max()))
        torch.testing.assert_close(out.float(), ref.float(), rtol=1.6e-2, atol=1e-2)
    # times at the last position, over its full pages (CUDA events, median of 10)
    pos, pt = T + steps - 1, spec.page_tokens
    n_valid = pos // pt
    S = n_valid * pt
    qg = qs[-1].reshape(B, Kv, G, hd).contiguous()
    c = sess.cache

    def median_ms(fn):
        fn()
        ts = []
        for _ in range(TIMING_REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return sorted(ts)[len(ts) // 2]

    c_ms = median_ms(lambda: pa_mod.paged_attention_decode(qg, c["k_pages"], c["v_pages"],
                                                           c["table"], pos, spec.fr, **geom))
    Kr = ks[:, :S].permute(0, 2, 1, 3).contiguous()
    Vr = vs[:, :S].permute(0, 2, 1, 3).contiguous()
    qh = qs[-1].reshape(B, H, 1, hd).to(torch.bfloat16)
    sdpa_ms = median_ms(lambda: sdpa(qh, Kr, Vr, enable_gqa=True))
    fr = spec.fr
    page_bytes = 4 * (fr.ptr_lanes + fr.delta_lanes + 2 * fr.outlier_cap + 1)
    pa_bytes = 2 * B * n_valid * spec.pages_per_row * page_bytes + qg.numel() * 4 \
        + B * H * (hd + 2) * 4
    ops_ms = (4.0 * B * H * S * hd / F32_OPS_S
              + 4.0 * 2 * B * n_valid * spec.pages_per_row * fr.page_words / INT_OPS_S) * 1e3
    bytes_ms = pa_bytes / eval_run.peak_bytes_s(torch.cuda.get_device_name(card)) * 1e3
    attn = {k: obs.snapshot(spans=False)["counters"][f"launches.{k}"] - n
            for k, n in attn0.items()}
    if attn["attn_multipage"] != (attn["attn"] if spec.pages_per_row > 1 else 0):
        raise AssertionError(f"[13e] {cfg.arch_id}: {attn['attn_multipage']} multipage launches "
                             f"of {attn['attn']}, {spec.pages_per_row} page slots a row")
    row = {"arch": cfg.arch_id, "Kv": Kv, "G": G, "hd": hd, "page_tokens": pt,
           "pages_per_row": spec.pages_per_row,
           "slots_a_pass": pa_mod.pass_slots(fr, **geom), "ms": c_ms, "sdpa_ms": sdpa_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **errs}
    log(f"[13e] {cfg.arch_id}: kernel C at B={B} Kv={Kv} G={G} hd={hd} ({pt} tokens a page, "
        f"{spec.pages_per_row} page slot(s) a row, {row['slots_a_pass']} slots a pass, "
        f"{n_valid} full pages, {attn['attn_multipage']} of {attn['attn']} launches "
        f"multipage): {c_ms:.4f} ms, SDPA over "
        f"the same {S} tokens raw {sdpa_ms:.4f} ms (C {c_ms / sdpa_ms:.2f}x; medians of "
        f"{TIMING_REPEATS}); bound {row['bound_ms']:.4f} ms by {row['bound_by']}; vs plain max "
        f"|acc/l| {errs['out']:.3g}, m {errs['m']:.3g}, l {errs['l']:.3g}; step vs SDPA "
        f"{errs['sdpa']:.3g} ({card_tag(card)})")
    del sess, ks, vs, Kr, Vr
    return row, image


def sampled_image(tree, name: str, source: str, n_bytes: int):
    """``capture_pytree(tree)`` sampled to at most ``n_bytes`` (whole pages,
    the ingest CLI's seeded sample) as one-segment image ``name``."""
    import numpy as np

    from repro_torch.eval import ingest

    full = ingest.capture_pytree(tree, name)
    words = ingest.sample_stream(full, min(n_bytes, full.n_bytes), 0)
    return ingest.DumpImage(
        name=name, segments=[ingest.Segment(name="sample", data=words.view(np.uint8),
                                            note=f"pages of {len(full.segments)} leaves")],
        word_bits=full.word_bits, source=source,
        meta={**full.meta, "sampled_from": full.n_bytes})


def image_family(image):
    """``image`` as a ``dump:<name>`` family, as ``ingest.dump_workload``
    registers a saved container (here without the container's round trip
    through compressed ``.npz``, which phase 9 exercises)."""
    from repro_torch.eval import ingest
    from repro_torch.eval.registry import Workload

    return Workload(name=ingest.DUMP_PREFIX + image.name, kind=ingest.DUMP_KIND,
                    generate=lambda n, seed: ingest.sample_stream(image, n, seed),
                    word_bits=image.word_bits,
                    description=f"real dump (pytree, {image.n_bytes} B) from {image.source}")


def model_zoo(card) -> dict:
    """Phase 13: each config of :data:`ZOO` in turn, freed before the next:
    (a) :func:`zoo_parity`; (b) at its published width and the depth in
    :data:`ZOO`, :func:`zoo_train`; (c) :func:`zoo_serve`; (e) for
    :data:`ZOO_ATTN`, :func:`zoo_attention`, and zamba2's ``KVSpec``
    refused; the trained parameters and the serving cache (for
    :data:`ZOO_ATTN`, the 2,048-token prompt's) captured and sampled to
    :data:`ZOO_CAPTURE_BYTES`.  Then (d): the captures as ``dump:<name>``
    families, ``evaluate(suite="dump")`` over gbdi, bdi and fr at
    :data:`ZOO_SUITE_BYTES`, every cell verified, and each family held to
    the CPU at ``CHECK_BYTES``.  Returns the launches of the counted path
    (the sessions' prefill and steps, the dump suite) and kernel C's rows."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import default_codecs
    from repro_torch.eval.registry import WorkloadRegistry
    from repro_torch.models.api import build_model

    counted = {"gbdi_encode": 0, "gbdi_decode": 0, "gbdi_paged_attn": 0}
    images, attn_rows = [], []
    for arch, layers in ZOO.items():
        t_arch = time.perf_counter()
        zoo_parity(card, arch)
        cfg = dc.replace(get_config(arch), n_layers=layers)
        model = build_model(cfg, card)
        model.init(torch.Generator(device=card).manual_seed(SEED))
        n_params = sum(p.numel() for p in model.parameters())
        seq = ZOO_SEQ.get(arch, 32)
        tr = zoo_train(card, model, zoo_batch(cfg, ZOO_BATCH, seq, card))
        log(f"[13b] {arch} at full width (d_model {cfg.d_model}, {cfg.n_heads} heads, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), {layers} of "
            f"{get_config(arch).n_layers} layers, {n_params} parameters: batch {ZOO_BATCH} x "
            f"{seq}{' + 256 patches' if cfg.family == 'vlm' else ''}; two make_train_step "
            f"steps (loss, backward, in-place AdamW): {tr['ms'][0]:.1f} / {tr['ms'][1]:.1f} ms, "
            f"loss {tr['loss'][0]:.4f} / {tr['loss'][1]:.4f}, grad norm "
            f"{tr['grad_norm'][0]:.4f} / {tr['grad_norm'][1]:.4f}; peak memory {tr['peak']} B "
            f"(host clock, synchronised; {card_tag(card)})")
        images.append(sampled_image(model.params(), f"{arch}-params",
                                    f"capture_pytree({arch}, {layers} layers, trained 2 steps)",
                                    ZOO_CAPTURE_BYTES))
        cache, _ = zoo_serve(card, model)
        if arch in ZOO_ATTN:
            del cache
            torch.cuda.empty_cache()
            row, image = zoo_attention(card, model, counted)
            attn_rows.append(row)
        else:
            image = sampled_image(cache, f"{arch}-cache", f"capture_pytree({arch} serving cache)",
                                  ZOO_CAPTURE_BYTES)
            del cache
        images.append(image)
        if arch == "zamba2-7b":
            try:
                model.kv_cache_spec(ZOO_PROMPT).page_tokens
            except ValueError as e:
                log(f"[13e] {arch}: kv_cache_spec refused, as the reference asserts: {e}")
            else:
                raise AssertionError(f"[13e] {arch}: a {cfg.n_kv_heads * cfg.head_dim_}-word "
                                     "row was accepted")
        del model
        torch.cuda.empty_cache()
        log(f"[13] {arch} in {time.perf_counter() - t_arch:.1f} s ({card_tag(card)})")
    for arch in ZOO_ATTN:
        if arch in ZOO:
            continue
        model = build_model(dc.replace(get_config(arch), n_layers=1), card)
        model.init(torch.Generator(device=card).manual_seed(SEED))
        row, _ = zoo_attention(card, model, counted)
        attn_rows.append(row)
        del model
        torch.cuda.empty_cache()

    reg = WorkloadRegistry([image_family(img) for img in images])
    t0 = time.perf_counter()
    before = launch_counts("gbdi_encode", "gbdi_decode")
    cells = eval_run.evaluate(reg, default_codecs(str(card)), suite="dump", codecs="gbdi,bdi,fr",
                              n_bytes=ZOO_SUITE_BYTES, seed=0, repeats=1)
    for k, n in launch_counts("gbdi_encode", "gbdi_decode").items():
        counted[k] += n - before[k]
    bad = [f"{c.workload}/{c.codec}: {c.error}" for c in cells if not c.verified]
    if bad or len(cells) != 3 * len(images):
        raise AssertionError(f"[13d] {len(cells)} cells, failed: {bad}")
    log(f"[13d] evaluate(suite='dump', codecs='gbdi,bdi,fr') over {len(images)} families at "
        f"{ZOO_SUITE_BYTES} B: {len(cells)} cells verified in {time.perf_counter() - t0:.1f} s "
        f"({card_tag(card)})")
    log(eval_run.format_table(cells))
    for line in eval_run.csv_lines(cells):
        log(line)
    t0 = time.perf_counter()
    hold_to_cpu(list(reg), card, CHECK_BYTES, "13d")
    log(f"[13d] {len(images)} families x 3 codecs held to the CPU in "
        f"{time.perf_counter() - t0:.1f} s ({card_tag(card)})")
    return {"launches": counted, "attn": attn_rows}


#: phase 14 (a): every config at these shapes, and FULL_ARCH at the other two
DRYRUN_SHAPES = ("decode_32k", "long_500k")
DRYRUN_FULL_ARCH_SHAPES = ("train_4k", "prefill_32k")
#: phase 14 (a): the longest wait for the dry-run's process in phase 14
DRYRUN_WAIT_S = 600
#: phase 14 (b): (kind, batch, positions) of the steps held to the card: the
#: phase-10 batch for training, 8 x 128 for prefill, a batch-8 decode step
COUNT_STEPS = (("train", 4, 32), ("prefill", 8, 128), ("decode", 8, 128))
#: phase 14 (b): the largest share (counted bound / measured step) accepted;
#: above it the count claims work the card did not do
SHARE_MAX = 1.05


def dryrun_cells(out_dir: Path) -> list[dict]:
    """Phase 14 (a): the dry-run (fake tensors, on this machine's host) of
    every config at :data:`DRYRUN_SHAPES` and of :data:`FULL_ARCH` at
    :data:`DRYRUN_FULL_ARCH_SHAPES`, both meshes, each (arch, shape) counted
    once; every parameter leaf of every config divides under both meshes;
    the records and the ``roofline_torch`` table are printed."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import production_axis_sizes
    from repro_torch.models.api import build_model

    for multi_pod in (False, True):
        axes = production_axis_sizes(multi_pod)
        for arch, cfg in ARCHS.items():
            params = specs.params_specs(build_model(cfg, "cpu"))
            p_specs = shd.params_specs(params, axes)
            for leaf, spec in zip(tree_leaves(params), shd.spec_leaves(p_specs)):
                if not shd._fits(axes, leaf.shape, spec):
                    raise AssertionError(f"{arch}: {tuple(leaf.shape)} does not divide by {spec}")
    log(f"[14a] every parameter leaf of the {len(ARCHS)} configs divides under both meshes")

    cells = [(arch, shape) for shape in DRYRUN_SHAPES for arch in sorted(ARCHS)]
    cells += [(FULL_ARCH, shape) for shape in DRYRUN_FULL_ARCH_SHAPES]
    counts: dict = {}
    recs = []
    for arch, shape in cells:
        for mesh in ("pod", "multipod"):
            rec = dryrun.run_cell(arch, shape, mesh, out_dir, counts=counts)
            if not rec.get("ok"):
                raise AssertionError(f"dry-run {arch} x {shape} x {mesh}:\n{rec['error']}")
            recs.append(rec)
            if not rec.get("skipped"):
                rf = rec["roofline"]
                log(f"[14a] {arch} x {shape} x {mesh}: counted in {rec['count_seconds']!r} s; "
                    f"{rec['flops_per_chip']:.6g} FLOP, {rec['bytes_per_chip']:.6g} B, "
                    f"{rec['collective_wire_bytes']['total']:.6g} wire B a chip; dominant "
                    f"{rf['dominant']}, useful {rf['useful_flops_ratio']!r}; argument "
                    f"{rec['memory_analysis']['argument_bytes']} B a chip")
    roofline = _load_script("benchmarks/roofline_torch.py")
    for mesh in ("pod", "multipod"):
        log(f"[14a] roofline_torch --mesh {mesh} --markdown:")
        roofline.main(["--dir", str(out_dir), "--mesh", mesh, "--markdown"])
    return recs


def start_dryrun(out_dir: Path) -> tuple[subprocess.Popen, Path]:
    """Phase 14 (a) in a process of its own, started before phase 2: the
    count is host work, so it runs beside the card's phases; stopped at exit
    if the script ends first.  Returns the process and its log's path."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(root / "src"),
                                                        os.environ.get("PYTHONPATH")])))
    log_path = out_dir.parent / "dryrun.log"
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), "--dryrun-cells",
                                 str(out_dir)], stdout=out, stderr=subprocess.STDOUT, env=env)

    def stop() -> None:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc, log_path


def count_on_card(card, event_ms) -> list[dict]:
    """Phase 14 (b): :data:`FULL_ARCH` at full width, :data:`FULL_LAYERS`
    layers: each step of :data:`COUNT_STEPS` counted under ``FakeTensorMode``
    at its shape and live on the card under the same counter (equal, op for
    op), its bound max(FLOPs / peak, bytes / HBM rate) on the H100 data
    sheet, its time (median of :data:`TIMING_REPEATS` warm CUDA-event
    timings) and the share bound / time, held to :data:`SHARE_MAX`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, op_stats, specs
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import make_train_step

    cfg = dataclasses.replace(get_config(FULL_ARCH), n_layers=FULL_LAYERS)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(SEED))
    opt = adamw.init_state(params)
    gen = torch.Generator(device=card).manual_seed(SEED + 1)
    rows = []
    for kind, B, S in COUNT_STEPS:
        sc = ShapeConfig(f"p14_{kind}", S, B, kind)
        _, fake_run = dryrun.cell_step(cfg, sc, 1, card)
        with specs.fake_mode():
            _, fake = op_stats.count(fake_run)
        tokens = torch.randint(0, cfg.vocab_size, (B, S if kind != "decode" else 1),
                               generator=gen, device=card, dtype=torch.int32)
        if kind == "train":
            step = make_train_step(model, adamw.AdamWConfig(), n_micro=1)
            run = lambda: step(params, opt, {"tokens": tokens})  # noqa: E731
        elif kind == "prefill":
            cache = model.init_cache(B, S)
            run = lambda: model.prefill({"tokens": tokens}, cache)  # noqa: E731
        else:
            cache = model.init_cache(B, S)
            run = lambda: model.decode_step({"tokens": tokens}, cache, S - 1)  # noqa: E731
        _, live = op_stats.count(run)
        torch.cuda.synchronize(card)
        if (live.flops, live.hbm_bytes) != (fake.flops, fake.hbm_bytes):
            differ = {op: (list(fake.by_op.get(op, ())), list(live.by_op.get(op, ())))
                      for op in set(fake.by_op) | set(live.by_op)
                      if list(fake.by_op.get(op, ())) != list(live.by_op.get(op, ()))}
            raise AssertionError(f"{kind}: the fake count ({fake.flops} FLOP, {fake.hbm_bytes} "
                                 f"B) is not the live one ({live.flops}, {live.hbm_bytes}); "
                                 f"(fake, live) [calls, flops, bytes] by op: {differ}")
        for _ in range(2):
            run()
        times = sorted(event_ms(run) for _ in range(TIMING_REPEATS))
        ms = times[len(times) // 2]
        flops_ms, bytes_ms = live.flops / PEAK_FLOPS_BF16 * 1e3, live.hbm_bytes / HBM_BW * 1e3
        bound = max(flops_ms, bytes_ms)
        row = {"step": kind, "batch": B, "positions": S, "flops": live.flops,
               "hbm_bytes": live.hbm_bytes, "ops": sum(c for c, _, _ in live.by_op.values()),
               "ms": ms, "min_ms": times[0], "bound_ms": bound,
               "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
               "share": bound / ms}
        rows.append(row)
        log(f"[14b] {FULL_ARCH} ({FULL_LAYERS} layers) {kind} {B} x {S}: fake count = live "
            f"count, {live.flops} FLOP, {live.hbm_bytes} B over {row['ops']} ops; "
            f"{ms:.4f} ms (median of {TIMING_REPEATS}, min {times[0]:.4f}); bound "
            f"{bound:.4f} ms by {row['bound_by']} (FLOP {flops_ms:.4f} ms, bytes "
            f"{bytes_ms:.4f} ms); share {row['share']:.4f}")
        log("[14b]   top ops by bytes: " + json.dumps(op_stats.top_ops(live, 5)))
        if row["share"] > SHARE_MAX:
            raise AssertionError(f"{kind}: share {row['share']:.4f} > {SHARE_MAX}: the count "
                                 f"claims work the card did not do")
    del model, params, opt
    torch.cuda.empty_cache()
    return rows


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dtensor_on_card(card, tmp: Path) -> dict:
    """Phase 14 (c): a world of one under NCCL with a (1, 1) ("data",
    "model") mesh: ``distribute_tree`` of the :data:`FULL_ARCH` tree
    (:data:`FULL_LAYERS` layers) and ``ckpt.load(..., shardings=(mesh,
    specs))`` of a checkpoint of it, each leaf crc32-equal to the tree and to
    a plain load; the placements' wire bytes, 0 at world 1."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch._tree import tree_map
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.models.config import SHAPES

    torch.cuda.set_device(card.index if card.index is not None else 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        axes = {"data": 1, "model": 1}
        cfg = dataclasses.replace(get_config(FULL_ARCH), n_layers=FULL_LAYERS)
        params = build_model(cfg, card).init(torch.Generator(device=card).manual_seed(SEED))
        p_specs = shd.params_specs(params, axes)
        local = lambda tree: tree_map(lambda t: t.to_local(), tree)  # noqa: E731
        want = _crc_tree(params)
        if _crc_tree(local(shd.distribute_tree(params, mesh, p_specs))) != want:
            raise AssertionError("distribute_tree changed a leaf")
        t0 = time.perf_counter()
        stats = ckpt.save(tmp / "p14", 0, params)
        save_s = time.perf_counter() - t0
        _, plain = ckpt.load(tmp / "p14", params, shardings=card)
        t0 = time.perf_counter()
        _, placed = ckpt.load(tmp / "p14", params, shardings=(mesh, p_specs))
        load_s = time.perf_counter() - t0
        got = _crc_tree(local(placed))
        if got != _crc_tree(plain) or got != want:
            raise AssertionError("the DTensor load is not crc32-equal to the plain load")
        wire = dryrun.collective_bytes(params, p_specs, axes, SHAPES["train_4k"], 0, 4)
        log(f"[14c] world 1, mesh (1, 1) ('data', 'model'): {len(want)} leaves placed by "
            f"distribute_tree and by ckpt.load(shardings=(mesh, specs)), crc32-equal to "
            f"the tree and to a plain load; saved in {save_s:.2f} s (ratio {stats['ratio']:.3f}), DTensor load {load_s:.2f} s; wire bytes a step "
            f"at world 1: {wire['total']} (every ring has one member)")
        if wire["total"] != 0:
            raise AssertionError(f"a world of one sends {wire['total']} B")
    finally:
        dist.destroy_process_group()
    return {"leaves": len(want), "save_s": save_s, "load_s": load_s}


def worked_example_on_card(card, enc_mod, dec_mod) -> None:
    """Phase 14 (d): ``format_doc.example_page()`` (128 words, two cap
    profiles, spill and drop) through kernel A and back through kernel B,
    held to ``gbdi_encode_plain`` field by field, to the worked example's
    serialized bytes and to ``gbdi_decode_plain``."""
    import torch

    from repro_torch.core import format_doc

    cfg = format_doc.example_config()
    table = format_doc.example_table().to(card)
    page = torch.from_numpy(format_doc.example_page()[None, :]).to(card)
    blob = enc_mod.gbdi_encode(page, table, cfg)
    bad = blob_diff(blob, enc_mod.gbdi_encode_plain(page, table, cfg))
    if bad:
        raise AssertionError(f"kernel A differs from its plain version on the worked page: {bad}")
    _, ref = format_doc.encode_example()
    page0 = {k: v[0] for k, v in blob.items() if isinstance(v, torch.Tensor)}
    got = format_doc.serialize_page(page0, cfg)
    if got != format_doc.serialize_page(ref, cfg):
        raise AssertionError("kernel A's worked page does not serialize to the worked example")
    words = dec_mod.gbdi_decode(blob, table, cfg)
    if not torch.equal(words, dec_mod.gbdi_decode_plain(blob, table, cfg)):
        raise AssertionError("kernel B differs from its plain version on the worked page")
    log(f"[14d] worked page: kernel A = plain field by field, profile {int(page0['profile'])}, "
        f"n_spilled {int(page0['n_spilled'])}, n_dropped {int(page0['n_dropped'])}, "
        f"{len(got)} serialized bytes = the worked example's (crc32 {zlib.crc32(got)}); "
        f"kernel B = plain")


#: phase 15 (c): pages a codec config encodes, pages its table is fitted on,
#: the batch of kernel C's geometries and the page slots a row holds
GATE_PAGES, GATE_FIT_PAGES, GATE_BATCH, GATE_SLOTS = 256, 16, 2, 24


def analysis_gate(card, logs: dict, smi: str) -> dict:
    """Phase 15: (a) ``python -m repro_torch.analysis`` over this checkout in
    process with the port's baseline (no new finding, no stale entry), the
    count a checker and ``--list-checks``; (b) the shared-memory and occupancy
    report with the card's columns (``smem_cost.on_card`` with phase 1's
    ``-Xptxas -v`` logs), every row held to formula = library bytes and
    model blocks >= runtime blocks; (c) kernels A and B at each codec config
    of the report on seeded pages, bit for bit against their plain versions,
    and kernel C at each attention geometry within ``ATTN_TOL``.  Returns the
    launches of (c)."""
    import torch

    from repro_torch.analysis import smem_cost
    from repro_torch.analysis.cli import main as analysis_main
    from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases
    from repro_torch.kernels import gbdi_decode as dec_mod
    from repro_torch.kernels import gbdi_encode as enc_mod
    from repro_torch.kernels import gbdi_paged_attn as pa_mod

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "analysis.json"
        rc = analysis_main(["--root", str(root), "--json", str(out)])
        report = json.loads(out.read_text())
    if rc != 0 or report["new"] or report["stale_baseline_entries"]:
        raise AssertionError(f"the port's analysis gate exited {rc}: {len(report['new'])} new "
                             f"finding(s), {len(report['stale_baseline_entries'])} stale entries")
    counts = {cid: 0 for cid in report["checks_run"]}
    for f in report["suppressed"]:
        counts[f["check"]] += 1
    log(f"[15a] {report['files_scanned']} files, {len(report['checks_run'])} checks, "
        f"0 new, {len(report['suppressed'])} baselined, 0 stale; findings a checker "
        f"(all baselined): {json.dumps(counts)} in {time.perf_counter() - t0:.1f} s")
    analysis_main(["--list-checks"])

    t0 = time.perf_counter()
    rows = smem_cost.on_card(smem_cost.full_report(), logs)
    log(f"[15b] shared memory and occupancy, model vs card ({smi}):")
    for line in smem_cost.render(rows).splitlines():
        log(f"    {line}")
    for r in rows:
        if r.lib_smem_bytes != r.smem_bytes or r.blocks_by_smem < r.runtime_blocks or not r.ok:
            raise AssertionError(f"{r.kernel} under {r.config}: {r.problems}")
    log(f"[15b] {len(rows)} rows ok: library bytes = formula, model blocks >= runtime blocks; "
        f"json {json.dumps([r.to_json() for r in rows])} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gen = torch.Generator(device=card).manual_seed(SEED + 15)
    reset_launches("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")
    for label, cfg in smem_cost.codec_configs():
        n = GATE_PAGES * cfg.page_words
        x = torch.randn(n, generator=gen, device=card) * (1e-3 if label == "GRAD_FR" else 1.0)
        words = (bf16_to_words(x) if cfg.word_bits == 16 else x.view(torch.int32))
        pages = words.reshape(GATE_PAGES, cfg.page_words).contiguous()
        table = fit_fr_bases(pages[:GATE_FIT_PAGES], cfg)
        blob = enc_mod.gbdi_encode(pages, table, cfg)
        bad = blob_diff(blob, enc_mod.gbdi_encode_plain(pages, table, cfg))
        got = dec_mod.gbdi_decode(blob, table, cfg)
        same = torch.equal(got, dec_mod.gbdi_decode_plain(blob, table, cfg))
        if bad or not same:
            raise AssertionError(f"{label}: kernel A differs from plain in {bad}, "
                                 f"kernel B = plain: {same}")
        log(f"[15c] {label}: {GATE_PAGES} pages, kernel A = plain field by field, kernel B = "
            f"plain (dropped {int(blob['n_dropped'].sum())}, spilled "
            f"{int(blob['n_spilled'].sum())})")
    for label, cfg, n_kv, hd, groups in smem_cost.attn_geometries():
        geom = dict(n_kv=n_kv, hd=hd, groups=groups)
        n_tok = GATE_SLOTS * pa_mod.page_tokens(cfg, n_kv, hd)
        ch = torch.randn(1, 1, n_kv, hd, generator=gen, device=card) * 2
        ks, vs = ((ch + 0.1 * torch.randn(GATE_BATCH, n_tok, n_kv, hd, generator=gen,
                                          device=card)).to(torch.bfloat16) for _ in "kv")
        table = fit_fr_bases(bf16_to_words(torch.cat([ks[0].reshape(-1), vs[0].reshape(-1)])),
                             cfg)
        pk, pv = ({k: v.reshape((GATE_BATCH, -1) + v.shape[1:]) for k, v in
                   enc_mod.gbdi_encode(bf16_to_words(t).reshape(-1, cfg.page_words).contiguous(),
                                       table, cfg).items() if k not in ("n_spilled", "n_dropped")}
                  for t in (ks, vs))
        q = torch.randn(GATE_BATCH, n_kv, groups, hd, generator=gen, device=card)
        acc, m, l = pa_mod.paged_attention_decode(q, pk, pv, table, n_tok - 1, cfg, **geom)
        err = attn_errors(acc, m, l, *pa_mod.paged_attention_decode_plain(
            q, pk, pv, table, n_tok - 1, cfg, **geom))
        if any(err[k] > ATTN_TOL[k] for k in err):
            raise AssertionError(f"{label}: kernel C vs plain {err} beyond {ATTN_TOL}")
        log(f"[15c] {label} (Kv {n_kv}, hd {hd}, G {groups}): B={GATE_BATCH}, {GATE_SLOTS} "
            f"page slots, pos {n_tok - 1}, {pa_mod.pass_slots(cfg, **geom)} slots a pass: "
            f"kernel C vs plain {err} (tolerances {ATTN_TOL})")
    launches = launch_counts("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")
    log(f"[15c] launches {launches} in {time.perf_counter() - t0:.1f} s ({smi})")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was never launched in phase 15 (c)")
    return launches


def _loss_backward(model, batch) -> float:
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)[0]
    loss.backward()
    return float(loss.detach())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if sys.argv[1:2] == ["--dryrun-cells"]:
        dryrun_cells(Path(sys.argv[2]))
        return 0
    import numpy as np

    from repro_torch import interop, obs
    from repro_torch.core.format_doc import serialize_page
    from repro_torch.core.gbdi_fr import FRConfig, bf16_to_words, fit_fr_bases
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import FRCodec, default_codecs, default_config
    from repro_torch.eval.workloads import default_workloads
    from repro_torch.kernels import _build
    from repro_torch.kernels import gbdi_decode as dec_mod
    from repro_torch.kernels import gbdi_encode as enc_mod
    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import KVSession

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def sync() -> None:
        torch.cuda.synchronize(dev)

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    # -- phase 1: the card and the build -----------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] device {name!r} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    logs = _build.compile_kernels()
    log(f"[1] built {list(logs)} in {time.perf_counter() - t0:.2f} s")
    for kname, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"    {kname}: {line.strip()}")
    peak = eval_run.peak_bytes_s(name)
    dry_tmp = tempfile.TemporaryDirectory()
    atexit.register(dry_tmp.cleanup)
    dry_dir = Path(dry_tmp.name) / "dryrun"
    dry_dir.mkdir()
    dry_proc, dry_log = start_dryrun(dry_dir)
    log(f"[1] phase 14 (a), the dry-run, started in process {dry_proc.pid}")

    # -- phase 2: kernel vs plain, bit for bit -------------------------------
    err = {"gbdi_encode": 0, "gbdi_decode": 0}
    plain_ms: dict[tuple[str, str], float] = {}

    def max_err(a, b) -> int:
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    def compare(label: str, pages, table, cfg) -> None:
        n = pages.shape[0]
        enc_ms = dec_ms = 0.0
        stats = {"n_spilled": 0, "n_dropped": 0}
        for i in range(0, n, CHUNK_PAGES):
            xs = pages[i:i + CHUNK_PAGES]
            box = {}
            enc_ms += event_ms(lambda: box.setdefault("p", enc_mod.gbdi_encode_plain(xs, table, cfg)))
            pb, kb = box["p"], enc_mod.gbdi_encode(xs, table, cfg)
            sync()
            if set(pb) != set(kb):
                raise AssertionError(f"{label}: blob keys {sorted(kb)} != {sorted(pb)}")
            e = max(max_err(kb[k], pb[k]) for k in pb)
            err["gbdi_encode"] = max(err["gbdi_encode"], e)
            dec_ms += event_ms(lambda: box.setdefault("d", dec_mod.gbdi_decode_plain(pb, table, cfg)))
            d = max_err(dec_mod.gbdi_decode(kb, table, cfg), box["d"])
            sync()
            err["gbdi_decode"] = max(err["gbdi_decode"], d)
            if e or d:
                raise AssertionError(f"{label}: pages {i}..{i + xs.shape[0]}: kernel differs "
                                     f"from plain (encode err {e}, decode err {d})")
            for k in stats:
                stats[k] += int(pb[k].sum())
        plain_ms[("gbdi_encode", label)] = enc_ms
        plain_ms[("gbdi_decode", label)] = dec_ms
        log(f"[2] {label}: {n} pages bit-identical (encode+decode); spilled={stats['n_spilled']} "
            f"dropped={stats['n_dropped']}; plain encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms")

    reg = default_workloads()
    streams = {}
    for wname in ("ml_kvcache_bf16", "605.mcf_s"):
        t0 = time.perf_counter()
        wl = reg.get(wname)
        data = wl.generate(STREAM_BYTES, 0)
        codec = FRCodec(word_bits=wl.word_bits)
        cfg = default_config(wl.word_bits)
        words = codec.stream(data)
        pages = torch.nn.functional.pad(words, (0, (-words.numel()) % cfg.page_words))
        pages = pages.reshape(-1, cfg.page_words).contiguous()
        table = fit_fr_bases(pages, cfg)
        sync()
        log(f"[2] {wname}: {data.nbytes} B -> {pages.shape[0]} pages of {cfg.page_words} "
            f"words ({time.perf_counter() - t0:.1f} s to generate, upload, fit)")
        streams[wname] = (wl, data, cfg, pages, table)
        compare(wname, pages, table, cfg)

    adaptive = FRConfig(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
                        cap_profiles=((64, 192), (192, 64), (8, 8)), outlier_cap=16)
    rng = np.random.default_rng(adaptive.page_words + adaptive.num_bases)
    centers = rng.integers(0, 0xFFFF, adaptive.num_bases)
    w = centers[rng.integers(0, 6, (1024, 256))] + rng.integers(-120, 120, (1024, 256))
    w[:, ::7] = 0
    x = torch.as_tensor((w & 0xFFFF).astype(np.int32), device=dev)
    compare("adaptive-3-profiles", x, fit_fr_bases(x, adaptive), adaptive)

    spill = FRConfig(word_bits=16, page_words=256, num_bases=3, width_set=(4, 8),
                     bucket_caps=(32, 224), outlier_cap=8)
    rng = np.random.default_rng(11)
    w = 1000 + rng.integers(-7, 8, (1024, 256))
    w[:, ::9] = 20000 + rng.integers(-100, 100, (1024, 29))
    w[512:, ::2] = rng.integers(30000, 65536, (512, 128))
    x = torch.as_tensor((w & 0xFFFF).astype(np.int32), device=dev)
    spill_table = interop.table_from_numpy([1000, 1000, 20000], [4, 8, 8], device=dev)
    pb = enc_mod.gbdi_encode_plain(x, spill_table, spill)
    if not (int(pb["n_spilled"].sum()) > 0 and int(pb["n_dropped"].sum()) > 0):
        raise AssertionError("the forced spill/drop set spilled or dropped nothing")
    compare("forced-spill-drop", x, spill_table, spill)

    # 30 bases in 4 clusters (several bases of a class fit one word: first
    # index wins), a third of them of a width outside the set (dead),
    # clusters at both ends of the word range (wrapping deltas), caps below
    # the page (spills and drops)
    for bits, widths in ((32, (8, 16)), (16, (4, 8))):
        tcfg = FRConfig(word_bits=bits, page_words=2048, num_bases=30, width_set=widths,
                        bucket_caps=(256, 1536), outlier_cap=64)
        rng = np.random.default_rng(bits)
        span = 1 << bits
        centers = np.array([span // 2 - 40, span // 2 + 20, span // 3, span - 60], np.int64)
        tb = centers[rng.integers(0, 4, 30)] + rng.integers(-6, 7, 30)
        tb[:4] = centers
        tw = rng.choice([widths[0], widths[1], 2], 30)
        tw[:4] = widths[0]
        w = centers[rng.integers(0, 4, (4096, 2048))]
        w += np.where(rng.random((4096, 2048)) < 0.6, rng.integers(-5, 6, (4096, 2048)),
                      rng.integers(-100, 101, (4096, 2048)))
        w[:, ::11] = 0
        w[:, 3::29] = rng.integers(0, span, w[:, 3::29].shape)
        to32 = lambda v: torch.as_tensor((v % span).astype(np.uint32).view(np.int32), device=dev)  # noqa: E731
        x = to32(w)
        ttable = interop.table_from_numpy(to32(tb).cpu().numpy(), tw.astype(np.int32), device=dev)
        pb = enc_mod.gbdi_encode_plain(x[:64], ttable, tcfg)
        if not (int(pb["n_spilled"].sum()) > 0 and int(pb["n_dropped"].sum()) > 0):
            raise AssertionError("the tie/dead-entry set spilled or dropped nothing")
        compare(f"ties-dead-wrap-{bits}bit", x, ttable, tcfg)

    golden = FRConfig(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
                      bucket_caps=(64, 192), outlier_cap=16)
    gbases = np.array([1000, 5000, 9000, 20000, 40000, 60000], np.int32)
    rng = np.random.default_rng(42)
    w = gbases.astype(np.int64)[rng.integers(0, 6, (3, 256))] + rng.integers(-120, 120, (3, 256))
    w[:, ::7] = 0
    x = torch.as_tensor((w & 0xFFFF).astype(np.int32), device=dev)
    gtable = interop.table_from_numpy(gbases, [4, 8, 4, 8, 4, 8], device=dev)
    kb = enc_mod.gbdi_encode(x, gtable, golden)
    crcs = [zlib.crc32(serialize_page({k: v[i] for k, v in kb.items()}, golden)) for i in range(3)]
    if crcs != GOLDEN_CRCS:
        raise AssertionError(f"golden CRCs {crcs} != {GOLDEN_CRCS}")
    compare("golden-crc", x, gtable, golden)
    log(f"[2] golden CRCs matched: {crcs}")

    # blobs the encoder never writes, per word width: random ptr and delta
    # lanes (codes past the outlier code, class counts past their caps),
    # full-int32 outlier values, outlier indices that rise, repeat, fall or
    # lie off the page, n_out past both ends, profile ids outside the table;
    # the decode kernel against its plain version, bit for bit
    hand16 = FRConfig(word_bits=16, page_words=2048, num_bases=14, width_set=(4, 8),
                      cap_profiles=((192, 1856), (64, 1024), (8, 8)), outlier_cap=64)
    for hcfg in (hand16, default_config(32)):
        blob, hbases, hwidths = handmade_blobs(hcfg, 4096, hcfg.word_bits)
        blob = interop.blob_from_numpy(blob, device=dev)
        htable = interop.table_from_numpy(hbases, hwidths, device=dev)
        box = {}
        pms = event_ms(lambda: box.setdefault("p", dec_mod.gbdi_decode_plain(blob, htable, hcfg)))
        d = max_err(dec_mod.gbdi_decode(blob, htable, hcfg), box["p"])
        sync()
        err["gbdi_decode"] = max(err["gbdi_decode"], d)
        if d:
            raise AssertionError(f"hand-built {hcfg.word_bits}-bit blobs: the decode kernel differs "
                                 f"from plain (err {d})")
        log(f"[2] hand-built {hcfg.word_bits}-bit blobs ({hcfg.num_profiles} profile(s)): "
            f"4096 pages decoded bit-identical to plain; plain decode {pms:.3f} ms")

    # GRAD_FR, the gradient ring's config: 16-bit words, one 8-bit class, one
    # 2,048-word bucket (num_classes == 1); gradient-like bf16 words on a table
    # fitted to them, then pages whose every word is an outlier past the cap
    # of 64 on a table far from them (words dropped)
    from repro_torch.distributed.collectives import GRAD_FR
    rng = np.random.default_rng(21)
    g = rng.normal(0, 1, (4096, 2048)) * 10.0 ** rng.uniform(-6, -1, (4096, 1))
    g[:, ::5] = 0
    gw = bf16_to_words(torch.as_tensor(g.astype(np.float32), device=dev)).contiguous()
    compare("grad-fr-gradients", gw, fit_fr_bases(gw, GRAD_FR), GRAD_FR)
    far = interop.table_from_numpy(np.arange(1, 15, dtype=np.int32) * 200, [8] * 14, device=dev)
    w = rng.integers(20000, 65536, (512, 2048))
    w[256:, ::3] = 200 + rng.integers(-100, 100, (256, 683))      # a third fit, the rest drop
    ow = torch.as_tensor(w.astype(np.int32), device=dev)
    pb = enc_mod.gbdi_encode_plain(ow, far, GRAD_FR)
    if not (int(pb["n_dropped"][:256].min()) == 2048 - GRAD_FR.outlier_cap
            and int(pb["n_out"][:256].min()) == GRAD_FR.outlier_cap):
        raise AssertionError("the all-outlier GRAD_FR pages did not fill the outlier table")
    compare("grad-fr-all-outliers", ow, far, GRAD_FR)

    # -- phase 3: the main path, counted -------------------------------------
    reset_launches("gbdi_encode", "gbdi_decode")
    cells = []
    for wname, (wl, data, cfg, _pages, _table) in streams.items():
        cell = eval_run.evaluate_cell(wl, FRCodec(word_bits=wl.word_bits), data, repeats=3)
        if not cell.verified:
            raise AssertionError(f"{wname}: {cell.error}")
        if not 0 < cell.compression_ratio < 64:
            raise AssertionError(f"{wname}: implausible compression ratio {cell.compression_ratio}")
        cells.append(cell)
        log(f"[3] {wname}: CR {cell.compression_ratio!r} bits/word {cell.bits_per_word!r} "
            f"mismatched {cell.mismatched_words} <= dropped {cell.dropped_words}; "
            f"fit {cell.fit_s:.3f} s, encode {cell.encode_s * 1e3:.3f} ms, "
            f"decode {cell.decode_s * 1e3:.3f} ms ({cell.device}, {cell.power_limit})")
    launches = launch_counts("gbdi_encode", "gbdi_decode")
    log(f"[3] main-path launches: {launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was never launched on the main path")

    # -- phase 4: time, bound, plain time -------------------------------------
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0, "ops": 0.0}
            for k in launches}
    for wname, (_wl, data, cfg, pages, table) in streams.items():
        blob = enc_mod.gbdi_encode(pages, table, cfg)
        sync()
        n_bytes = pages.numel() * 4 + sum(v.numel() * 4 for v in blob.values())
        bytes_ms = n_bytes / peak * 1e3
        ops = {"gbdi_encode": 2.0 * pages.numel() * cfg.num_bases,   # delta + fit test per base
               "gbdi_decode": 4.0 * pages.numel()}                  # unpack, field, add, select
        for kname, fn in (("gbdi_encode", lambda: enc_mod.gbdi_encode(pages, table, cfg)),
                          ("gbdi_decode", lambda: dec_mod.gbdi_decode(blob, table, cfg))):
            fn()
            times = sorted(event_ms(fn) for _ in range(TIMING_REPEATS))
            ms = times[len(times) // 2]
            ops_ms = ops[kname] / INT_OPS_S * 1e3
            bound = max(bytes_ms, ops_ms)
            row = rows[kname]
            row["ms"] += ms
            row["plain_ms"] += plain_ms[(kname, wname)]
            row["bound_ms"] += bound
            row["bytes"] += n_bytes
            row["ops"] += ops[kname]
            log(f"[4] {kname} {wname}: {ms:.4f} ms (median of {TIMING_REPEATS}, min "
                f"{times[0]:.4f}; {data.nbytes / (1 << 30) / (ms / 1e3):.2f} GiB/s of "
                f"the input stream); bound {bound:.4f} ms = {n_bytes} B / {peak:.3g} B/s "
                f"(ops bound {ops_ms:.4f} ms); roofline share {bound / ms:.3f}; plain "
                f"{plain_ms[(kname, wname)]:.3f} ms; library call: none")

    # -- phase 5: paged attention vs plain ------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def kv_cache_data(batch: int, n_tok: int, n_kv: int, hd: int, sparse: bool = False):
        """Channel-structured bf16 K/V as in ml_kvcache_bf16: a per-channel
        mean N(0,1)*2 plus N(0, 0.1) noise, (batch, n_tok, n_kv, hd)."""
        ch = torch.randn(1, 1, n_kv, hd, generator=gen, device=dev) * 2
        x = ch + 0.1 * torch.randn(batch, n_tok, n_kv, hd, generator=gen, device=dev)
        if sparse:   # half the channels of the first half of the tokens are 0
            x[:, :n_tok // 2, :, ::2] = 0
        return x.to(torch.bfloat16)

    def fit_table(ks, vs, cfg):
        sample = torch.cat([ks[0, :32].reshape(-1), vs[0, :32].reshape(-1)])
        return fit_fr_bases(bf16_to_words(sample), cfg)

    def page_slots(x, table, cfg):
        batch = x.shape[0]
        blob = enc_mod.gbdi_encode(bf16_to_words(x).reshape(-1, cfg.page_words).contiguous(),
                                   table, cfg)
        return {k: v.reshape((batch, -1) + v.shape[1:]) for k, v in blob.items()
                if k not in ("n_spilled", "n_dropped")}

    attn_err = {"out": 0.0, "m": 0.0, "l": 0.0}
    pass_decode = {"pages": 0, "mismatched_words": 0}

    def check_pass_decode(label, pk, pv, table, cfg, geom) -> None:
        """The kernel's batched pass decode vs the decode kernel, every slot."""
        batch, n_slots = pk["n_out"].shape
        got = pa_mod.decode_pages(pk, pv, table, n_slots, cfg, **geom)
        bad = 0
        for words, pages in zip(got, (pk, pv)):
            flat = {k: v.reshape((batch * n_slots,) + v.shape[2:]) for k, v in pages.items()}
            want = dec_mod.gbdi_decode(flat, table, cfg).reshape(words.shape)
            bad += int((words != want).sum())
        sync()
        pass_decode["pages"] += 2 * batch * n_slots
        pass_decode["mismatched_words"] += bad
        log(f"[5] {label}: pass decode vs gbdi_decode on {2 * batch * n_slots} pages "
            f"({pa_mod.pass_slots(cfg, **geom)} slots a pass): {bad} words differ")
        if bad:
            raise AssertionError(f"{label}: the pass decode differs from gbdi_decode in {bad} words")

    def check_attn(label, q, pk, pv, table, pos, cfg, n_kv, hd, groups):
        geom = dict(n_kv=n_kv, hd=hd, groups=groups)
        check_pass_decode(label, pk, pv, table, cfg, geom)
        sliced0 = sliced_launches()
        acc, m, l = pa_mod.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
        sync()
        pt = pa_mod.page_tokens(cfg, n_kv, hd)
        ts = pa_mod.token_slices(n_kv * groups, hd, pa_mod.pass_slots(cfg, **geom) * pt)
        if sliced_launches() - sliced0 != (ts > 1):
            raise AssertionError(f"{label}: {sliced_launches() - sliced0} sliced launches at "
                                 f"{ts} token slices")
        pms = event_ms(lambda: box.__setitem__("p", pa_mod.paged_attention_decode_plain(
            q, pk, pv, table, pos, cfg, **geom)))
        pacc, pm, pl = box["p"]
        live = pl > 0
        err = attn_errors(acc, m, l, pacc, pm, pl)
        for k, v in err.items():
            attn_err[k] = max(attn_err[k], v)
        if any(err[k] > ATTN_TOL[k] for k in err):
            raise AssertionError(f"{label}: kernel vs plain {err} beyond {ATTN_TOL}")
        n_valid = min(pk["n_out"].shape[1], pos // (cfg.page_words // (n_kv * hd)))
        log(f"[5] {label}: B={q.shape[0]} Kv={n_kv} hd={hd} G={groups} slots="
            f"{pk['n_out'].shape[1]} pos={pos} ({n_valid} valid slots, {int(live.sum())} live "
            f"rows, {ts} token slices): max|acc/l| err {err['out']:.3g}, m rel err "
            f"{err['m']:.3g}, l rel err {err['l']:.3g}; plain {pms:.3f} ms")
        return pms

    box = {}
    kv16 = kvc.KV_FR
    cases = [
        # (label, cfg, batch, tokens, n_kv, hd, groups, pos, sparse)
        ("llama3-405b layer, full size", kv16, SERVE["batch"], SERVE["max_len"], SERVE["n_kv"],
         SERVE["hd"], SERVE["heads"] // SERVE["n_kv"], SERVE["max_len"] - 2, False),
        ("mixtral-8x22b layer", kv16, 2, 4096, 8, 128, 6, 4095, False),
        ("4-token pages", kv16, 4, 8192, 4, 128, 8, 8190, False),
        ("adaptive two-profile", FRConfig(word_bits=16, page_words=2048, num_bases=14,
                                          width_set=(4, 8), cap_profiles=((192, 1856), (64, 1024)),
                                          outlier_cap=64), 2, 4096, 8, 128, 4, 4000, True),
        ("every page masked (pos < pt)", kv16, 2, 4096, 8, 128, 6, 1, False),
        ("hd-512 head, two channel chunks", kv16, 2, 4096, 1, 512, 8, 4095, False),
    ]
    for label, cfg, batch, n_tok, n_kv, hd, groups, pos, sparse in cases:
        ks, vs = kv_cache_data(batch, n_tok, n_kv, hd, sparse), kv_cache_data(batch, n_tok, n_kv, hd, sparse)
        table = fit_table(ks, vs, cfg)
        pk, pv = page_slots(ks, table, cfg), page_slots(vs, table, cfg)
        if cfg.num_profiles > 1:
            ids = torch.cat([pk["profile"], pv["profile"]]).unique().tolist()
            if len(ids) < 2:
                raise AssertionError(f"{label}: every page took profile {ids}")
        q = torch.randn(batch, n_kv, groups, hd, generator=gen, device=dev)
        check_attn(label, q, pk, pv, table, pos, cfg, n_kv, hd, groups)
        del ks, vs, pk, pv
        torch.cuda.empty_cache()
    log(f"[5] pass decode: {pass_decode['pages']} pages compared, "
        f"{pass_decode['mismatched_words']} words differ; kernel C vs plain, largest errors "
        f"{attn_err} (tolerances {ATTN_TOL})")

    # -- phase 6: the serving path, counted ------------------------------------
    B, n_kv, hd, H = SERVE["batch"], SERVE["n_kv"], SERVE["hd"], SERVE["heads"]
    T, steps = SERVE["prefill"], SERVE["steps"]
    ks, vs = (kv_cache_data(B, SERVE["max_len"], n_kv, hd) for _ in "kv")
    table = fit_table(ks, vs, kv16)
    qs = torch.randn(steps, B, 1, H, hd, generator=gen, device=dev)
    spec = kvc.KVSpec(n_kv=n_kv, head_dim=hd, max_len=SERVE["max_len"])
    res_spec = kvc.KVSpec(n_kv=n_kv, head_dim=hd, max_len=SERVE["max_len"], resident_decode=True)
    log(f"[6] bytes per layer at batch {B}: compressed {spec.compressed_bytes(B)} B "
        f"({kv16.compressed_bytes_per_page()} B per page, {spec.n_pages} pages per sequence, "
        f"K and V), raw {spec.raw_bytes(B)} B, resident spec {res_spec.compressed_bytes(B)} B")
    reset_launches("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")
    obs.reset("launches.attn_tail")
    sessions, outs, step_ms, attn_launches = {}, {}, {}, {}
    for label, sp in (("paged", spec), ("resident", res_spec)):
        attn0 = (launch_counts("gbdi_paged_attn")["gbdi_paged_attn"], tail_launches())
        sync()
        t0 = time.perf_counter()
        sess = KVSession(sp, B, table)
        sess.prefill(ks[:, :T], vs[:, :T])
        sync()
        fill_s = time.perf_counter() - t0
        outs[label], step_ms[label] = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            out = sess.step(qs[i], ks[:, T + i:T + i + 1], vs[:, T + i:T + i + 1])
            sync()
            step_ms[label].append((time.perf_counter() - t0) * 1e3)
            outs[label].append(out)
        sessions[label] = sess
        attn_launches[label] = (launch_counts("gbdi_paged_attn")["gbdi_paged_attn"] - attn0[0],
                                tail_launches() - attn0[1])
        log(f"[6] {label}: init + prefill of {T} tokens {fill_s:.3f} s; {steps} steps at "
            f"positions {T}..{T + steps - 1}: " + ", ".join(f"{t:.3f}" for t in step_ms[label])
            + " ms (host clock, synchronised)")
    serve_launches = launch_counts("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")
    log(f"[6] serving-path launches: {serve_launches}; kernel C's (launches, of those in the "
        f"tail form) by session: {attn_launches}")
    if attn_launches["paged"][1] != attn_launches["paged"][0]:
        raise AssertionError(f"[6] the paged session's attention left the tail form: "
                             f"{attn_launches['paged']} (C launches, tail-form launches)")
    for kname, count in serve_launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was never launched on the serving path")
    for i, (a, b) in enumerate(zip(outs["paged"], outs["resident"])):
        if not (a.shape == (B, 1, H * hd) and a.dtype == torch.bfloat16 and a.isfinite().all()):
            raise AssertionError(f"step {i}: output {a.dtype} {tuple(a.shape)} or not finite")
        diff = float((a.float() - b.float()).abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2, atol=1e-2)
        log(f"[6] step {i}: paged vs resident output max abs diff {diff:.4g} "
            "(bf16 tolerance: rtol 1.6e-2, atol 1e-2)")
    pos = T + steps - 1
    K, V, valid = kvc.read_full(res_spec, sessions["resident"].cache, pos)
    for side, got, raw in (("K", K, ks), ("V", V, vs)):
        n = pos + 1
        frac = float((got[:, :n].view(torch.int16) == raw[:, :n].view(torch.int16)).float().mean())
        log(f"[6] read_full {side}: {frac:.6f} of {B * n * n_kv * hd} words equal the raw cache")
        if not frac > 0.98:
            raise AssertionError(f"read_full {side} matches the raw cache on only {frac}")
    del K, V, valid, outs
    sessions.pop("resident")
    torch.cuda.empty_cache()

    # -- phase 7: times ---------------------------------------------------------
    def median_ms(fn, n=TIMING_REPEATS):
        fn()
        times = sorted(event_ms(fn) for _ in range(n))
        return times[len(times) // 2], times[0]

    cache = sessions["paged"].cache
    G = H // n_kv
    qg = qs[-1].reshape(B, n_kv, G, hd).contiguous()
    geom = dict(n_kv=n_kv, hd=hd, groups=G)
    pt = spec.page_tokens
    n_valid = pos // pt
    S = n_valid * pt
    sliced0 = sliced_launches()
    pa_ms, pa_min = median_ms(lambda: pa_mod.paged_attention_decode(
        qg, cache["k_pages"], cache["v_pages"], cache["table"], pos, kv16, **geom))
    serve_ts = pa_mod.token_slices(n_kv * G, hd, pa_mod.pass_slots(kv16, **geom) * pt)
    if serve_ts != 1 or sliced_launches() != sliced0:
        raise AssertionError(f"[7] the serving shape ran in {serve_ts} token slices "
                             f"({sliced_launches() - sliced0} sliced launches)")
    pa_plain_ms = event_ms(lambda: pa_mod.paged_attention_decode_plain(
        qg, cache["k_pages"], cache["v_pages"], cache["table"], pos, kv16, **geom))
    page_bytes = 4 * (kv16.ptr_lanes + kv16.delta_lanes + 2 * kv16.outlier_cap + 1)
    pa_bytes = 2 * B * n_valid * page_bytes + qg.numel() * 4 + B * H * (hd + 2) * 4
    f32_ops = 4.0 * B * H * S * hd
    int_ops = 4.0 * 2 * B * n_valid * kv16.page_words      # unpack, field, add, select
    bytes_ms = pa_bytes / peak * 1e3
    ops_ms = (f32_ops / F32_OPS_S + int_ops / INT_OPS_S) * 1e3
    pa_bound = max(bytes_ms, ops_ms)
    pa_bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    Kr = ks[:, :S].permute(0, 2, 1, 3).contiguous()     # raw bf16 cache (B, Kv, S, hd)
    Vr = vs[:, :S].permute(0, 2, 1, 3).contiguous()
    qh = qs[-1].reshape(B, H, 1, hd).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms, lib_min = median_ms(lambda: sdpa(qh, Kr, Vr, enable_gqa=True))
    log(f"[7] gbdi_paged_attn at B={B} Kv={n_kv} G={G} hd={hd}, {n_valid} full pages "
        f"({S} tokens): {pa_ms:.4f} ms (median of {TIMING_REPEATS}, min {pa_min:.4f}); bound "
        f"{pa_bound:.4f} ms by {pa_bound_by} (bytes {bytes_ms:.4f} ms = {pa_bytes} B / "
        f"{peak:.3g} B/s; operations {ops_ms:.4f} ms = {f32_ops:.4g} f32 at {F32_OPS_S:.3g}/s + "
        f"{int_ops:.4g} int at {INT_OPS_S:.3g}/s); roofline share {pa_bound / pa_ms:.3f}; plain "
        f"{pa_plain_ms:.3f} ms; one token slice, no sliced launch")
    log(f"[7] library: scaled_dot_product_attention(enable_gqa=True) over the same {S} tokens "
        f"as a raw bf16 cache ({Kr.numel() * 4} B of K+V): {lib_ms:.4f} ms (median, min "
        f"{lib_min:.4f})")

    def decode_then_sdpa():
        def raw(pages):
            words = kvc._decompress_all(spec, pages, cache["table"])
            return words[:, :S].permute(0, 2, 1, 3).contiguous()
        return sdpa(qh, raw(cache["k_pages"]), raw(cache["v_pages"]), enable_gqa=True)

    dec_sdpa_ms, _ = median_ms(decode_then_sdpa, 5)
    log(f"[7] decode every page slot with gbdi_decode, lay it out as (B, Kv, S, hd), then the "
        f"same SDPA: {dec_sdpa_ms:.4f} ms (median of 5)")
    del sessions, cache, Kr, Vr
    torch.cuda.empty_cache()
    for ctx in (4096, SERVE["max_len"]):
        for backend, resident in (("paged", False), ("resident", True), ("oracle", False)):
            sp = kvc.KVSpec(n_kv=n_kv, head_dim=hd, max_len=ctx, resident_decode=resident)
            sess = KVSession(sp, B, table, backend=backend)
            sess.prefill(ks[:, :ctx - steps - 1], vs[:, :ctx - steps - 1])
            lat = []
            for i in range(steps + 1):
                p0 = sess.pos
                sync()
                t0 = time.perf_counter()
                sess.step(qs[i % steps], ks[:, p0:p0 + 1], vs[:, p0:p0 + 1])
                sync()
                lat.append((time.perf_counter() - t0) * 1e3)
            lat = sorted(lat[1:])
            log(f"[7] step latency (append + attend), {backend}, context {ctx}, batch {B}: "
                f"median {lat[len(lat) // 2]:.3f} ms, min {lat[0]:.3f}, max {lat[-1]:.3f} "
                f"(host clock, synchronised, {steps} steps after one warm-up)")
            del sess
            torch.cuda.empty_cache()
    ring_row = ring_attention(dev, event_ms, peak)
    torch.cuda.empty_cache()
    cell_tail_form(dev, event_ms)
    torch.cuda.empty_cache()
    multipage_row = multipage_attention(dev, event_ms, peak)
    torch.cuda.empty_cache()

    # -- phase 8: the paper's suite on the card ---------------------------------
    t8 = time.perf_counter()
    reset_launches("gbdi_encode", "gbdi_decode")
    paper_suite(dev)
    t0 = time.perf_counter()
    tp_rows = eval_run.throughput(reg, default_codecs(), codecs="gbdi,bdi,fr",
                                  n_bytes=SUITE_BYTES, repeats=5)
    log(eval_run.format_throughput_table(tp_rows))
    log(f"[8] throughput of {len(tp_rows)} rows in {time.perf_counter() - t0:.1f} s")
    suite_launches = launch_counts("gbdi_encode", "gbdi_decode")
    log(f"[8] suite-phase launches: {suite_launches}; phase wall time "
        f"{time.perf_counter() - t8:.1f} s")
    for kname, count in suite_launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was never launched in the suite phase")

    # -- phase 9: real dumps -------------------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    t9 = time.perf_counter()
    full_cfg = dataclasses.replace(get_config(FULL_ARCH), n_layers=FULL_LAYERS)
    model = build_model(full_cfg, dev)
    sync()
    t0 = time.perf_counter()
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    sync()
    log(f"[9] {FULL_ARCH} at full width (d_model {full_cfg.d_model}, {full_cfg.n_heads} heads, "
        f"d_ff {full_cfg.d_ff}, vocab {full_cfg.vocab_size}), depth cut to {FULL_LAYERS} layers: "
        f"{sum(t.numel() for t in model.parameters())} parameters initialised on the card in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({name}, {smi.split(',')[-1].strip()})")
    reset_launches("gbdi_encode", "gbdi_decode")
    with tempfile.TemporaryDirectory() as tmp:
        dump_suite(dev, model, Path(tmp) / "dumps")
    dump_launches = launch_counts("gbdi_encode", "gbdi_decode")
    log(f"[9] dump-phase launches: {dump_launches}; phase wall time "
        f"{time.perf_counter() - t9:.1f} s ({smi})")

    # -- phase 10: the model-backed ML families ------------------------------------
    t10 = time.perf_counter()
    reset_launches("gbdi_encode", "gbdi_decode")
    ml_families(dev, model)
    ml_launches = launch_counts("gbdi_encode", "gbdi_decode")
    log(f"[10] ML-phase launches: {ml_launches}; phase wall time "
        f"{time.perf_counter() - t10:.1f} s ({smi})")
    for kname in launches:
        if dump_launches[kname] <= 0 or ml_launches[kname] <= 0:
            raise AssertionError(f"{kname} was never launched in phase 9 or 10")

    # -- phase 11: serving on the card -------------------------------------------
    t11 = time.perf_counter()
    reset_launches("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")
    serving_parity(dev)
    log(f"[11a] in {time.perf_counter() - t11:.1f} s")
    t0 = time.perf_counter()
    full = serving_full_width(dev, model)
    if (full["raw"]["peak_resident"], full["compressed"]["peak_resident"]) != (6, 7):
        raise AssertionError(f"[11b] peak resident raw {full['raw']['peak_resident']}, "
                             f"compressed {full['compressed']['peak_resident']}; want 6 and 7")
    log(f"[11b] peak resident at one budget: raw {full['raw']['peak_resident']}, compressed "
        f"{full['compressed']['peak_resident']}; in {time.perf_counter() - t0:.1f} s ({smi})")
    t0 = time.perf_counter()
    serving_scripts(dev)
    serving_launches = launch_counts("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")
    log(f"[11c] in {time.perf_counter() - t0:.1f} s; serving-phase launches: "
        f"{serving_launches}; phase wall time {time.perf_counter() - t11:.1f} s ({smi})")
    for kname, count in serving_launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was never launched in phase 11")
    del model
    torch.cuda.empty_cache()

    # -- phase 12: the front-end, the trainer, the gradient ring, the scripts ----
    t12 = time.perf_counter()
    reset_launches("gbdi_encode", "gbdi_decode")
    _wl, _data, kv_cfg, kv_pages, kv_table = streams["ml_kvcache_bf16"]
    t0 = time.perf_counter()
    front_end(dev, kv_cfg, kv_pages, kv_table)
    log(f"[12a] in {time.perf_counter() - t0:.1f} s")
    del streams, kv_pages
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trained = full_width_trainer(dev, Path(tmp))
        ring = ring_on_card(dev, (np.array(trained["fr_bases"], np.int32),
                                  np.array(trained["fr_widths"], np.int32)))
        slice_scripts(dev, Path(tmp))
    front_launches = launch_counts("gbdi_encode", "gbdi_decode")
    ring_launches = {k: sum(o["launches"][k] for o in ring["outs"]) for k in front_launches}
    for kname, e in ring["err"].items():
        err[kname] = max(err[kname], e)
    log(f"[12] phase-12 launches: this process {front_launches}, the ring's ranks "
        f"{[o['launches'] for o in ring['outs']]} (the scripts' subprocesses not counted); "
        f"phase wall time {time.perf_counter() - t12:.1f} s ({smi})")
    for kname in front_launches:
        if front_launches[kname] <= 0 or ring_launches[kname] <= 0:
            raise AssertionError(f"{kname} was never launched in phase 12 (a) or (c)")

    # -- phase 13: the model zoo -----------------------------------------------
    t13 = time.perf_counter()
    zoo = model_zoo(dev)
    zoo_launches = zoo["launches"]
    log(f"[13] phase-13 launches (the sessions' prefill and steps, the dump suite): "
        f"{zoo_launches}; phase wall time {time.perf_counter() - t13:.1f} s ({smi})")
    for kname, count in zoo_launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was never launched in phase 13")
    log("[13] kernel C at the new geometries: " + json.dumps(zoo["attn"]))

    # -- phase 14: the launch tools ----------------------------------------------
    t14 = time.perf_counter()
    t0 = time.perf_counter()
    rc = dry_proc.wait(timeout=DRYRUN_WAIT_S)
    for line in dry_log.read_text().splitlines():
        log(f"    {line}")
    if rc != 0:
        raise AssertionError(f"the phase 14 (a) dry-run exited {rc}")
    from repro_torch.configs import ARCHS

    recs = [json.loads(f.read_text()) for f in sorted(dry_dir.glob("*.json"))]
    if (len(recs) != 2 * (len(DRYRUN_SHAPES) * len(ARCHS) + len(DRYRUN_FULL_ARCH_SHAPES))
            or not all(r.get("ok") for r in recs)):
        raise AssertionError(f"the dry-run wrote {len(recs)} records, not all ok")
    log(f"[14a] {len(recs)} records, {sum(1 for r in recs if r.get('skipped'))} skipped as the "
        f"reference skips them; waited {time.perf_counter() - t0:.1f} s for the process")
    with tempfile.TemporaryDirectory() as tmp:
        shares = count_on_card(dev, event_ms)
        dtensor_on_card(dev, Path(tmp))
    reset_launches("gbdi_encode", "gbdi_decode")
    worked_example_on_card(dev, enc_mod, dec_mod)
    tools_launches = launch_counts("gbdi_encode", "gbdi_decode")
    log(f"[14] phase-14 launches (the worked page): {tools_launches}; shares "
        f"{ {r['step']: round(r['share'], 4) for r in shares} }; phase wall time "
        f"{time.perf_counter() - t14:.1f} s ({smi})")
    for kname, count in tools_launches.items():
        if count <= 0:
            raise AssertionError(f"{kname} was never launched in phase 14")

    # -- phase 15: the analysis gate and the shared-memory model on the card -----
    t15 = time.perf_counter()
    gate_launches = analysis_gate(dev, logs, smi)
    log(f"[15] phase-15 launches: {gate_launches}; phase wall time "
        f"{time.perf_counter() - t15:.1f} s ({smi})")

    replaces = {"gbdi_encode": "src/repro/kernels/gbdi_encode.py:292",
                "gbdi_decode": "src/repro/kernels/gbdi_decode.py:148",
                "gbdi_paged_attn": "src/repro/kernels/gbdi_paged_attn.py:160"}
    kernels = []
    for kname, row in rows.items():
        bound_by = "bytes" if row["bytes"] / peak >= row["ops"] / INT_OPS_S else "operations"
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": replaces[kname],
            "launches": (launches[kname] + serve_launches[kname] + suite_launches[kname]
                         + dump_launches[kname] + ml_launches[kname] + serving_launches[kname]
                         + front_launches[kname] + ring_launches[kname]
                         + zoo_launches[kname] + tools_launches[kname]
                         + gate_launches[kname]),
            "max_abs_err": err[kname], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": bound_by, "library_ms": None,
        })
    kernels.append({
        "name": "gbdi_paged_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbdi_paged_attn.cu",
        "replaces": replaces["gbdi_paged_attn"],
        "launches": (serve_launches["gbdi_paged_attn"] + serving_launches["gbdi_paged_attn"]
                     + zoo_launches["gbdi_paged_attn"] + gate_launches["gbdi_paged_attn"]),
        "max_abs_err": max([attn_err["out"]] + [r["out"] for r in zoo["attn"]]),
        "ms": pa_ms, "plain_ms": pa_plain_ms,
        "bound_ms": pa_bound, "bound_by": pa_bound_by, "library_ms": lib_ms,
    })
    kernels.append({
        "name": "gbdi_paged_attn.ring", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbdi_paged_attn.cu",
        "replaces": replaces["gbdi_paged_attn"], **ring_row,
    })
    kernels.append({
        "name": "gbdi_paged_attn.multipage", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbdi_paged_attn.cu",
        "replaces": replaces["gbdi_paged_attn"], **multipage_row,
    })
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
