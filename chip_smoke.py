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
   words), the golden-CRC pages of the format's serialization, and (decode
   only) blobs the encoder never writes, per word width;
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
   at contexts of 4,096 and 32,768.

It ends with one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
line.  Exit code 2: no CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

STREAM_BYTES = 256 << 20
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
SEED = 12


def log(*args: object) -> None:
    print(*args, flush=True)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch import interop
    from repro_torch.core.format_doc import serialize_page
    from repro_torch.core.gbdi_fr import FRConfig, bf16_to_words, fit_fr_bases
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import FRCodec, default_config
    from repro_torch.eval.workloads import default_workloads
    from repro_torch.kernels import _build
    from repro_torch.kernels import gbdi_decode as dec_mod
    from repro_torch.kernels import gbdi_encode as enc_mod
    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import KVSession

    dev = torch.device("cuda")

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

    # -- phase 3: the main path, counted -------------------------------------
    enc_mod.launch_count = 0
    dec_mod.launch_count = 0
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
    launches = {"gbdi_encode": enc_mod.launch_count, "gbdi_decode": dec_mod.launch_count}
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
        acc, m, l = pa_mod.paged_attention_decode(q, pk, pv, table, pos, cfg, **geom)
        sync()
        pms = event_ms(lambda: box.__setitem__("p", pa_mod.paged_attention_decode_plain(
            q, pk, pv, table, pos, cfg, **geom)))
        pacc, pm, pl = box["p"]
        live = pl > 0
        dead = ~live
        if not ((m[dead] == pa_mod.MASKED).all() and (l[dead] == 0).all()
                and (acc[dead] == 0).all()):
            raise AssertionError(f"{label}: a row with no valid token is not (0, -1e30, 0)")
        err = {"out": float((acc[live] / l[live][:, None] - pacc[live] / pl[live][:, None])
                            .abs().max()) if live.any() else 0.0,
               "m": float(((m - pm).abs() / (1 + pm.abs())).max()),
               "l": float(((l - pl).abs() / pl)[live].max()) if live.any() else 0.0}
        for k, v in err.items():
            attn_err[k] = max(attn_err[k], v)
        if any(err[k] > ATTN_TOL[k] for k in err):
            raise AssertionError(f"{label}: kernel vs plain {err} beyond {ATTN_TOL}")
        n_valid = min(pk["n_out"].shape[1], pos // (cfg.page_words // (n_kv * hd)))
        log(f"[5] {label}: B={q.shape[0]} Kv={n_kv} hd={hd} G={groups} slots="
            f"{pk['n_out'].shape[1]} pos={pos} ({n_valid} valid slots, {int(live.sum())} live "
            f"rows): max|acc/l| err {err['out']:.3g}, m rel err {err['m']:.3g}, l rel err "
            f"{err['l']:.3g}; plain {pms:.3f} ms")
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
    enc_mod.launch_count = dec_mod.launch_count = pa_mod.launch_count = 0
    sessions, outs, step_ms = {}, {}, {}
    for label, sp in (("paged", spec), ("resident", res_spec)):
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
        log(f"[6] {label}: init + prefill of {T} tokens {fill_s:.3f} s; {steps} steps at "
            f"positions {T}..{T + steps - 1}: " + ", ".join(f"{t:.3f}" for t in step_ms[label])
            + " ms (host clock, synchronised)")
    serve_launches = {"gbdi_encode": enc_mod.launch_count, "gbdi_decode": dec_mod.launch_count,
                      "gbdi_paged_attn": pa_mod.launch_count}
    log(f"[6] serving-path launches: {serve_launches}")
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
    pa_ms, pa_min = median_ms(lambda: pa_mod.paged_attention_decode(
        qg, cache["k_pages"], cache["v_pages"], cache["table"], pos, kv16, **geom))
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
        f"{pa_plain_ms:.3f} ms")
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

    replaces = {"gbdi_encode": "src/repro/kernels/gbdi_encode.py:292",
                "gbdi_decode": "src/repro/kernels/gbdi_decode.py:148",
                "gbdi_paged_attn": "src/repro/kernels/gbdi_paged_attn.py:160"}
    kernels = []
    for kname, row in rows.items():
        bound_by = "bytes" if row["bytes"] / peak >= row["ops"] / INT_OPS_S else "operations"
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": replaces[kname], "launches": launches[kname] + serve_launches[kname],
            "max_abs_err": err[kname], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": bound_by, "library_ms": None,
        })
    kernels.append({
        "name": "gbdi_paged_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbdi_paged_attn.cu",
        "replaces": replaces["gbdi_paged_attn"], "launches": serve_launches["gbdi_paged_attn"],
        "max_abs_err": attn_err["out"], "ms": pa_ms, "plain_ms": pa_plain_ms,
        "bound_ms": pa_bound, "bound_by": pa_bound_by, "library_ms": lib_ms,
    })
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
