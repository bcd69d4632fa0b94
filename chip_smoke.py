#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports the port (``src/repro_torch``) and nothing of the JAX package.
Phases, in order; any failure exits non-zero before the final line:

1. the card: name, count, power limit; build both kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and print what ``-Xptxas -v`` reports;
2. each kernel against its plain PyTorch version on the card, bit for bit:
   every page of the two main-path streams (in chunks), an adaptive
   multi-profile config, a forced spill/drop page set, and the golden-CRC
   pages of the format's serialization;
3. the main path through ``repro_torch.eval.run.evaluate_cell`` at 256 MiB
   per stream: ``ml_kvcache_bf16`` (16-bit config) and ``605.mcf_s`` (32-bit
   config), fit -> encode -> decode -> verify (mismatched words <= dropped),
   with each kernel's launch counter set to 0 just before and read after;
4. per kernel and stream: the kernel's time (CUDA events, warmed, median),
   its bytes bound on this card, and the plain version's time.  No single
   PyTorch call computes either function, so there is no library yardstick
   (``library_ms`` is null).

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


def log(*args: object) -> None:
    print(*args, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch import interop
    from repro_torch.core.format_doc import serialize_page
    from repro_torch.core.gbdi_fr import FRConfig, fit_fr_bases
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import FRCodec, default_config
    from repro_torch.eval.workloads import default_workloads
    from repro_torch.kernels import _build
    from repro_torch.kernels import gbdi_decode as dec_mod
    from repro_torch.kernels import gbdi_encode as enc_mod

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
    spill_table = interop.table_from_numpy([1000, 1000, 20000], [4, 8, 8], dev)
    pb = enc_mod.gbdi_encode_plain(x, spill_table, spill)
    if not (int(pb["n_spilled"].sum()) > 0 and int(pb["n_dropped"].sum()) > 0):
        raise AssertionError("the forced spill/drop set spilled or dropped nothing")
    compare("forced-spill-drop", x, spill_table, spill)

    golden = FRConfig(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
                      bucket_caps=(64, 192), outlier_cap=16)
    gbases = np.array([1000, 5000, 9000, 20000, 40000, 60000], np.int32)
    rng = np.random.default_rng(42)
    w = gbases.astype(np.int64)[rng.integers(0, 6, (3, 256))] + rng.integers(-120, 120, (3, 256))
    w[:, ::7] = 0
    x = torch.as_tensor((w & 0xFFFF).astype(np.int32), device=dev)
    gtable = interop.table_from_numpy(gbases, [4, 8, 4, 8, 4, 8], dev)
    kb = enc_mod.gbdi_encode(x, gtable, golden)
    crcs = [zlib.crc32(serialize_page({k: v[i] for k, v in kb.items()}, golden)) for i in range(3)]
    if crcs != GOLDEN_CRCS:
        raise AssertionError(f"golden CRCs {crcs} != {GOLDEN_CRCS}")
    compare("golden-crc", x, gtable, golden)
    log(f"[2] golden CRCs matched: {crcs}")

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

    replaces = {"gbdi_encode": "src/repro/kernels/gbdi_encode.py:292",
                "gbdi_decode": "src/repro/kernels/gbdi_decode.py:148"}
    kernels = []
    for kname, row in rows.items():
        bound_by = "bytes" if row["bytes"] / peak >= row["ops"] / INT_OPS_S else "operations"
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": err[kname], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": bound_by, "library_ms": None,
        })
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
