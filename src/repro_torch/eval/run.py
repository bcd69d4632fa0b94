"""Run the GBDI-FR main path (fit -> encode -> decode -> verify) per workload.

  PYTHONPATH=src python -m repro_torch.eval.run --suite ml_kvcache_bf16,605.mcf_s \\
      --bytes 268435456
  PYTHONPATH=src python -m repro_torch.eval.run --suite 605.mcf_s --throughput
  PYTHONPATH=src python -m repro_torch.eval.run --device cpu --bytes 262144

PyTorch counterpart of :func:`repro.eval.run.evaluate_cell` and
:func:`repro.eval.run.measure_throughput`.  Per cell the runner uploads the
stream once (set-up), fits, encodes, decodes, verifies the roundtrip on the
device (mismatching words must not exceed the dropped-outlier count) and
reports the compression ratio and bits per word.  Encode and decode times
are warmed medians of ``--repeats`` calls; on the card each is timed with
CUDA events and ends in ``torch.cuda.synchronize()``.  Every row names the
device and its power limit.

``--throughput`` reports encode/decode GiB/s and their share of the card's
published memory bandwidth, looked up by the name the card reports
(:func:`peak_bytes_s`).  It needs the card: a measurement path that finds no
CUDA device fails instead of timing the host.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.eval.registry import CodecRegistry, EvalCell, Workload, WorkloadRegistry

#: published HBM bandwidth by card, matched against the reported name
#: (NVIDIA data sheets; the SXM H100 is the default "H100")
PEAK_BYTES_S = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
)


def peak_bytes_s(device_name: str) -> float:
    """The card's published memory bandwidth; raises for a card not listed."""
    for key, bw in PEAK_BYTES_S:
        if key in device_name:
            return bw
    raise ValueError(f"no published memory bandwidth for device {device_name!r}")


@functools.lru_cache(maxsize=1)
def power_limit() -> str:
    """``nvidia-smi``'s power.limit of card 0, or "" where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_median(fn: Callable[[], Any], repeats: int, device: torch.device) -> float:
    """Median seconds of ``repeats`` warmed calls: CUDA events on the card,
    the host clock (after a synchronize) elsewhere.  The caller warms up."""
    times = []
    for _ in range(max(1, repeats)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def evaluate_cell(
    workload: Workload,
    codec: Any,
    data: np.ndarray,
    *,
    verify: bool = True,
    repeats: int = 3,
) -> EvalCell:
    """Measure one (workload, codec) pair on already-generated ``data``."""
    dev: torch.device = codec.torch_device
    n_bytes = int(np.ascontiguousarray(data).view(np.uint8).size)
    wb = codec.word_bits
    n_words = (n_bytes * 8 + wb - 1) // wb
    repeats = max(1, repeats)

    words = codec.stream(data)           # set-up: the stream lives on the device
    _sync(dev)
    t0 = time.perf_counter()
    model = codec.fit(words)             # offline background analysis
    _sync(dev)
    fit_s = time.perf_counter() - t0

    blob = codec.encode(words, model)    # warmup (kernel build on first use)
    size_bits = int(codec.size_bits(blob))
    enc_s = _timed_median(lambda: codec.encode(words, model), repeats, dev)
    decoded = codec.decode(blob)
    dec_s = _timed_median(lambda: codec.decode(blob), repeats, dev)

    mism = int((decoded != words).sum())
    exact_frac = 1.0 - mism / max(1, words.numel())
    verified, error = True, ""
    dropped = codec.dropped_words(blob)
    if verify:
        if codec.lossless and mism:
            verified = False
            error = f"lossless codec mismatched {mism}/{words.numel()} words"
        elif not codec.lossless:
            if mism > dropped:
                verified = False
                error = f"{mism} mismatches > {dropped} dropped outliers"

    return EvalCell(
        workload=workload.name,
        kind=workload.kind,
        codec=codec.name,
        n_bytes=n_bytes,
        word_bits=wb,
        compression_ratio=n_words * wb / max(1, size_bits),
        bits_per_word=size_bits / max(1, n_words),
        fit_s=fit_s,
        encode_s=enc_s,
        decode_s=dec_s,
        encode_mb_s=n_bytes / (1 << 20) / max(enc_s, 1e-9),
        lossless=mism == 0,
        exact_frac=exact_frac,
        verified=verified,
        error=error,
        mismatched_words=mism,
        dropped_words=dropped,
        device=device_name(dev),
        power_limit=power_limit() if dev.type == "cuda" else "",
    )


def evaluate(
    workload_registry: WorkloadRegistry,
    codec_registry: CodecRegistry,
    *,
    suite: str,
    codecs: str = "fr",
    n_bytes: int = 1 << 20,
    seed: int = 0,
    verify: bool = True,
    repeats: int = 3,
) -> list[EvalCell]:
    """Every (workload, codec) cell of ``suite``; a raising cell raises."""
    cells = []
    for wl in workload_registry.select(suite):
        data = wl.generate(n_bytes, seed)
        for cname in (c.strip() for c in codecs.split(",") if c.strip()):
            codec = codec_registry.make(cname, wl.word_bits)
            cells.append(evaluate_cell(wl, codec, data, verify=verify, repeats=repeats))
    return cells


def measure_throughput(
    workload: Workload, codec: Any, data: np.ndarray, *, repeats: int = 5,
    n_bytes_requested: int | None = None,
) -> dict[str, Any]:
    """Warmed median-of-``repeats`` encode/decode GiB/s on the card, with the
    roofline share against the card's published bandwidth.  ``bytes_moved``
    is the stream read plus the serialized blob written, as in the reference."""
    dev: torch.device = codec.torch_device
    if dev.type != "cuda":
        raise RuntimeError("measure_throughput times the CUDA card; "
                           f"the codec runs on {dev}")
    n_bytes = int(np.ascontiguousarray(data).view(np.uint8).size)
    requested = n_bytes if n_bytes_requested is None else int(n_bytes_requested)
    words = codec.stream(data)
    model = codec.fit(words)
    blob = codec.encode(words, model)              # warmup
    enc_s = _timed_median(lambda: codec.encode(words, model), repeats, dev)
    codec.decode(blob)                             # warmup
    dec_s = _timed_median(lambda: codec.decode(blob), repeats, dev)
    gib = n_bytes / (1 << 30)
    comp_bytes = (int(codec.size_bits(blob)) + 7) // 8
    bytes_moved = n_bytes + comp_bytes
    name = device_name(dev)
    peak = peak_bytes_s(name)
    return {
        "workload": workload.name,
        "kind": workload.kind,
        "codec": codec.name,
        "n_bytes": n_bytes,
        "n_bytes_requested": requested,
        "truncated": n_bytes < requested,
        "device": name,
        "power_limit": power_limit(),
        "devices": torch.cuda.device_count(),
        "repeats": max(1, repeats),
        "enc_s": enc_s,
        "dec_s": dec_s,
        "enc_gib_s": gib / max(enc_s, 1e-12),
        "dec_gib_s": gib / max(dec_s, 1e-12),
        "comp_bytes": comp_bytes,
        "bytes_moved": bytes_moved,
        "peak_bytes_s": peak,
        "enc_roofline_frac": bytes_moved / max(enc_s, 1e-12) / peak,
        "dec_roofline_frac": bytes_moved / max(dec_s, 1e-12) / peak,
    }


def format_table(cells: list[EvalCell]) -> str:
    hdr = (f"{'workload':<18} {'codec':<5} {'MiB':>7} {'CR':>7} {'bits/w':>7} "
           f"{'enc ms':>9} {'dec ms':>9} {'exact':>8} {'ok':>3}  device")
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        lines.append(
            f"{c.workload:<18} {c.codec:<5} {c.n_bytes / (1 << 20):>7.1f} "
            f"{c.compression_ratio:>7.4f} {c.bits_per_word:>7.3f} "
            f"{c.encode_s * 1e3:>9.3f} {c.decode_s * 1e3:>9.3f} {c.exact_frac:>8.5f} "
            f"{'yes' if c.verified else 'NO':>3}  {c.device} {c.power_limit}".rstrip())
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> list[EvalCell]:
    from repro_torch.eval.codecs import default_codecs
    from repro_torch.eval.workloads import default_workloads

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--suite", default="ml_kvcache_bf16,605.mcf_s",
                    help="comma list of kinds and/or workload names, or 'all'")
    ap.add_argument("--bytes", type=int, default=1 << 20, dest="n_bytes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed repeats (median reported; default 3, 5 for --throughput)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain versions")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--throughput", action="store_true",
                    help="encode/decode GiB/s and roofline share on the card")
    ap.add_argument("--json", default="", help="write the rows here as JSON")
    args = ap.parse_args(argv)

    registry = default_workloads()
    codecs = default_codecs(args.device)
    if args.throughput:
        workloads = registry.select(args.suite)
        repeats = args.repeats if args.repeats is not None else 5
        rows = [measure_throughput(wl, codecs.make("fr", wl.word_bits),
                                   wl.generate(args.n_bytes, args.seed), repeats=repeats,
                                   n_bytes_requested=args.n_bytes)
                for wl in workloads]
        for r in rows:
            print(json.dumps(r))
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"bench": "throughput", "rows": rows}, f, indent=2)
        return []
    cells = evaluate(registry, codecs, suite=args.suite, n_bytes=args.n_bytes,
                     seed=args.seed, verify=not args.no_verify,
                     repeats=args.repeats if args.repeats is not None else 3)
    print(format_table(cells))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"bench": "eval", "rows": [c.to_json() for c in cells]}, f, indent=2)
    bad = [c for c in cells if not c.verified]
    if bad:
        raise SystemExit(f"{len(bad)} cells failed verification: "
                         + ", ".join(f"{c.workload} ({c.error})" for c in bad))
    return cells


if __name__ == "__main__":
    main()
