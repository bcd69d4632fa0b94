"""Run every registered codec over every registered workload, on the card.

  PYTHONPATH=src python -m repro_torch.eval.run --suite all --codec gbdi,bdi,fr --csv
  PYTHONPATH=src python -m repro_torch.eval.run --suite java,605.mcf_s --bytes 16777216 \\
      --json eval.json
  PYTHONPATH=src python -m repro_torch.eval.run --sweep --suite 605.mcf_s,ml_kvcache_bf16
  PYTHONPATH=src python -m repro_torch.eval.run --throughput --json throughput.json
  PYTHONPATH=src python -m repro_torch.eval.run --device cpu --suite column --bytes 262144
  PYTHONPATH=src python -m repro_torch.eval.run --suite dump --dump-dir experiments/dumps

PyTorch counterpart of :mod:`repro.eval.run`.  Per cell the runner uploads
the stream once (set-up), fits, encodes, decodes, verifies the roundtrip on
the device (bit-exact for the lossless codecs; for the fixed-rate codec,
mismatching words must not exceed the dropped-outlier count) and reports the
compression ratio and bits per word.  Encode and decode times are warmed
medians of ``--repeats`` calls; on the card each is timed with CUDA events.
Every row names the device and its power limit.  Output is an aligned table
with per-kind geomean CR lines, ``name,us_per_call,derived`` CSV lines
(``--csv``) and a ``BENCH_*.json``-style artifact (``--json``).  The run
exits non-zero and names every cell that failed verification; a cell that
raises stops the run (nothing is hidden as a red cell).

``--sweep`` walks the num_bases x width_set/bucket_caps grid of GBDI-FR
configs (plus adaptive ``--profile-sets`` rows) over the suite and prints a
Pareto table (geomean CR vs encode MB/s).

``--throughput`` reports encode/decode GiB/s per codec and workload family
and their share of the card's published memory bandwidth, looked up by the
name the card reports (:func:`peak_bytes_s`).  It needs the card: a
measurement path that finds no CUDA device fails instead of timing the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core.gbdi_fr import FRConfig
from repro_torch.eval.registry import CodecRegistry, EvalCell, Workload, WorkloadRegistry
from repro_torch.launch.mesh import HBM_BW

#: published HBM bandwidth by card, matched against the reported name
#: (NVIDIA data sheets); the SXM H100, the default "H100", takes the
#: roofline's rate from :mod:`repro_torch.launch.mesh`
PEAK_BYTES_S = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", HBM_BW),
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
    suite: str = "all",
    codecs: str = "gbdi,bdi,fr",
    n_bytes: int = 1 << 20,
    seed: int = 0,
    verify: bool = True,
    repeats: int = 3,
) -> list[EvalCell]:
    """Every (workload, codec) cell of ``suite``; a raising cell raises."""
    cells = []
    codec_names = [c.strip() for c in codecs.split(",") if c.strip()]
    for wl in workload_registry.select(suite):
        data = wl.generate(n_bytes, seed)
        for cname in codec_names:
            codec = codec_registry.make(cname, wl.word_bits)
            cells.append(evaluate_cell(wl, codec, data, verify=verify, repeats=repeats))
    return cells


# ---------------------------------------------------------------------------
# config sweep (num_bases x width_set/bucket_caps Pareto)
# ---------------------------------------------------------------------------

#: per-word-size (width_set, bucket_caps) grid points, as in the reference
SWEEP_SHAPES = {
    16: [
        ((8,), (2048,)),                       # v1-equivalent single width
        ((4, 8), (192, 1856)),                 # v2 default
        ((4, 8), (128, 1536)),                 # tighter buckets
        ((2, 4, 8), (128, 256, 1664)),         # three classes
    ],
    32: [
        ((16,), (2048,)),
        ((8, 16), (192, 1856)),
        ((8, 16), (128, 1536)),
        ((4, 8, 16), (128, 256, 1664)),
    ],
}
SWEEP_NUM_BASES = (6, 14, 30)

#: named bucket-cap profile tables for the adaptive sweep axis, keyed by word
#: size; each pairs the default v2 width set of that word size
#: (``SWEEP_SHAPES[wb][1][0]``).  ``"static"`` is the plain cap grid.
SWEEP_PROFILE_SETS: dict[str, dict[int, tuple[tuple[int, ...], ...]] | None] = {
    "static": None,
    "adaptive4": {
        16: ((192, 1856), (1024, 1024), (64, 1984), (256, 512)),
        32: ((192, 1856), (1024, 1024), (64, 1984), (256, 512)),
    },
    "adaptive2": {
        16: ((192, 1856), (256, 512)),
        32: ((192, 1856), (256, 512)),
    },
}
DEFAULT_PROFILE_SETS = "static,adaptive4"


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One row of the sweep grid: ``config(word_bits)`` is its FRConfig."""
    num_bases: int
    shape_idx: int | None
    profile_set: str

    @property
    def tag(self) -> str:
        return "" if self.profile_set == "static" else f"+{self.profile_set}"

    def config(self, word_bits: int) -> FRConfig:
        if self.shape_idx is not None:
            width_set, caps = SWEEP_SHAPES[word_bits][self.shape_idx]
            return FRConfig(word_bits=word_bits, num_bases=self.num_bases,
                            width_set=width_set, bucket_caps=caps)
        profiles = SWEEP_PROFILE_SETS[self.profile_set]
        assert profiles is not None
        return FRConfig(word_bits=word_bits, num_bases=self.num_bases,
                        width_set=SWEEP_SHAPES[word_bits][1][0],
                        cap_profiles=profiles[word_bits])


def sweep_grid(profile_sets: str = DEFAULT_PROFILE_SETS) -> list[SweepPoint]:
    """The sweep's rows in the reference's order: per ``num_bases``, the
    static shapes, then one row per adaptive profile set."""
    names = [s.strip() for s in profile_sets.split(",") if s.strip()]
    unknown = sorted(set(names) - set(SWEEP_PROFILE_SETS))
    if unknown:
        raise KeyError(f"unknown profile set(s) {unknown}; "
                       f"choose from {sorted(SWEEP_PROFILE_SETS)}")
    grid = []
    for k in SWEEP_NUM_BASES:
        if "static" in names:
            grid += [SweepPoint(k, i, "static") for i in range(len(SWEEP_SHAPES[16]))]
        grid += [SweepPoint(k, None, n) for n in names if SWEEP_PROFILE_SETS[n] is not None]
    return grid


def sweep(
    workload_registry: WorkloadRegistry,
    *,
    suite: str = "ml",
    device: str | None = None,
    n_bytes: int = 1 << 18,
    seed: int = 0,
    verify: bool = True,
    profile_sets: str = DEFAULT_PROFILE_SETS,
) -> list[dict]:
    """Evaluate the FR codec across the config grid; one row per config,
    each fitted on its own stream, with the Pareto front on (geomean CR,
    encode MB/s) marked."""
    from repro_torch.eval.codecs import FRCodec

    workloads = workload_registry.select(suite)
    streams = {wl.name: wl.generate(n_bytes, seed) for wl in workloads}
    rows: list[dict] = []
    for point in sweep_grid(profile_sets):
        cells, width_sets = [], {}
        for wl in workloads:
            cfg = point.config(wl.word_bits)
            width_sets[wl.word_bits] = cfg.width_set
            codec = FRCodec(word_bits=wl.word_bits, device=device, cfg=cfg,
                            name=f"fr[k{point.num_bases}/w{'-'.join(map(str, cfg.width_set))}"
                                 f"{point.tag}]")
            # repeats=1: the sweep is a CR Pareto, not a timing harness
            cells.append(evaluate_cell(wl, codec, streams[wl.name], verify=verify, repeats=1))
        label = f"k{point.num_bases}/" + "|".join(
            f"w{'-'.join(map(str, ws))}" for _, ws in sorted(width_sets.items())) + point.tag
        profiles = SWEEP_PROFILE_SETS[point.profile_set]
        rows.append({
            "config": label,
            "device": cells[0].device,
            "power_limit": cells[0].power_limit,
            "geomean_cr": geomean(c.compression_ratio for c in cells),
            "bits_per_word": float(np.mean([c.bits_per_word for c in cells])),
            "encode_mb_s": float(np.mean([c.encode_mb_s for c in cells])),
            "exact_frac": float(np.mean([c.exact_frac for c in cells])),
            "verified": all(c.verified for c in cells),
            "cells": [c.to_json() for c in cells],
            "num_bases": point.num_bases,
            "shape_idx": point.shape_idx,
            "profile_set": point.profile_set,
            "width_sets": {str(wb): list(ws) for wb, ws in sorted(width_sets.items())},
            **({} if profiles is None else {"cap_profiles": {
                str(wb): [list(p) for p in profs] for wb, profs in sorted(profiles.items())}}),
        })
    for r in rows:
        r["pareto"] = not any(
            o["geomean_cr"] >= r["geomean_cr"] and o["encode_mb_s"] >= r["encode_mb_s"]
            and (o["geomean_cr"] > r["geomean_cr"] or o["encode_mb_s"] > r["encode_mb_s"])
            for o in rows)
    return rows


def format_sweep_table(rows: list[dict]) -> str:
    hdr = (f"{'config':<26} {'CR(geo)':>8} {'bits/w':>7} {'enc MB/s':>9} "
           f"{'exact':>7} {'ok':>3} {'pareto':>6}  device")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: -r["geomean_cr"]):
        lines.append(
            f"{r['config']:<26} {r['geomean_cr']:>8.3f} {r['bits_per_word']:>7.2f} "
            f"{r['encode_mb_s']:>9.1f} {r['exact_frac']:>7.4f} "
            f"{'yes' if r['verified'] else 'NO':>3} {'*' if r['pareto'] else '':>6}  "
            f"{r['device']} {r['power_limit']}".rstrip())
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# throughput (warmed, median-of-K GiB/s per codec x workload family)
# ---------------------------------------------------------------------------

#: one representative stream per workload family, plus both bf16 ML
#: distributions the serving and training paths move (the reference's set)
THROUGHPUT_WORKLOADS = (
    "605.mcf_s",          # C
    "java_svm",           # Java
    "col_int_keys",       # Column
    "ml_kvcache_bf16",    # ML (serving KV distribution)
    "ml_grads_bf16",      # ML (gradient-transport distribution)
)
THROUGHPUT_CODECS = "gbdi,bdi,fr,fr_xla,fr_kernel"


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


def throughput(
    workload_registry: WorkloadRegistry,
    codec_registry: CodecRegistry,
    *,
    suite: str = "",
    codecs: str = THROUGHPUT_CODECS,
    n_bytes: int = 2 << 20,
    repeats: int = 5,
    seed: int = 0,
    rows: list[dict] | None = None,
    on_row: Callable[[dict], None] | None = None,
) -> list[dict]:
    """One row per (workload, codec): warmed median-of-K encode/decode GiB/s.

    ``suite=''`` uses :data:`THROUGHPUT_WORKLOADS`.  Every completed row is
    appended to ``rows`` (returned) and passed to ``on_row``; a codec that
    raises appends a ``failed`` row, fires ``on_row`` and re-raises as
    ``RuntimeError``, so a partial artifact says where the run stopped.
    """
    workloads = (workload_registry.select(suite) if suite
                 else [workload_registry.get(n) for n in THROUGHPUT_WORKLOADS])
    codec_names = [c.strip() for c in codecs.split(",") if c.strip()]
    rows = [] if rows is None else rows
    for wl in workloads:
        data = wl.generate(n_bytes, seed)
        for cname in codec_names:
            try:
                codec = codec_registry.make(cname, wl.word_bits)
                row = measure_throughput(wl, codec, data, repeats=repeats,
                                         n_bytes_requested=n_bytes)
            except Exception as e:
                row = {"workload": wl.name, "kind": wl.kind, "codec": cname,
                       "n_bytes": n_bytes, "n_bytes_requested": n_bytes,
                       "failed": True, "error": f"{type(e).__name__}: {e}"}
                rows.append(row)
                if on_row is not None:
                    on_row(row)
                raise RuntimeError(f"throughput run aborted: codec {cname!r} failed on "
                                   f"workload {wl.name!r}: {type(e).__name__}: {e}") from e
            rows.append(row)
            if on_row is not None:
                on_row(row)
    return rows


def throughput_summary(rows: list[dict]) -> list[dict]:
    """Mean GiB/s per codec x workload kind; failed rows skipped."""
    groups: dict[tuple[str, str], list[dict]] = {}
    for r in rows:
        if not r.get("failed"):
            groups.setdefault((r["codec"], r["kind"]), []).append(r)
    return [
        {"codec": codec, "kind": kind, "n_workloads": len(g),
         "enc_gib_s": float(np.mean([r["enc_gib_s"] for r in g])),
         "dec_gib_s": float(np.mean([r["dec_gib_s"] for r in g]))}
        for (codec, kind), g in sorted(groups.items())
    ]


def format_throughput_table(rows: list[dict]) -> str:
    hdr = (f"{'workload':<26} {'kind':<7} {'codec':<6} {'MiB':>7} {'enc GiB/s':>10} "
           f"{'dec GiB/s':>10} {'enc rf':>8} {'dec rf':>8}  device")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("failed"):
            lines.append(f"{r['workload']:<26} {r['kind']:<7} {r['codec']:<6} "
                         f"{r['n_bytes'] / (1 << 20):>7.2f} FAILED: {r['error']}")
            continue
        lines.append(
            f"{r['workload']:<26} {r['kind']:<7} {r['codec']:<6} "
            f"{r['n_bytes'] / (1 << 20):>7.2f} {r['enc_gib_s']:>10.3f} {r['dec_gib_s']:>10.3f} "
            f"{r['enc_roofline_frac']:>8.4f} {r['dec_roofline_frac']:>8.4f}  "
            f"{r['device']} {r['power_limit']}".rstrip())
    for s in throughput_summary(rows):
        lines.append(f"family {s['kind']:<7} {s['codec']:<6} "
                     f"enc={s['enc_gib_s']:.3f} dec={s['dec_gib_s']:.3f} GiB/s")
    return "\n".join(lines)


def throughput_artifact(rows: list[dict], *, codecs: str, n_bytes: int, repeats: int,
                        seed: int, complete: bool = True) -> dict:
    name = device_name(torch.device("cuda")) if torch.cuda.is_available() else "cpu"
    return {
        "bench": "throughput",
        "codecs": codecs,
        "n_bytes": n_bytes,
        "repeats": repeats,
        "seed": seed,
        "device": name,
        "power_limit": power_limit(),
        "devices": torch.cuda.device_count(),
        "complete": complete,       # False while rows stream in
        "rows": rows,
        "summary": throughput_summary(rows),
    }


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def write_artifact(path: str, payload: dict) -> list[Path]:
    """Write a ``BENCH_*.json`` artifact; one written into a directory named
    ``experiments`` is mirrored next to that directory, as the reference
    does.  Returns the paths written."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    text = json.dumps(payload, indent=2)
    p.write_text(text)
    written = [p]
    if p.parent.name == "experiments" and p.name.startswith("BENCH_"):
        mirror = p.parent.parent / p.name
        mirror.write_text(text)
        written.append(mirror)
    return written


def geomean(xs: Iterable[float]) -> float:
    """Geometric mean of CRs (0.0 for an empty set)."""
    xs = list(xs)
    if not xs:
        return 0.0
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-9)))))


def format_table(cells: list[EvalCell]) -> str:
    hdr = (f"{'workload':<26} {'kind':<7} {'codec':<5} {'MiB':>7} {'CR':>7} {'bits/w':>7} "
           f"{'enc ms':>9} {'dec ms':>9} {'exact':>8} {'ok':>3}  device")
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        lines.append(
            f"{c.workload:<26} {c.kind:<7} {c.codec:<5} {c.n_bytes / (1 << 20):>7.1f} "
            f"{c.compression_ratio:>7.4f} {c.bits_per_word:>7.3f} "
            f"{c.encode_s * 1e3:>9.3f} {c.decode_s * 1e3:>9.3f} {c.exact_frac:>8.5f} "
            f"{'yes' if c.verified else 'NO':>3}  {c.device} {c.power_limit}".rstrip())
    kinds = sorted({c.kind for c in cells})
    for codec in sorted({c.codec for c in cells}):
        sub = [c for c in cells if c.codec == codec and c.compression_ratio > 0]
        if not sub:
            continue
        per_kind = "  ".join(
            f"{k}={geomean(c.compression_ratio for c in sub if c.kind == k):.3f}"
            for k in kinds if any(c.kind == k for c in sub))
        lines.append(f"geomean CR [{codec:<5}] {per_kind}  "
                     f"all={geomean(c.compression_ratio for c in sub):.3f}")
    return "\n".join(lines)


def csv_lines(cells: list[EvalCell]) -> list[str]:
    """``name,us_per_call,derived`` rows, the benchmarks/ convention."""
    return [
        f"eval/{c.workload}/{c.codec},{c.encode_s * 1e6:.1f},"
        f"cr={c.compression_ratio:.3f};bpw={c.bits_per_word:.2f};"
        f"exact={c.exact_frac:.4f};kind={c.kind};ok={int(c.verified)};"
        f"device={c.device};power_limit={c.power_limit}"
        for c in cells
    ]


def to_artifact(cells: list[EvalCell], *, suite: str, codecs: str,
                n_bytes: int, seed: int) -> dict:
    return {
        "bench": "eval",
        "suite": suite,
        "codecs": codecs,
        "n_bytes": n_bytes,
        "seed": seed,
        "rows": [c.to_json() for c in cells],
    }


def main(argv: list[str] | None = None) -> list[EvalCell]:
    from repro_torch.eval.codecs import default_codecs
    from repro_torch.eval.workloads import default_workloads

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--suite", default="all",
                    help="'all', or a comma list of kinds (c,java,column,ml,dump) and/or "
                         "workload names (incl. dump:<name>)")
    ap.add_argument("--dump-dir", default=None,
                    help="directory of ingested dump containers to register as "
                         "dump:<name> families (default: $REPRO_DUMP_DIR or experiments/dumps)")
    ap.add_argument("--codec", default=None,
                    help="comma list from: gbdi, bdi, fr, fr_xla, fr_kernel (default: gbdi,bdi,fr; "
                         f"{THROUGHPUT_CODECS} for --throughput; the sweep runs fr only)")
    ap.add_argument("--bytes", type=int, default=None, dest="n_bytes",
                    help="stream size per workload (default 1 MiB; 2 MiB for --throughput)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed repeats (median reported; default 3, 5 for --throughput)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain versions")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--csv", action="store_true", help="also print benchmarks/-style CSV lines")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep num_bases x width_set FR configs; Pareto table")
    ap.add_argument("--profile-sets", default=DEFAULT_PROFILE_SETS,
                    help="comma list of bucket-cap profile sets for --sweep "
                         f"(from: {','.join(sorted(SWEEP_PROFILE_SETS))})")
    ap.add_argument("--throughput", action="store_true",
                    help="encode/decode GiB/s and roofline share on the card")
    ap.add_argument("--json", default="", help="write a BENCH_*.json-style artifact here")
    args = ap.parse_args(argv)

    registry = default_workloads(args.dump_dir, device=args.device)
    codecs = default_codecs(args.device)
    if args.throughput:
        n_bytes = args.n_bytes if args.n_bytes is not None else 2 << 20
        repeats = args.repeats if args.repeats is not None else 5
        codec_names = args.codec or THROUGHPUT_CODECS
        rows: list[dict] = []

        def artifact(complete: bool) -> dict:
            return throughput_artifact(rows, codecs=codec_names, n_bytes=n_bytes,
                                       repeats=repeats, seed=args.seed, complete=complete)

        try:
            throughput(registry, codecs, suite="" if args.suite == "all" else args.suite,
                       codecs=codec_names, n_bytes=n_bytes, repeats=repeats, seed=args.seed,
                       rows=rows, on_row=(lambda _r: write_artifact(args.json, artifact(False)))
                       if args.json else None)
        except RuntimeError as e:
            print(format_throughput_table(rows))
            raise SystemExit(f"error: {e}")
        print(format_throughput_table(rows))
        if args.csv:
            for r in rows:
                mb = r["n_bytes"] / (1 << 20)
                print(f"throughput/{r['codec']}_encode/{r['workload']},"
                      f"{r['enc_s'] / mb * 1e6:.0f},GiB/s={r['enc_gib_s']:.3f}")
                print(f"throughput/{r['codec']}_decode/{r['workload']},"
                      f"{r['dec_s'] / mb * 1e6:.0f},GiB/s={r['dec_gib_s']:.3f}")
        if args.json:
            for p in write_artifact(args.json, artifact(True)):
                print(f"wrote {p}")
        return []

    n_bytes = args.n_bytes if args.n_bytes is not None else 1 << 20
    if args.sweep:
        rows = sweep(registry, suite=args.suite, device=args.device, n_bytes=n_bytes,
                     seed=args.seed, verify=not args.no_verify, profile_sets=args.profile_sets)
        print(format_sweep_table(rows))
        if args.json:
            for p in write_artifact(args.json, {
                    "bench": "sweep", "suite": args.suite, "n_bytes": n_bytes,
                    "seed": args.seed, "profile_sets": args.profile_sets, "rows": rows}):
                print(f"wrote {p}")
        bad = [r["config"] for r in rows if not r["verified"]]
        if bad:
            raise SystemExit(f"{len(bad)} sweep rows failed verification: {', '.join(bad)}")
        return []

    codec_names = args.codec or "gbdi,bdi,fr"
    cells = evaluate(registry, codecs, suite=args.suite, codecs=codec_names, n_bytes=n_bytes,
                     seed=args.seed, verify=not args.no_verify,
                     repeats=args.repeats if args.repeats is not None else 3)
    print(format_table(cells))
    if args.csv:
        for line in csv_lines(cells):
            print(line)
    if args.json:
        for p in write_artifact(args.json, to_artifact(
                cells, suite=args.suite, codecs=codec_names, n_bytes=n_bytes, seed=args.seed)):
            print(f"wrote {p}")
    bad = [c for c in cells if not c.verified]
    if bad:
        raise SystemExit(f"{len(bad)} cells failed verification: "
                         + ", ".join(f"{c.workload}/{c.codec} ({c.error})" for c in bad))
    return cells


if __name__ == "__main__":
    main()
