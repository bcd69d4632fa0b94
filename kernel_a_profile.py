#!/usr/bin/env python3
"""Where the GBDI-FR page encode's time goes, on one NVIDIA card.

    python3 kernel_a_profile.py [--csrc DIR]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Beside the kernels it builds two copies of ``gbdi_encode.cu`` (from
``src/repro_torch/kernels/csrc``, or from ``--csrc``, e.g. the same
directory of another checkout, to profile that kernel through this
checkout's wrapper), made at run time under ``build/repro_torch/profile/``:

* ``phases``: ``clock64()`` counters at thread 0 of every block, from one
  step's end to the next (the block's barriers), summed over blocks;
* ``no_spill``: a word that overflows its bucket becomes an outlier instead
  of taking its next base (wrong results; only timed).

On the two codec streams of ``chip_smoke.py`` at 256 MiB each
(``ml_kvcache_bf16``: 16-bit words, 14 bases, widths (4, 8);
``605.mcf_s``: 32-bit words, 14 bases, widths (8, 16)) it prints the
kernel's time and each copy's (CUDA events, median and min of 10, warmed,
in turns), the shared bytes and registers of a block and the blocks an SM
holds, and the cycles per page of each step.  It imports nothing of the
JAX package.  Exit code 2: no CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STREAM_BYTES = 256 << 20
TIMING_REPEATS = 10
N_COUNTERS = 16

PROF_HEAD = '''
__shared__ long long prof_cycles[17];  // [16]: the clock at the last mark
__device__ unsigned long long g_prof[16];
#define ENC_PROF_START do { if (threadIdx.x == 0) { for (int i_ = 0; i_ < 16; ++i_) \\
    prof_cycles[i_] = 0; prof_cycles[16] = clock64(); } } while (0);
#define ENC_STEP(k) do { if (threadIdx.x == 0) { const long long c_ = clock64(); \\
    prof_cycles[(k)] += c_ - prof_cycles[16]; prof_cycles[16] = c_; } } while (0)
#define ENC_PROF_END do { if (threadIdx.x == 0) for (int i_ = 0; i_ < 16; ++i_) \\
    atomicAdd(&g_prof[i_], (unsigned long long)prof_cycles[i_]); } while (0)
'''
PROF_TAIL = '''
extern "C" int prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int prof_reset() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
#: counter names: 0 and 1, then a pair per width class (2 + 2c, 3 + 2c),
#: then 12..15
STEP_NAMES = {0: "table staging", 1: "load + first base search"}
for _c in range(5):
    STEP_NAMES[2 + 2 * _c] = f"class {_c}: ballot/scan"
    STEP_NAMES[3 + 2 * _c] = f"class {_c}: rank + emit + spill"
STEP_NAMES.update({12: "outlier compaction", 13: "codes + ptr pack", 14: "stores"})


def swap(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{what}: the kernel source changed; cannot patch {old[:50]!r}")
    return text.replace(old, new)


def patch_legacy(src: str, name: str) -> str:
    """The first layout (state in shared memory, a table walk per search):
    marks put at its barriers by anchor text."""
    if name == "no_spill":
        return swap(src, "const int alt = best_base(a, s, s.x[p], c);", "const int alt = -1;", name)
    src = swap(src, '#include "gbdi_common.cuh"\n', '#include "gbdi_common.cuh"\n' + PROF_HEAD, name)
    src = swap(src, "    scan_chunks(s.masks, s.prefix, chunks);\n    for (int p = tid; p < P; p += blockDim.x) {\n"
               "      if (!flag_of(s.masks, p)) continue;\n      const int r = rank_of(s.masks, s.prefix, p);\n"
               "      if (r < cap) {",
               "    scan_chunks(s.masks, s.prefix, chunks);\n    ENC_STEP(2 + 2 * c);\n"
               "    for (int p = tid; p < P; p += blockDim.x) {\n"
               "      if (!flag_of(s.masks, p)) continue;\n      const int r = rank_of(s.masks, s.prefix, p);\n"
               "      if (r < cap) {", name)
    src = swap(src, "          s.st[p] = kOut;\n        }\n      }\n    }\n  }\n",
               "          s.st[p] = kOut;\n        }\n      }\n    }\n    ENC_STEP(3 + 2 * c);\n  }\n", name)
    src = swap(src, "    if (my_spill) atomicAdd(&s.misc[8], my_spill);\n  }\n  __syncthreads();\n  return total_out;",
               "    if (my_spill) atomicAdd(&s.misc[8], my_spill);\n  }\n  __syncthreads();\n"
               "  ENC_STEP(12);\n  return total_out;", name)
    src = swap(src, "  const EncSmem s = carve(smem, a);\n", "  const EncSmem s = carve(smem, a);\n  ENC_PROF_START\n", name)
    src = swap(src, "  if (tid == 0) s.misc[8] = 0;\n  __syncthreads();\n",
               "  if (tid == 0) s.misc[8] = 0;\n  __syncthreads();\n  ENC_STEP(0);\n", name)
    src = swap(src, "    s.sel0[p] = sel;\n    s.st0[p] = st;\n  }\n  __syncthreads();\n",
               "    s.sel0[p] = sel;\n    s.st0[p] = st;\n  }\n  __syncthreads();\n  ENC_STEP(1);\n", name)
    src = swap(src, "    pp[l] = static_cast<int>(v);\n  }\n", "    pp[l] = static_cast<int>(v);\n  }\n  ENC_STEP(13);\n", name)
    src = swap(src, "    if (a.profile) a.profile[page] = pid;\n  }\n}",
               "    if (a.profile) a.profile[page] = pid;\n  }\n  ENC_STEP(14);\n  ENC_PROF_END;\n}", name)
    tail = '''
extern "C" int prof_blocks_per_sm(const int* ip) {
  const size_t smem = enc_smem_bytes(ip[1], ip[9], ip[4]);
  if (cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, encode_kernel, kThreads, smem) ? -1 : n;
}
'''
    return src + PROF_TAIL + tail


def patch_steps(src: str, name: str) -> str:
    """The current layout: the source marks its steps with ENC_STEP(k) and
    reads ENC_NO_SPILL, all no-ops unless defined before it."""
    if name == "no_spill":
        return "#define ENC_NO_SPILL 1\n" + src
    src = swap(src, '#include "gbdi_common.cuh"\n', '#include "gbdi_common.cuh"\n' + PROF_HEAD, name)
    return src + PROF_TAIL


def patched(src: str, name: str) -> str:
    if "ENC_STEP(" in src:
        return patch_steps(src, name)
    if "best_base(a, s, s.x[p], c)" in src:
        return patch_legacy(src, name)
    raise RuntimeError("gbdi_encode.cu has neither known layout; update kernel_a_profile.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="the csrc directory whose gbdi_encode.cu to profile")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_a_profile: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.gbdi_fr import fit_fr_bases
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import FRCodec, default_config
    from repro_torch.eval.workloads import default_workloads
    from repro_torch.kernels import _build
    from repro_torch.kernels import gbdi_encode as enc_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    csrc = (args.csrc or _build.CSRC).resolve()
    out_dir = _build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (csrc / "gbdi_encode.cu").read_text()
    procs = {}
    for name in ("kernel", "phases", "no_spill"):
        cu, so = out_dir / f"enc_{name}.cu", out_dir / f"libenc_{name}.so"
        cu.write_text(src if name == "kernel" else patched(src, name))
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{text}")
        regs[name] = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
        for line in text.splitlines():
            if name == "kernel" and ("ptxas info" in line or "spill" in line):
                print(f"  ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.gbdi_encode_launch.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.gbdi_encode_launch.restype = ctypes.c_int
        lib.gbdi_encode_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.gbdi_encode_smem_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    print(f"registers a thread (per kernel instantiation): {regs}", flush=True)

    reg = default_workloads()
    peak = eval_run.peak_bytes_s(torch.cuda.get_device_name(0))
    plain_load = enc_mod._build.load

    def encode_with(name: str, pages, table, cfg):
        enc_mod._build.load = lambda _n: libs[name]
        try:
            return enc_mod.gbdi_encode(pages, table, cfg)
        finally:
            enc_mod._build.load = plain_load

    def timed(fn) -> tuple[float, float]:
        fn()
        times = []
        for _ in range(TIMING_REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2], times[0]

    for wname in ("ml_kvcache_bf16", "605.mcf_s"):
        wl = reg.get(wname)
        data = wl.generate(STREAM_BYTES, 0)
        cfg = default_config(wl.word_bits)
        words = FRCodec(word_bits=wl.word_bits).stream(data)
        pages = torch.nn.functional.pad(words, (0, (-words.numel()) % cfg.page_words))
        pages = pages.reshape(-1, cfg.page_words).contiguous()
        table = fit_fr_bases(pages, cfg)
        n_pages = pages.shape[0]
        ip = _build.int_array(enc_mod.kernel_iparams(cfg, n_pages))
        smem = libs["kernel"].gbdi_encode_smem_bytes(ip)
        lib = libs["kernel"]
        if hasattr(lib, "gbdi_encode_blocks_per_sm"):
            lib.gbdi_encode_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
            per_sm = lib.gbdi_encode_blocks_per_sm(ip)
        else:
            libs["phases"].prof_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
            per_sm = libs["phases"].prof_blocks_per_sm(ip)
        ref = encode_with("kernel", pages, table, cfg)
        torch.cuda.synchronize()
        n_bytes = pages.numel() * 4 + sum(v.numel() * 4 for v in ref.values())
        print(f"\n{wname}: {n_pages} pages of {cfg.page_words} words (word_bits {cfg.word_bits}, "
              f"{cfg.num_bases} bases, widths {cfg.width_set}); spilled "
              f"{int(ref['n_spilled'].sum())}, dropped {int(ref['n_dropped'].sum())}; {smem} B of "
              f"shared memory a block, {per_sm} block(s) an SM; bytes bound "
              f"{n_bytes / peak * 1e3:.4f} ms ({n_bytes} B at {peak:.3g} B/s)", flush=True)
        for name in ("kernel", "no_spill", "phases", "phases", "no_spill", "kernel"):
            ms, lo = timed(lambda: encode_with(name, pages, table, cfg))
            print(f"  {name:9s} {ms:.4f} ms (median of {TIMING_REPEATS}, min {lo:.4f})", flush=True)
        got = encode_with("phases", pages, table, cfg)
        torch.cuda.synchronize()
        if any(not torch.equal(got[k], ref[k]) for k in ref):
            raise AssertionError(f"{wname}: the phases copy's blob differs from the kernel's")
        lib = libs["phases"]
        for fn in (lib.prof_reset, lib.prof_read):
            fn.restype = ctypes.c_int
        if lib.prof_reset() != 0:
            raise RuntimeError("prof_reset failed")
        encode_with("phases", pages, table, cfg)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * N_COUNTERS)()
        if lib.prof_read(counts) != 0:
            raise RuntimeError("prof_read failed")
        total = sum(counts)
        print(f"  cycles per page (thread 0 of each block, summed over {n_pages} blocks):")
        for i in range(N_COUNTERS):
            if counts[i]:
                print(f"    {STEP_NAMES.get(i, f'counter {i}'):34s} {counts[i] / n_pages:10.1f}  "
                      f"({counts[i] / total:.3f})")
        print(f"    {'total':34s} {total / n_pages:10.1f}", flush=True)
        del pages, words, ref, got
        torch.cuda.empty_cache()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
