#!/usr/bin/env python3
"""Where the GBDI-FR page decode's time goes, on one NVIDIA card.

    python3 kernel_b_profile.py [--csrc DIR] [--min-blocks 4,6,8]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Beside the kernels it builds copies of ``gbdi_decode.cu`` from
``src/repro_torch/kernels/csrc``, or from ``--csrc``: a whole ``csrc``
directory of another checkout, header included, whose kernel is then
profiled through this checkout's wrapper.  The copies are made at run time
under ``build/repro_torch/profile/``:

* ``phases``: ``clock64()`` counters at thread 0 of every block, from one
  mark to the next, summed over blocks, with the pages thread 0 took part
  in.  The current source marks its steps with ``DEC_STEP(k)`` (no-ops
  unless the copy defines them); the first layout (one block a page, the
  body ``gbdi::decode_page`` in ``gbdi_common.cuh``) is marked at its
  barriers by anchor text;
* ``lbN`` (current layout only, one per ``--min-blocks`` value): the kernel
  built with ``-DDEC_MIN_BLOCKS=N``, the ``__launch_bounds__`` minimum of
  blocks an SM.

On the two codec streams of ``chip_smoke.py`` at 256 MiB each
(``ml_kvcache_bf16``: 16-bit words, 14 bases, widths (4, 8);
``605.mcf_s``: 32-bit words, 14 bases, widths (8, 16)), encoded by the
plain encode (the encode kernel's blobs, bit for bit), it prints each
copy's time (CUDA events, median and min of 10, warmed, in turns), both
of the wrapper's call and of the kernel's launch alone, the bytes bound, the shared bytes and registers of a block and the blocks an
SM holds, and the cycles per page of each step.  Every copy's pages are
checked against the kernel's, bit for bit.  It imports nothing of the JAX
package.  Exit code 2: no CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STREAM_BYTES = 256 << 20
TIMING_REPEATS = 10
N_COUNTERS = 16
PAGES = 15  # the counter that counts thread 0's pages
ENCODE_CHUNK = 4096

PROF_HEAD = '''
__shared__ long long prof_cycles[17];  // [16]: the clock at the last mark
__device__ unsigned long long g_prof[16];
#define DEC_PROF_START do { if (threadIdx.x == 0) { for (int i_ = 0; i_ < 16; ++i_) \\
    prof_cycles[i_] = 0; prof_cycles[16] = clock64(); } } while (0)
#define DEC_STEP(k) do { if (threadIdx.x == 0) { const long long c_ = clock64(); \\
    prof_cycles[(k)] += c_ - prof_cycles[16]; prof_cycles[16] = c_; } } while (0)
#define DEC_PROF_PAGE do { if (threadIdx.x == 0) prof_cycles[15] += 1; } while (0)
#define DEC_PROF_END do { if (threadIdx.x == 0) for (int i_ = 0; i_ < 16; ++i_) \\
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
LEGACY_TAIL = '''
extern "C" int prof_blocks_per_sm(const int* ip) {
  const size_t smem = decode_smem_bytes(ip[1], ip[9], ip[4]);
  if (cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_kernel, kThreads, smem) ? -1 : n;
}
'''
#: counter names of the first layout: 0 and 1, a pair per width class, 12..14
LEGACY_STEPS = {0: "table staging", 1: "delta lanes + codes + zeroing"}
for _c in range(5):
    LEGACY_STEPS[2 + 2 * _c] = f"class {_c}: ballot/scan"
    LEGACY_STEPS[3 + 2 * _c] = f"class {_c}: rank + field"
LEGACY_STEPS.update({12: "base add", 13: "outlier scatter", 14: "stores"})
#: counter names of the warp-per-page layout (the DEC_STEP marks of the source)
WARP_STEPS = {0: "table staging", 1: "stage the blob (cp.async + wait)", 2: "outlier bitmap",
              3: "codes + table", 4: "class ranks", 5: "fields + base add", 6: "outliers",
              7: "stores"}


def swap(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{what}: the kernel source changed; cannot patch {old[:50]!r}")
    return text.replace(old, new)


def patch_legacy(dec: str, head: str) -> tuple[str, str]:
    """The first layout (one block a page, gbdi::decode_page in the header):
    marks put at its barriers by anchor text.  -> (decode source, header)."""
    w = "phases"
    head = swap(head, "  const int P = g.P, chunks = P / 32, tid = threadIdx.x;\n  __syncthreads();\n",
                "  const int P = g.P, chunks = P / 32, tid = threadIdx.x;\n  __syncthreads();\n"
                "  DEC_STEP(0);\n", w)
    head = swap(head, "  const bool pid_ok = pid >= 0 && pid < g.np;\n  __syncthreads();\n",
                "  const bool pid_ok = pid >= 0 && pid < g.np;\n  __syncthreads();\n  DEC_STEP(1);\n", w)
    head = swap(head, "      scan_chunks(s.masks, s.prefix, chunks);\n",
                "      scan_chunks(s.masks, s.prefix, chunks);\n      DEC_STEP(2 + 2 * c);\n", w)
    head = swap(head, "        s.val[p] = field >= half ? field - (1 << w) : field;\n      }\n",
                "        s.val[p] = field >= half ? field - (1 << w) : field;\n      }\n"
                "      DEC_STEP(3 + 2 * c);\n", w)
    head = swap(head, "    s.val[p] = v;\n  }\n", "    s.val[p] = v;\n  }\n  DEC_STEP(12);\n", w)
    head = swap(head, "    s.isout[idx] = 1;\n  }\n  __syncthreads();\n",
                "    s.isout[idx] = 1;\n  }\n  __syncthreads();\n  DEC_STEP(13);\n", w)
    head = swap(head, "emit(p, s.isout[p] ? s.contrib[p] : s.val[p]);\n",
                "emit(p, s.isout[p] ? s.contrib[p] : s.val[p]);\n  DEC_STEP(14);\n", w)
    dec = swap(dec, '#include "gbdi_common.cuh"\n', PROF_HEAD + '#include "gbdi_common.cuh"\n', w)
    dec = swap(dec, "  const DecodeSmem s = carve_decode_smem(smem, g);\n",
               "  const DecodeSmem s = carve_decode_smem(smem, g);\n  DEC_PROF_START;\n", w)
    dec = swap(dec, "[op](int p, int w) { op[p] = w; });\n}",
               "[op](int p, int w) { op[p] = w; });\n  DEC_PROF_PAGE;\n  DEC_PROF_END;\n}", w)
    return dec + PROF_TAIL + LEGACY_TAIL, head


def layout(dec: str) -> str:
    if "DEC_STEP(" in dec:
        return "warp"
    if "decode_page(" in dec:
        return "legacy"
    raise RuntimeError("gbdi_decode.cu has neither known layout; update kernel_b_profile.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="a csrc directory (header included) whose gbdi_decode.cu to profile")
    ap.add_argument("--min-blocks", default="",
                    help="comma-separated DEC_MIN_BLOCKS values to build and time (current layout)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_b_profile: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.gbdi_fr import fit_fr_bases
    from repro_torch.eval import run as eval_run
    from repro_torch.eval.codecs import FRCodec, default_config
    from repro_torch.eval.workloads import default_workloads
    from repro_torch.kernels import _build
    from repro_torch.kernels import gbdi_decode as dec_mod
    from repro_torch.kernels import gbdi_encode as enc_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    csrc = (args.csrc or _build.CSRC).resolve()
    dec_src = (csrc / "gbdi_decode.cu").read_text()
    head_src = (csrc / "gbdi_common.cuh").read_text()
    kind = layout(dec_src)
    steps = WARP_STEPS if kind == "warp" else LEGACY_STEPS
    lbs = [int(v) for v in args.min_blocks.split(",") if v]
    if lbs and kind != "warp":
        raise SystemExit("--min-blocks needs the current layout (DEC_MIN_BLOCKS)")
    print(f"profiling {csrc / 'gbdi_decode.cu'} ({kind} layout)", flush=True)

    out_dir = _build.BUILD_DIR / "profile" / "decode"
    shutil.rmtree(out_dir, ignore_errors=True)
    copies = {"kernel": ([], dec_src, head_src)}
    if kind == "warp":
        phases = (swap(dec_src, '#include "gbdi_common.cuh"\n',
                       PROF_HEAD + '#include "gbdi_common.cuh"\n', "phases") + PROF_TAIL, head_src)
    else:
        phases = patch_legacy(dec_src, head_src)
    copies["phases"] = ([], *phases)
    for n in lbs:
        copies[f"lb{n}"] = ([f"-DDEC_MIN_BLOCKS={n}"], dec_src, head_src)
    procs = {}
    for name, (flags, dec, head) in copies.items():
        d = out_dir / name
        d.mkdir(parents=True)
        (d / "gbdi_decode.cu").write_text(dec)
        (d / "gbdi_common.cuh").write_text(head)
        so = d / "libdec.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(d), "-o", str(so),
             str(d / "gbdi_decode.cu")],
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
        lib.gbdi_decode_launch.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.gbdi_decode_launch.restype = ctypes.c_int
        lib.gbdi_decode_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.gbdi_decode_smem_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    print(f"registers a thread, by copy: {regs}", flush=True)

    reg = default_workloads()
    peak = eval_run.peak_bytes_s(torch.cuda.get_device_name(0))
    plain_load = dec_mod._build.load

    def decode_with(name: str, blob, table, cfg):
        dec_mod._build.load = lambda _n: libs[name]
        try:
            return dec_mod.gbdi_decode(blob, table, cfg)
        finally:
            dec_mod._build.load = plain_load

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

    def launcher(name: str, blob, table, cfg):
        """The kernel's launch alone, its arguments made once as the
        wrapper makes them (table padding, meta upload, output)."""
        dev = blob["ptrs"].device
        bases, cls = (t.reshape(-1).contiguous() for t in enc_mod.pad_table(table, cfg))
        meta = enc_mod.kernel_meta(cfg, dev)
        n = blob["ptrs"].shape[0]
        out = torch.empty((n, cfg.page_words), dtype=torch.int32, device=dev)
        keep = (bases, cls, meta, out)
        ptrs = _build.ptr_array([
            *(blob[k].data_ptr() for k in ("ptrs", "deltas", "out_vals", "out_idx", "n_out")),
            blob["profile"].data_ptr() if cfg.num_profiles > 1 else 0,
            bases.data_ptr(), cls.data_ptr(), meta.data_ptr(), out.data_ptr()])
        ip = _build.int_array(enc_mod.kernel_iparams(cfg, n))
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            if libs[name].gbdi_decode_launch(ptrs, ip, stream) != 0:
                raise RuntimeError(f"{name}: launch failed")
            return keep
        return launch

    def blocks_per_sm(name: str, ip) -> int:
        lib = libs[name]
        fn = getattr(lib, "gbdi_decode_blocks_per_sm", None) or getattr(lib, "prof_blocks_per_sm", None)
        if fn is None:
            fn = libs["phases"].prof_blocks_per_sm
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        return fn(ip)

    order = list(copies)
    turns = order + order[::-1]
    for wname in ("ml_kvcache_bf16", "605.mcf_s"):
        wl = reg.get(wname)
        data = wl.generate(STREAM_BYTES, 0)
        cfg = default_config(wl.word_bits)
        words = FRCodec(word_bits=wl.word_bits).stream(data)
        pages = torch.nn.functional.pad(words, (0, (-words.numel()) % cfg.page_words))
        pages = pages.reshape(-1, cfg.page_words).contiguous()
        table = fit_fr_bases(pages, cfg)
        n_pages = pages.shape[0]
        chunks = [enc_mod.gbdi_encode_plain(pages[i:i + ENCODE_CHUNK], table, cfg)
                  for i in range(0, n_pages, ENCODE_CHUNK)]
        blob = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        del chunks
        ref = decode_with("kernel", blob, table, cfg)
        torch.cuda.synchronize()
        n_bytes = pages.numel() * 4 + sum(v.numel() * 4 for v in blob.values())
        ip = _build.int_array(enc_mod.kernel_iparams(cfg, n_pages))
        smem = libs["kernel"].gbdi_decode_smem_bytes(ip)
        per_sm = {name: blocks_per_sm(name, ip) for name in order}
        n_out = int(blob["n_out"].sum())
        print(f"\n{wname}: {n_pages} pages of {cfg.page_words} words (word_bits {cfg.word_bits}, "
              f"{cfg.num_bases} bases, widths {cfg.width_set}); {n_out} live outlier slots, "
              f"dropped {int(blob['n_dropped'].sum())}; {smem} B of shared memory a block; "
              f"blocks an SM by copy {per_sm}; bytes bound {n_bytes / peak * 1e3:.4f} ms "
              f"({n_bytes} B at {peak:.3g} B/s)", flush=True)
        launches = {name: launcher(name, blob, table, cfg) for name in order}
        for name in turns:
            ms, lo = timed(lambda: decode_with(name, blob, table, cfg))
            kms, klo = timed(launches[name])
            print(f"  {name:9s} call {ms:.4f} ms (median of {TIMING_REPEATS}, min {lo:.4f}), "
                  f"share {n_bytes / peak * 1e3 / ms:.3f}; launch alone {kms:.4f} ms (min "
                  f"{klo:.4f}), share {n_bytes / peak * 1e3 / kms:.3f}", flush=True)
        for name in order[1:]:
            got = decode_with(name, blob, table, cfg)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"{wname}: the {name} copy's pages differ from the kernel's")
        lib = libs["phases"]
        for fn in (lib.prof_reset, lib.prof_read):
            fn.restype = ctypes.c_int
        if lib.prof_reset() != 0:
            raise RuntimeError("prof_reset failed")
        decode_with("phases", blob, table, cfg)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * N_COUNTERS)()
        if lib.prof_read(counts) != 0:
            raise RuntimeError("prof_read failed")
        seen = counts[PAGES]
        total = sum(counts[i] for i in range(N_COUNTERS) if i != PAGES)
        print(f"  cycles per page (thread 0 of each block, summed over blocks; {seen} pages "
              f"seen by thread 0 of {n_pages}):")
        for i in range(N_COUNTERS):
            if i != PAGES and counts[i]:
                print(f"    {steps.get(i, f'counter {i}'):32s} {counts[i] / seen:10.1f}  "
                      f"({counts[i] / total:.3f})")
        print(f"    {'total':32s} {total / seen:10.1f}", flush=True)
        del pages, words, blob, ref, got, launches
        torch.cuda.empty_cache()
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
