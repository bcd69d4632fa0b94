#!/usr/bin/env python3
"""Where the paged-attention kernel's time goes, on one NVIDIA card.

    python3 kernel_c_profile.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Beside the kernels it builds three copies of
``src/repro_torch/kernels/csrc/gbdi_paged_attn.cu``, made at run time under
``build/repro_torch/profile/``:

* ``phases``: ``clock64()`` counters at each step of a pass (thread 0 of
  every block, the cycles from one barrier to the next, summed over blocks);
* ``no_decode``: the pass decode switched off (attention over stale words);
* ``no_attention``: the attention switched off (decode only).

The last two give wrong results and are only timed.  At the serving shape of
``chip_smoke.py`` phase 7 (batch 8, 8 KV heads of 128, 16 query groups,
16,383 full pages of ``KV_FR`` per row) it prints the kernel's time and each
copy's (CUDA events, median and min of 10, in turns), the time of
``scaled_dot_product_attention`` over the same tokens as a raw bf16 cache,
and the cycles per pass of each step.  It imports nothing of the JAX
package.  Exit code 2: no CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIMING_REPEATS = 10
SEED = 12
#: the serving path's attention layer (chip_smoke.py SERVE)
B, N_KV, HD, GROUPS, MAX_LEN = 8, 8, 128, 16, 32768

PROF_HEAD = '''
__shared__ long long prof_cycles[17];
__device__ unsigned long long g_prof[16];
__device__ __forceinline__ void prof_mark(int k) {
  if (threadIdx.x == 0) {
    const long long c = clock64();
    prof_cycles[k] += c - prof_cycles[16];
    prof_cycles[16] = c;
  }
}
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
PASS_LOOP = '''    __syncthreads();
    decode_pass(a, s, L, cur, n_s);
    body(s0, n_s);
  }
'''
PASS_START = "  const size_t row0 = static_cast<size_t>(b) * a.S;\n  const int pass_ints"
ATTN_TOKENS = "    const int T = n_s * a.pt;\n    for (int t0 = 0; t0 < T; t0 += kTile) {"
#: step names in counter order: 1 and 2 in the pass loop, 3.. at the decode's
#: barriers, 7 after the attention
STEPS = {1: "stage next pass + wait", 2: "first barrier", 3: "decode: count pass",
         4: "decode: full pass", 5: "decode: outliers", 7: "attention"}


def patched(src: str, name: str) -> str:
    """The source of one copy; raises if the source no longer has the
    places the copy patches."""
    def swap(text: str, old: str, new: str) -> str:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel source changed; cannot patch {old[:40]!r}")
        return text.replace(old, new)

    if name == "no_decode":
        return swap(src, "    decode_pass(a, s, L, cur, n_s);\n    body(s0, n_s);", "    body(s0, n_s);")
    if name == "no_attention":
        return swap(src, ATTN_TOKENS, ATTN_TOKENS.replace("n_s * a.pt", "0 * n_s * a.pt"))
    src = swap(src, '#include "gbdi_common.cuh"\n', '#include "gbdi_common.cuh"\n' + PROF_HEAD)
    a = src.index("__device__ void decode_pass(")
    b = src.index("// Stage the code table, then walk page slots")
    lines = src[a:b].splitlines(True)
    bars = [i for i, line in enumerate(lines) if line.strip() == "__syncthreads();"]
    if len(bars) != 4:
        raise RuntimeError(f"phases: expected 4 barriers in decode_pass, found {len(bars)}")
    # the count pass ends at the first barrier (one-class path) or the second
    # (general path); the full pass at the third, the outliers at the fourth
    for i, mark in reversed(list(zip(bars, (3, 3, 4, 5)))):
        lines.insert(i + 1, lines[i].replace("__syncthreads();", f"prof_mark({mark});"))
    src = src[:a] + "".join(lines) + src[b:]
    src = swap(src, PASS_START, "  if (threadIdx.x == 0) {\n    for (int i = 0; i < 16; ++i) "
               "prof_cycles[i] = 0;\n    prof_cycles[16] = clock64();\n  }\n" + PASS_START)
    src = swap(src, PASS_LOOP, '''    prof_mark(1);
    __syncthreads();
    prof_mark(2);
    decode_pass(a, s, L, cur, n_s);
    body(s0, n_s);
    prof_mark(7);
    if (threadIdx.x == 0) prof_cycles[8] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 16; ++i) atomicAdd(&g_prof[i], (unsigned long long)prof_cycles[i]);
''')
    return src + PROF_TAIL


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_c_profile: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.gbdi_fr import bf16_to_words, fit_fr_bases
    from repro_torch.kernels import _build
    from repro_torch.kernels import gbdi_encode as enc_mod
    from repro_torch.kernels import gbdi_paged_attn as pa_mod
    from repro_torch.serving.kv_cache import KV_FR

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    _build.compile_kernels()
    out_dir = _build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "gbdi_paged_attn.cu").read_text()
    procs = {}
    for name in ("phases", "no_decode", "no_attention"):
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(patched(src, name))
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"kernel": pa_mod._lib()}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{text}")
        lib = ctypes.CDLL(str(so))
        for fn in ("gbdi_paged_attn_launch", "gbdi_paged_attn_decode_launch"):
            getattr(lib, fn).argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                         ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib.gbdi_paged_attn_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
        libs[name] = lib

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def kv_data() -> torch.Tensor:
        ch = torch.randn(1, 1, N_KV, HD, generator=gen, device=dev) * 2
        return (ch + 0.1 * torch.randn(B, MAX_LEN, N_KV, HD, generator=gen, device=dev)).to(torch.bfloat16)

    ks, vs = kv_data(), kv_data()
    table = fit_fr_bases(bf16_to_words(torch.cat([ks[0, :32].reshape(-1), vs[0, :32].reshape(-1)])), KV_FR)

    def pages(x: torch.Tensor) -> dict[str, torch.Tensor]:
        blob = enc_mod.gbdi_encode(bf16_to_words(x).reshape(-1, KV_FR.page_words).contiguous(), table, KV_FR)
        return {k: v.reshape((B, -1) + v.shape[1:]) for k, v in blob.items()
                if k not in ("n_spilled", "n_dropped")}

    pk, pv = pages(ks), pages(vs)
    q = torch.randn(B, N_KV, GROUPS, HD, generator=gen, device=dev)
    pos = MAX_LEN - 2
    n_tok = (pos // 2) * 2
    qh = q.reshape(B, N_KV * GROUPS, 1, HD).to(torch.bfloat16)
    Kr = ks[:, :n_tok].permute(0, 2, 1, 3).contiguous()
    Vr = vs[:, :n_tok].permute(0, 2, 1, 3).contiguous()
    del ks, vs
    geom = dict(n_kv=N_KV, hd=HD, groups=GROUPS)

    def timed(fn, n: int = TIMING_REPEATS) -> tuple[float, float]:
        fn()
        times = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2], times[0]

    plain_lib = pa_mod._lib

    def attend(name: str):
        pa_mod._lib = lambda: libs[name]
        try:
            return pa_mod.paged_attention_decode(q, pk, pv, table, pos, KV_FR, **geom)
        finally:
            pa_mod._lib = plain_lib

    ip = pa_mod._launch_plan(KV_FR, B, pk["n_out"].shape[1], pos, dev, **geom)
    print(f"shape: B={B} Kv={N_KV} G={GROUPS} hd={HD}, {pos // 2} full pages a row; pass size "
          f"{ip[-1]}, splits {ip[-7]}, run {ip[-6]} slots, "
          f"{pa_mod._blocks_per_sm(KV_FR, N_KV, HD, GROUPS, 0)} block(s) an SM", flush=True)
    for name in ("kernel", "no_decode", "no_attention", "phases",
                 "phases", "no_attention", "no_decode", "kernel"):
        ms, lo = timed(lambda: attend(name))
        print(f"{name:13s} {ms:.4f} ms (median of {TIMING_REPEATS}, min {lo:.4f})", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, lo = timed(lambda: sdpa(qh, Kr, Vr, enable_gqa=True))
    print(f"{'sdpa':13s} {ms:.4f} ms (median of {TIMING_REPEATS}, min {lo:.4f}) over the same "
          f"{n_tok} tokens as a raw bf16 cache", flush=True)

    lib = libs["phases"]
    attend("phases")
    torch.cuda.synchronize()
    if lib.prof_reset() != 0:
        raise RuntimeError("prof_reset failed")
    attend("phases")
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 16)()
    if lib.prof_read(counts) != 0:
        raise RuntimeError("prof_read failed")
    passes = counts[8]
    total = sum(counts[i] for i in STEPS)
    print(f"cycles per pass (thread 0 of each block, {passes} passes in one launch):")
    for i, step in STEPS.items():
        print(f"  {step:24s} {counts[i] / passes:10.1f}  ({counts[i] / total:.3f})")
    print(f"  {'total':24s} {total / passes:10.1f}")
    print(smi.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
