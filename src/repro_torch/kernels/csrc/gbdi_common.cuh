// Shared device helpers for the GBDI-FR page kernels (sm_90a): constants,
// the encode's scan of chunk popcounts, asynchronous copies, and the page
// geometry the decode and paged-attention kernels read.
//
// In the encode one thread block owns one page.  Words are spread over the
// block as p = threadIdx.x + i * blockDim.x, so every warp covers one 32-word
// chunk of the page in page order, and a warp ballot gives that chunk's
// flags as one 32-bit mask.  A word's page-order rank among flagged words is
// then the exclusive prefix of the chunk popcounts plus a popcount inside
// its own chunk: the prefix rank the TPU kernel built with a Hillis-Steele
// scan.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gbdi {

constexpr int kThreads = 256;      // block size of the page kernels
constexpr int kMaxClasses = 5;     // width_set is a subset of {1, 2, 4, 8, 16}
constexpr int kMiscInts = 16;      // per-block scalars in shared memory
constexpr int kSmemLimit = 232448; // Hopper: 227 KB of dynamic shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

// Exclusive prefix of the chunk popcounts into prefix[0..n_chunks), total in
// prefix[n_chunks].  Syncs before (masks written) and after (prefix ready).
__device__ __forceinline__ void scan_chunks(const unsigned* masks, int* prefix, int n_chunks) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < n_chunks; base += 32) {
      const int c = base + lane;
      const int v = c < n_chunks ? __popc(masks[c]) : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (c < n_chunks) prefix[c] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) prefix[n_chunks] = carry;
  }
  __syncthreads();
}

// Asynchronous copies from device to shared memory (the decode and
// paged-attention kernels stage page blobs with them).
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A config's page geometry as the decode and paged-attention kernels read it.
struct PageGeom {
  const int* meta;  // caps[np*nc] | lane offsets[np*nc]
  int P, word_bits, num_bases, table_len, nc, np, ptr_bits, ptr_lanes, delta_lanes, outlier_cap;
  int widths[kMaxClasses];
};

// Number of leading iparams every page kernel reads (kernel_iparams in
// gbdi_encode.py): n_pages, page_words, word_bits, num_bases, table_len,
// num_classes, num_profiles, ptr_bits, ptr_lanes, delta_lanes, outlier_cap,
// drop_penalty_bits, widths[kMaxClasses].
constexpr int kPageParams = 12 + kMaxClasses;

inline PageGeom page_geom(const int* meta, const int* ip) {
  PageGeom g;
  g.meta = meta;
  g.P = ip[1];
  g.word_bits = ip[2];
  g.num_bases = ip[3];
  g.table_len = ip[4];
  g.nc = ip[5];
  g.np = ip[6];
  g.ptr_bits = ip[7];
  g.ptr_lanes = ip[8];
  g.delta_lanes = ip[9];
  g.outlier_cap = ip[10];
  for (int c = 0; c < kMaxClasses; ++c) g.widths[c] = ip[12 + c];
  return g;
}

}  // namespace gbdi
