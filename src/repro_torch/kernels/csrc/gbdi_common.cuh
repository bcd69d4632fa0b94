// Shared device helpers for the GBDI-FR page kernels (sm_90a).
//
// One thread block owns one page.  Words are spread over the block as
// p = threadIdx.x + i * blockDim.x, so every warp covers one 32-word chunk of
// the page in page order, and a warp ballot gives that chunk's flags as one
// 32-bit mask.  A word's page-order rank among flagged words is then the
// exclusive prefix of the chunk popcounts plus a popcount inside its own
// chunk: the prefix rank the TPU kernel built with a Hillis-Steele scan.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gbdi {

constexpr int kThreads = 256;      // block size of both kernels
constexpr int kMaxClasses = 5;     // width_set is a subset of {1, 2, 4, 8, 16}
constexpr int kMiscInts = 16;      // per-block scalars in shared memory
constexpr int kSmemLimit = 232448; // Hopper: 227 KB of dynamic shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

// Signed wrapping delta x - base in the word's width: uint32 arithmetic,
// then the 16-bit recentre ((d + 2^15) & 0xFFFF) - 2^15, then reinterpret.
__device__ __forceinline__ int wrapped_delta(int x, int base, int word_bits) {
  unsigned d = static_cast<unsigned>(x) - static_cast<unsigned>(base);
  if (word_bits == 16) d = ((d + 0x8000u) & 0xFFFFu) - 0x8000u;
  return static_cast<int>(d);
}

// m such that d fits a w-bit field iff m < 2^(w-1); max(d, ~d) is -d-1 for
// negative d and cannot overflow at INT_MIN.
__device__ __forceinline__ int magnitude(int d) { return d > ~d ? d : ~d; }

// Write the ballot mask of one 32-word chunk (all lanes of the warp call it).
__device__ __forceinline__ void ballot_chunk(unsigned* masks, int p, bool flag) {
  unsigned m = __ballot_sync(kFull, flag);
  if ((threadIdx.x & 31) == 0) masks[p >> 5] = m;
}

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

__device__ __forceinline__ bool flag_of(const unsigned* masks, int p) {
  return (masks[p >> 5] >> (p & 31)) & 1u;
}

__device__ __forceinline__ int rank_of(const unsigned* masks, const int* prefix, int p) {
  return prefix[p >> 5] + __popc(masks[p >> 5] & ((1u << (p & 31)) - 1u));
}

}  // namespace gbdi
