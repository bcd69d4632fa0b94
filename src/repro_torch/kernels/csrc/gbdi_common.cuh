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

constexpr int kThreads = 256;      // block size of the page kernels
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

// ---------------------------------------------------------------------------
// One page's decode, shared by the decode kernel (gbdi_decode.cu) and the
// paged-attention kernel (gbdi_paged_attn.cu).
// ---------------------------------------------------------------------------

// A config's page geometry as the decode reads it.
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

// The decode's shared-memory planes; the caller stages the padded table
// into `bases`/`cls` once per block.
struct DecodeSmem {
  int* code;
  int* val;
  int* contrib;
  unsigned* masks;
  int* prefix;
  int* lanes;
  int* bases;
  int* cls;
  unsigned char* isout;
};

__host__ __device__ inline size_t decode_smem_bytes(int P, int delta_lanes, int table_len) {
  const int chunks = P / 32;
  return 4u * static_cast<size_t>(3 * P + 2 * chunks + 1 + delta_lanes + 2 * table_len +
                                  kMiscInts) +
         static_cast<size_t>(P);
}

__device__ inline DecodeSmem carve_decode_smem(int* smem, const PageGeom& g) {
  DecodeSmem s;
  const int chunks = g.P / 32;
  s.code = smem;
  s.val = s.code + g.P;
  s.contrib = s.val + g.P;
  s.masks = reinterpret_cast<unsigned*>(s.contrib + g.P);
  s.prefix = reinterpret_cast<int*>(s.masks + chunks);
  s.lanes = s.prefix + chunks + 1;
  s.bases = s.lanes + g.delta_lanes;
  s.cls = s.bases + g.table_len;
  s.isout = reinterpret_cast<unsigned char*>(s.cls + g.table_len + kMiscInts);
  return s;
}

// Decode one page (the same words, bit for bit, as fr_decode) and hand word
// p to emit(p, word); every thread of the block calls it.  It syncs first,
// so the planes may be reused straight after a previous call, and the
// caller syncs before reading what emit wrote.  A profile id outside the
// table matches no layout: every delta stays 0.
template <class Emit>
__device__ void decode_page(const PageGeom& g, const DecodeSmem& s, const int* ptrs,
                            const int* deltas, const int* out_vals, const int* out_idx,
                            int n_out, int pid, Emit emit) {
  const int P = g.P, chunks = P / 32, tid = threadIdx.x;
  __syncthreads();
  for (int l = tid; l < g.delta_lanes; l += blockDim.x) s.lanes[l] = deltas[l];
  const unsigned cmask = (1u << g.ptr_bits) - 1u;
  for (int p = tid; p < P; p += blockDim.x) {
    const int bit = p * g.ptr_bits;
    s.code[p] = static_cast<int>((static_cast<unsigned>(ptrs[bit >> 5]) >> (bit & 31)) & cmask);
    s.val[p] = 0;
    s.contrib[p] = 0;
    s.isout[p] = 0;
  }
  const bool pid_ok = pid >= 0 && pid < g.np;
  __syncthreads();

  if (pid_ok) {
    const int* caps = g.meta + pid * g.nc;
    const int* offs = g.meta + g.np * g.nc + pid * g.nc;
    for (int c = 0; c < g.nc; ++c) {
      const int cap = caps[c], off = offs[c], w = g.widths[c];
      if (cap == 0) continue;
      const unsigned fmask = (1u << w) - 1u;
      const int half = 1 << (w - 1);
      __syncthreads();
      for (int p = tid; p < P; p += blockDim.x) {
        const int code = s.code[p];
        ballot_chunk(s.masks, p, code < g.num_bases && s.cls[code] == c);
      }
      scan_chunks(s.masks, s.prefix, chunks);
      for (int p = tid; p < P; p += blockDim.x) {
        if (!flag_of(s.masks, p)) continue;
        int r = rank_of(s.masks, s.prefix, p);
        r = r < cap ? r : cap - 1;
        const int bit = r * w;
        const int field = static_cast<int>(
            (static_cast<unsigned>(s.lanes[off + (bit >> 5)]) >> (bit & 31)) & fmask);
        s.val[p] = field >= half ? field - (1 << w) : field;
      }
    }
  }
  __syncthreads();

  const int zero_code = g.num_bases, outlier_code = g.num_bases + 1;
  for (int p = tid; p < P; p += blockDim.x) {
    const int code = s.code[p];
    int v = 0;
    if (code != zero_code && code != outlier_code) {
      const int bc = code < g.num_bases ? code : g.num_bases - 1;
      unsigned u = static_cast<unsigned>(s.bases[bc]) + static_cast<unsigned>(s.val[p]);
      if (g.word_bits == 16) u &= 0xFFFFu;
      v = static_cast<int>(u);
    }
    s.val[p] = v;
  }
  // live outlier slots add their value back at their index
  for (int r = tid; r < g.outlier_cap; r += blockDim.x) {
    if (r >= n_out) continue;
    const int idx = out_idx[r];
    if (idx < 0 || idx >= P) continue;
    atomicAdd(&s.contrib[idx], out_vals[r]);
    s.isout[idx] = 1;
  }
  __syncthreads();

  for (int p = tid; p < P; p += blockDim.x) emit(p, s.isout[p] ? s.contrib[p] : s.val[p]);
}

}  // namespace gbdi
