// GBDI-FR v2 page encode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdi_encode.py
// (gbdi_encode_pallas / _encode_kernel).  Computes the same blob bit for bit
// as the plain version repro_torch.core.gbdi_fr.fr_encode: narrowest fitting
// base per word (first index wins ties), zero code, outlier candidates, the
// narrow -> wide bucket spill chain with page-order ranks, lane packing of
// every sub-stream and of the pointer codes, the outlier table with drops,
// and for adaptive configs the per-page profile with the lowest int32 probe
// cost drop_penalty_bits * n_dropped + 8 * bytes(profile), first id on ties.
//
// Bound: bytes.  A page is read once (4 B/word) and its blob written once;
// the work per word is k wrapping deltas and compares, below the card's
// integer rate.  One 256-thread block per page; thread t owns words
// t + 256 i (i < W, W = ceil(P / 256) rounded up to an instantiated size)
// for the whole kernel, so every warp covers one 32-word chunk of the page
// in page order at each i.
//
// Design, after kernel_a_profile.py (PERF.md) put the time of the first
// version in its base searches: a walk of the whole table per word,
// three dependent shared loads and a branch per entry, repeated for every
// word that overflowed its bucket; and 32 KB of shared memory a block for
// per-word state.
//
// 1. One search per word.  A pass over the table tests each entry with two
//    integer instructions and no branch: the word is pre-shifted to the top
//    of 32 bits (x << (32 - word_bits), which hoists the 16-bit recentre out
//    of the loop), an entry carries nb = (half - base) << s and lim = 2 half
//    << s (0 for dead and padded entries), and the delta fits its class iff
//    X + nb < lim as uint32.  Entries come 8 at a time as broadcast 16-byte
//    shared loads and are tested against all W words of the thread; each
//    block of 32 entries leaves a fit mask per word, and per-class entry
//    masks turn it into the word's first fitting base of every class (ffs).
//    A word keeps those (16 bits each) in registers, so the narrowest
//    fitting class above any class -- the first choice, and the next base of
//    a word that overflows its bucket -- is a lookup, the same rule as a
//    table walk: narrowest class, first index on ties, dead entries never.
// 2. The word's state in the registers of its thread: the word (shifted;
//    a 16-bit outlier's int32 value is read again from the page), its status (4
//    bits, eight words a register) and its fits (two classes a register;
//    configs of up to two classes get the one-register build).  Shared
//    memory keeps only what crosses threads: the table, chunk masks and
//    their prefix, and the packed delta lanes (kept fields are OR-ed into
//    their lane; fields are disjoint).  Pointer codes are packed across
//    lanes with shuffles.  2,680 B a block at the default 16-bit config,
//    against 31,332 B before; 48 registers a thread at W 8 under a bound
//    of 5 blocks an SM (40 warps), where the first version ran 6 blocks of
//    32 registers.
//
// The ranks are as before: a ballot per 32-word chunk and a one-warp scan
// of the chunk counts (gbdi_common.cuh), two barriers a class.  Adaptive
// configs first run the chain per profile counting only drops, then run it
// once more for the winner and emit.
//
// Host interface: plain C, loaded with ctypes (no PyTorch headers).

#include "gbdi_common.cuh"

// kernel_a_profile.py defines these in its instrumented copies
#ifndef ENC_STEP
#define ENC_PROF_START
#define ENC_STEP(k)
#define ENC_PROF_END
#endif
#ifndef ENC_NO_SPILL
#define ENC_NO_SPILL 0
#endif

namespace {

using namespace gbdi;

constexpr unsigned kNoFit = 0xFFFFu;  // no fitting base in a class
// a word's status, 4 bits: its class 0..nc-1, or one of these
constexpr int kZero = 8, kOut = 9, kPast = 10;  // kPast: a slot past the page
constexpr int kMaxWords = 65;  // words a thread: pages up to 16,640 words
// blocks an SM holds at least: caps a thread at 48 registers (W 8 then
// spills 48 bytes); of 3 (80 registers, unbounded), 4, 5 and 6 blocks, 5
// was the fastest on both codec streams (PERF.md)
constexpr int kMinBlocks = 5;

struct EncArgs {
  const int* x;
  const int* bases;   // table_len entries (padded table)
  const int* cls;     // width-class index per entry; num_classes = dead
  const int* meta;    // caps[np*nc] | lane offsets[np*nc] | 8*bytes[np]
  int* ptrs;
  int* deltas;
  int* out_vals;
  int* out_idx;
  int* n_out;
  int* n_spilled;
  int* n_dropped;
  int* profile;       // null for single-profile configs
  int n_pages, P, word_bits, num_bases, table_len, nc, np, ptr_bits, ptr_lanes,
      delta_lanes, outlier_cap, drop_penalty;
  int widths[kMaxClasses];
};

__host__ __device__ inline int entry_blocks(int table_len) { return (table_len + 31) / 32; }

// Dynamic shared memory, in carve order (ints): entries (nb, lim) x
// table_len, per-class entry masks of each 32-entry block, chunk masks,
// chunk prefix (+1 total), delta lanes, scalars.
__host__ __device__ inline size_t enc_smem_bytes(int P, int delta_lanes, int table_len) {
  const int chunks = P / 32;
  return 4u * static_cast<size_t>(2 * table_len + kMaxClasses * entry_blocks(table_len) +
                                  2 * chunks + 1 + delta_lanes + kMiscInts);
}

struct EncSmem {
  int* ent;        // (nb, lim) of each entry, 8-byte pairs
  unsigned* cmask; // [block * kMaxClasses + c]: entries of class c in a 32-entry block
  unsigned* masks;
  int* prefix;
  int* lanes;
  int* misc;       // [0]: spill count
};

__device__ inline EncSmem carve(int* smem, const EncArgs& a) {
  EncSmem s;
  s.ent = smem;
  s.cmask = reinterpret_cast<unsigned*>(s.ent + 2 * a.table_len);
  s.masks = s.cmask + kMaxClasses * entry_blocks(a.table_len);
  s.prefix = reinterpret_cast<int*>(s.masks + a.P / 32);
  s.lanes = s.prefix + a.P / 32 + 1;
  s.misc = s.lanes + a.delta_lanes;
  return s;
}

// Per-word registers of a thread's W words: the first fitting base of each
// class, 16 bits each, two a register (NF registers: one for up to two
// classes); the status of each word, 4 bits each, eight a register.
template <int W, int NF>
struct Words {
  static constexpr int kClasses = 2 * NF < kMaxClasses ? 2 * NF : kMaxClasses;
  static constexpr int kStRegs = (W + 7) / 8;
  unsigned X[W];         // the word, shifted to the top of 32 bits
  unsigned f[W][NF];
  unsigned st0[kStRegs];  // first class / status
  unsigned st[kStRegs];   // the chain's current class / status
};

// Word i's first fitting base of class c (kNoFit: none); c is a
// compile-time value wherever this is called, so the fits stay in registers.
template <int NF>
__device__ __forceinline__ unsigned fit_of(const unsigned (&f)[NF], int c) {
  return c < 2 * NF ? (f[c >> 1] >> ((c & 1) * 16)) & 0xFFFFu : kNoFit;
}

template <int N>
__device__ __forceinline__ int st_get(const unsigned (&r)[N], int i) {
  return (r[i >> 3] >> (4 * (i & 7))) & 0xF;
}

template <int N>
__device__ __forceinline__ void st_set(unsigned (&r)[N], int i, int v) {
  const int sh = 4 * (i & 7);
  r[i >> 3] = (r[i >> 3] & ~(0xFu << sh)) | (static_cast<unsigned>(v) << sh);
}

// The narrowest class above lo with a fitting base (first index on ties),
// or -1.
template <int NF>
__device__ __forceinline__ int next_class(const unsigned (&f)[NF], int lo, int nc) {
  int best = -1;
#pragma unroll
  for (int c = 2 * NF - 1; c >= 0; --c)
    if (c > lo && c < nc && fit_of<NF>(f, c) != kNoFit) best = c;
  return best;
}

// Every word's first fitting base of every class: one pass over the table.
template <int W, int NF>
__device__ __forceinline__ void search(const EncArgs& a, const EncSmem& s, Words<W, NF>& w) {
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int r = 0; r < NF; ++r) w.f[i][r] = 0xFFFFFFFFu;
  for (int jb = 0; jb < a.table_len; jb += 32) {
    unsigned fm[W];
#pragma unroll
    for (int i = 0; i < W; ++i) fm[i] = 0u;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (jb + 8 * g >= a.table_len) break;  // table_len is a multiple of 8
      const int4* e4 = reinterpret_cast<const int4*>(s.ent + 2 * (jb + 8 * g));
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int4 e = e4[h];  // entries 2h and 2h + 1 of the group: nb, lim, nb, lim
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (w.X[i] + static_cast<unsigned>(e.x) < static_cast<unsigned>(e.y))
            fm[i] |= 1u << (8 * g + 2 * h);
          if (w.X[i] + static_cast<unsigned>(e.z) < static_cast<unsigned>(e.w))
            fm[i] |= 1u << (8 * g + 2 * h + 1);
        }
      }
    }
    const unsigned* cm = s.cmask + (jb >> 5) * kMaxClasses;
#pragma unroll
    for (int c = 0; c < Words<W, NF>::kClasses; ++c) {
      if (c >= a.nc) break;
      const unsigned cmc = cm[c];
      const int sh = (c & 1) * 16;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const unsigned m = fm[i] & cmc;
        unsigned& r = w.f[i][c >> 1];
        if (m && ((r >> sh) & 0xFFFFu) == kNoFit)
          r &= ~((kNoFit ^ static_cast<unsigned>(jb + __ffs(m) - 1)) << sh);
      }
    }
  }
}

// Write the chunk masks of the words whose status is v.
template <int W, int NF>
__device__ __forceinline__ void ballot_status(const EncArgs& a, const EncSmem& s,
                                              const Words<W, NF>& w, int v) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i * kThreads >= a.P) break;
    const unsigned m = __ballot_sync(kFull, st_get(w.st, i) == v);
    if ((tid & 31) == 0 && i * kThreads + tid < a.P) s.masks[(i * kThreads + tid) >> 5] = m;
  }
}

// The spill chain of one profile from the words' first classes st0.
// Returns the page's total outlier count (block-uniform).  With emit,
// leaves the packed deltas in s.lanes, writes the outlier table to global
// memory and adds the spills to s.misc[0]; st ends as each word's final
// class or status.  A word's flag is balloted again after the scan rather
// than kept across its barriers.
template <int W, int NF>
__device__ int run_chain(const EncArgs& a, const EncSmem& s, int page, int prof, bool emit,
                         Words<W, NF>& w) {
  const int P = a.P, chunks = P / 32, tid = threadIdx.x, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int sh = 32 - a.word_bits;
#pragma unroll
  for (int r = 0; r < Words<W, NF>::kStRegs; ++r) w.st[r] = w.st0[r];
  if (emit) {
    for (int l = tid; l < a.delta_lanes; l += blockDim.x) s.lanes[l] = 0;
    __syncthreads();
  }
  int my_spill = 0;
  const int* caps = a.meta + prof * a.nc;
  const int* offs = a.meta + a.np * a.nc + prof * a.nc;

#pragma unroll
  for (int c = 0; c < Words<W, NF>::kClasses; ++c) {
    if (c >= a.nc) break;
    const int cap = caps[c], off = offs[c], wd = a.widths[c];
    const unsigned fmask = (1u << wd) - 1u, half = 1u << (wd - 1);
    ballot_status(a, s, w, c);
    scan_chunks(s.masks, s.prefix, chunks);
    ENC_STEP(2 + 2 * c);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i * kThreads >= P) break;
      const unsigned m = __ballot_sync(kFull, st_get(w.st, i) == c);
      if (!((m >> lane) & 1u)) continue;
      const int p = i * kThreads + tid;
      const int r = s.prefix[p >> 5] + __popc(m & lt);
      if (r < cap) {
        if (emit) {
          // x - base in the word's low bits: ((X + nb) >> sh) is x - base + half
          const unsigned nb = static_cast<unsigned>(s.ent[2 * fit_of<NF>(w.f[i], c)]);
          const unsigned field = (((w.X[i] + nb) >> sh) - half) & fmask;
          const int bit = r * wd;
          atomicOr(reinterpret_cast<unsigned*>(&s.lanes[off + (bit >> 5)]), field << (bit & 31));
        }
      } else {
        const int nxt = ENC_NO_SPILL ? -1 : next_class<NF>(w.f[i], c, a.nc);
        my_spill += nxt >= 0;
        st_set(w.st, i, nxt >= 0 ? nxt : kOut);
      }
    }
    ENC_STEP(3 + 2 * c);
  }

  // outlier compaction in page order; overflow is dropped
  ballot_status(a, s, w, kOut);
  scan_chunks(s.masks, s.prefix, chunks);
  const int total_out = s.prefix[chunks];
  if (emit) {
    const size_t obase = static_cast<size_t>(page) * a.outlier_cap;
    const int* xp = a.x + static_cast<size_t>(page) * P;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i * kThreads >= P) break;
      const unsigned m = __ballot_sync(kFull, st_get(w.st, i) == kOut);
      if (!((m >> lane) & 1u)) continue;
      const int p = i * kThreads + tid;
      const int r = s.prefix[p >> 5] + __popc(m & lt);
      if (r < a.outlier_cap) {
        // the whole int32 word: X itself for 32-bit words, else read again
        a.out_vals[obase + r] = sh == 0 ? static_cast<int>(w.X[i]) : xp[p];
        a.out_idx[obase + r] = p;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) my_spill += __shfl_xor_sync(kFull, my_spill, o);
    if (lane == 0 && my_spill) atomicAdd(&s.misc[0], my_spill);
  }
  __syncthreads();  // prefix and masks are free again; lanes and misc are final
  ENC_STEP(12);
  return total_out;
}

template <int W, int NF>
__global__ void __launch_bounds__(kThreads, kMinBlocks) encode_kernel(EncArgs a) {
  extern __shared__ __align__(16) int smem[];
  const EncSmem s = carve(smem, a);
  const int page = blockIdx.x, P = a.P, tid = threadIdx.x, lane = tid & 31;
  const int sh = 32 - a.word_bits;
  ENC_PROF_START

  // the page's words first, so their loads are in flight while the table
  // is staged
  Words<W, NF> w;
  const int* xp = a.x + static_cast<size_t>(page) * P;
  int x[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int p = i * kThreads + tid;
    x[i] = p < P ? xp[p] : 0;
  }

  // entries (nb, lim): delta x - base fits iff (x << sh) + nb < lim, uint32
  for (int j = tid; j < a.table_len; j += blockDim.x) {
    const int c = a.cls[j];
    const bool live = c >= 0 && c < a.nc;
    const unsigned half = live ? 1u << (a.widths[c] - 1) : 0u;
    s.ent[2 * j] = static_cast<int>((half - static_cast<unsigned>(a.bases[j])) << sh);
    s.ent[2 * j + 1] = static_cast<int>((2u * half) << sh);
  }
  for (int blk = tid >> 5; blk < entry_blocks(a.table_len); blk += blockDim.x >> 5) {
    const int j = blk * 32 + lane;
    const int c = j < a.table_len ? a.cls[j] : -1;
#pragma unroll
    for (int k = 0; k < kMaxClasses; ++k) {
      const unsigned m = __ballot_sync(kFull, c == k && k < a.nc);
      if (lane == 0) s.cmask[blk * kMaxClasses + k] = m;
    }
  }
  if (tid == 0) s.misc[0] = 0;
  __syncthreads();
  ENC_STEP(0);

  // one search per word: its first fitting base of every class; then its
  // first class (the narrowest with a fit), zero, or outlier
#pragma unroll
  for (int r = 0; r < Words<W, NF>::kStRegs; ++r) w.st0[r] = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    w.X[i] = static_cast<unsigned>(x[i]) << sh;
    st_set(w.st0, i, i * kThreads + tid >= P ? kPast : (x[i] == 0 ? kZero : kOut));
  }
  search<W, NF>(a, s, w);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int c = next_class<NF>(w.f[i], -1, a.nc);
    if (st_get(w.st0, i) == kOut && c >= 0) st_set(w.st0, i, c);
  }
  ENC_STEP(1);

  // adaptive configs: cost every profile by its drops, keep the cheapest
  int pid = 0;
  if (a.np > 1) {
    const int* cost8 = a.meta + 2 * a.np * a.nc;
    int best = 0;
    for (int q = 0; q < a.np; ++q) {
      const int tot = run_chain<W, NF>(a, s, page, q, false, w);
      const int dropped = tot > a.outlier_cap ? tot - a.outlier_cap : 0;
      const int cost = static_cast<int>(static_cast<unsigned>(a.drop_penalty) *
                                            static_cast<unsigned>(dropped) +
                                        static_cast<unsigned>(cost8[q]));
      if (q == 0 || cost < best) {
        best = cost;
        pid = q;
      }
    }
  }
  const int total_out = run_chain<W, NF>(a, s, page, pid, true, w);
  const int n_out = total_out < a.outlier_cap ? total_out : a.outlier_cap;

  // codes (zero / outlier / selected base), packed across the lanes of a
  // warp: the per = 32 / ptr_bits words of one ptr lane sit in consecutive
  // lanes (per and ptr_bits are powers of two)
  const int zero_code = a.num_bases, outlier_code = a.num_bases + 1;
  const int per = 32 / a.ptr_bits, log_per = 31 - __clz(per);
  const int sub = lane & (per - 1);
  int* pp = a.ptrs + static_cast<size_t>(page) * a.ptr_lanes;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i * kThreads >= P) break;
    const int p = i * kThreads + tid, v = st_get(w.st, i);
    unsigned code = v == kZero ? zero_code : outlier_code;
#pragma unroll
    for (int c = 0; c < Words<W, NF>::kClasses; ++c)
      if (v == c) code = fit_of<NF>(w.f[i], c);
    unsigned lane_v = code << (sub * a.ptr_bits);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      if (o < per) lane_v |= __shfl_xor_sync(kFull, lane_v, o);
    if (p < P && sub == 0) pp[p >> log_per] = static_cast<int>(lane_v);
  }
  ENC_STEP(13);

  int* dp = a.deltas + static_cast<size_t>(page) * a.delta_lanes;
  for (int l = tid; l < a.delta_lanes; l += blockDim.x) dp[l] = s.lanes[l];
  const size_t obase = static_cast<size_t>(page) * a.outlier_cap;
  for (int r = n_out + tid; r < a.outlier_cap; r += blockDim.x) {
    a.out_vals[obase + r] = 0;
    a.out_idx[obase + r] = 0;
  }
  if (tid == 0) {
    a.n_out[page] = n_out;
    a.n_spilled[page] = s.misc[0];
    a.n_dropped[page] = total_out - n_out;
    if (a.profile) a.profile[page] = pid;
  }
  ENC_STEP(14);
  ENC_PROF_END;
}

// iparams: n_pages, page_words, word_bits, num_bases, table_len, num_classes,
//          num_profiles, ptr_bits, ptr_lanes, delta_lanes, outlier_cap,
//          drop_penalty_bits, widths[5]
// ptrs:    x, bases, cls, meta, ptrs, deltas, out_vals, out_idx, n_out,
//          n_spilled, n_dropped, profile
EncArgs unpack(const long long* ptr, const int* ip) {
  EncArgs a;
  a.x = reinterpret_cast<const int*>(ptr[0]);
  a.bases = reinterpret_cast<const int*>(ptr[1]);
  a.cls = reinterpret_cast<const int*>(ptr[2]);
  a.meta = reinterpret_cast<const int*>(ptr[3]);
  a.ptrs = reinterpret_cast<int*>(ptr[4]);
  a.deltas = reinterpret_cast<int*>(ptr[5]);
  a.out_vals = reinterpret_cast<int*>(ptr[6]);
  a.out_idx = reinterpret_cast<int*>(ptr[7]);
  a.n_out = reinterpret_cast<int*>(ptr[8]);
  a.n_spilled = reinterpret_cast<int*>(ptr[9]);
  a.n_dropped = reinterpret_cast<int*>(ptr[10]);
  a.profile = reinterpret_cast<int*>(ptr[11]);
  a.n_pages = ip[0];
  a.P = ip[1];
  a.word_bits = ip[2];
  a.num_bases = ip[3];
  a.table_len = ip[4];
  a.nc = ip[5];
  a.np = ip[6];
  a.ptr_bits = ip[7];
  a.ptr_lanes = ip[8];
  a.delta_lanes = ip[9];
  a.outlier_cap = ip[10];
  a.drop_penalty = ip[11];
  for (int c = 0; c < kMaxClasses; ++c) a.widths[c] = ip[12 + c];
  return a;
}

using Kernel = void (*)(EncArgs);

template <int NF>
Kernel kernel_for_words(int P) {
  const int w = (P + kThreads - 1) / kThreads;
  if (w <= 1) return encode_kernel<1, NF>;
  if (w <= 2) return encode_kernel<2, NF>;
  if (w <= 4) return encode_kernel<4, NF>;
  if (w <= 8) return encode_kernel<8, NF>;
  if (w <= 16) return encode_kernel<16, NF>;
  if (w <= 32) return encode_kernel<32, NF>;
  if (w <= kMaxWords) return encode_kernel<kMaxWords, NF>;
  return nullptr;
}

// The instantiation whose W holds a page's words at 256 a step and whose
// fit registers hold its classes, or null.
Kernel kernel_for(int P, int nc) {
  return nc <= 2 ? kernel_for_words<1>(P) : kernel_for_words<(kMaxClasses + 1) / 2>(P);
}

// 0, -1 (no fit in shared memory) or -2 (a page past 16,640 words)
int check(const EncArgs& a, size_t smem) {
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (!kernel_for(a.P, a.nc)) return -2;
  return 0;
}

}  // namespace

extern "C" long long gbdi_encode_smem_bytes(const int* ip) {
  return static_cast<long long>(enc_smem_bytes(ip[1], ip[9], ip[4]));
}

// Blocks one SM holds at once (registers and shared memory both counted),
// or a negative code as gbdi_encode_launch.
extern "C" int gbdi_encode_blocks_per_sm(const int* ip) {
  EncArgs a = {};
  a.P = ip[1];
  a.nc = ip[5];
  const size_t smem = enc_smem_bytes(ip[1], ip[9], ip[4]);
  const int rc = check(a, smem);
  if (rc) return rc;
  const Kernel k = kernel_for(a.P, a.nc);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e) - 100;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e) - 100;
}

// Returns 0, a cudaError_t, or a negative code as check() above.
extern "C" int gbdi_encode_launch(const long long* ptr, const int* ip, void* stream) {
  const EncArgs a = unpack(ptr, ip);
  const size_t smem = enc_smem_bytes(a.P, a.delta_lanes, a.table_len);
  const int rc = check(a, smem);
  if (rc) return rc;
  if (a.n_pages == 0) return 0;
  const Kernel k = kernel_for(a.P, a.nc);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<a.n_pages, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
