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
// the work per word is k wrapping deltas and compares, far below the card's
// integer rate.  Design: one 256-thread block per page, everything between
// the page read and the blob write stays in shared memory.  Ranks come from
// warp ballots + popcounts over 32-word chunks and one warp-level scan of the
// chunk counts (gbdi_common.cuh); kept payloads are OR-ed straight into their
// packed lane in shared memory (fields are disjoint, so the order of the
// atomics does not matter), replacing the TPU's one-hot multiply-reduce
// compaction with a real scatter.  The delta to every base is not stored:
// a word that overflows its bucket recomputes its next base from the table.
// Adaptive configs first run the chain per profile counting only drops, then
// run it once more for the winner and emit.
//
// Host interface: plain C, loaded with ctypes (no PyTorch headers).

#include "gbdi_common.cuh"

namespace {

using namespace gbdi;

enum : unsigned char { kZero = 0, kActive = 1, kOut = 2 };

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

struct EncSmem {
  int* x;
  int* sel0;
  int* sel;
  unsigned* masks;
  int* prefix;
  int* lanes;
  int* bases;
  int* cls;
  int* misc;          // [0, nc): half spans; [8]: spill count
  unsigned char* st0;
  unsigned char* st;
};

__host__ __device__ inline size_t enc_smem_bytes(int P, int delta_lanes, int table_len) {
  const int chunks = P / 32;
  return 4u * static_cast<size_t>(3 * P + 2 * chunks + 1 + delta_lanes + 2 * table_len +
                                  kMiscInts) +
         2u * static_cast<size_t>(P);
}

__device__ inline EncSmem carve(int* smem, const EncArgs& a) {
  EncSmem s;
  const int P = a.P, chunks = a.P / 32;
  s.x = smem;
  s.sel0 = s.x + P;
  s.sel = s.sel0 + P;
  s.masks = reinterpret_cast<unsigned*>(s.sel + P);
  s.prefix = reinterpret_cast<int*>(s.masks + chunks);
  s.lanes = s.prefix + chunks + 1;
  s.bases = s.lanes + a.delta_lanes;
  s.cls = s.bases + a.table_len;
  s.misc = s.cls + a.table_len;
  s.st0 = reinterpret_cast<unsigned char*>(s.misc + kMiscInts);
  s.st = s.st0 + P;
  return s;
}

// Narrowest fitting base whose class is above `lo` (first index on ties),
// or -1: argmin over the per-base cost with dead entries never fitting.
__device__ inline int best_base(const EncArgs& a, const EncSmem& s, int x, int lo) {
  int best_c = a.nc, best_j = -1;
  for (int j = 0; j < a.table_len; ++j) {
    const int c = s.cls[j];
    if (c <= lo || c >= best_c) continue;
    const int m = magnitude(wrapped_delta(x, s.bases[j], a.word_bits));
    if (m < s.misc[c]) {
      best_c = c;
      best_j = j;
    }
  }
  return best_j;
}

// The spill chain of one profile.  Returns the page's total outlier count
// (block-uniform).  With emit, writes the packed deltas into s.lanes, the
// outlier table to global memory and the spill count into s.misc[8].
__device__ int run_chain(const EncArgs& a, const EncSmem& s, int page, int prof, bool emit) {
  const int P = a.P, chunks = P / 32, tid = threadIdx.x;
  for (int p = tid; p < P; p += blockDim.x) {
    s.sel[p] = s.sel0[p];
    s.st[p] = s.st0[p];
  }
  if (emit)
    for (int l = tid; l < a.delta_lanes; l += blockDim.x) s.lanes[l] = 0;
  int my_spill = 0;
  const int* caps = a.meta + prof * a.nc;
  const int* offs = a.meta + a.np * a.nc + prof * a.nc;

  for (int c = 0; c < a.nc; ++c) {
    const int cap = caps[c], off = offs[c], w = a.widths[c];
    const unsigned fmask = (1u << w) - 1u;
    __syncthreads();  // previous readers of masks are done, state is visible
    for (int p = tid; p < P; p += blockDim.x)
      ballot_chunk(s.masks, p, s.st[p] == kActive && s.cls[s.sel[p]] == c);
    scan_chunks(s.masks, s.prefix, chunks);
    for (int p = tid; p < P; p += blockDim.x) {
      if (!flag_of(s.masks, p)) continue;
      const int r = rank_of(s.masks, s.prefix, p);
      if (r < cap) {
        if (emit) {
          const unsigned field =
              static_cast<unsigned>(wrapped_delta(s.x[p], s.bases[s.sel[p]], a.word_bits)) & fmask;
          const int bit = r * w;
          atomicOr(reinterpret_cast<unsigned*>(&s.lanes[off + (bit >> 5)]), field << (bit & 31));
        }
      } else {
        const int alt = best_base(a, s, s.x[p], c);
        if (alt >= 0) {
          s.sel[p] = alt;
          ++my_spill;
        } else {
          s.st[p] = kOut;
        }
      }
    }
  }

  // outlier compaction in page order; overflow is dropped
  __syncthreads();
  for (int p = tid; p < P; p += blockDim.x) ballot_chunk(s.masks, p, s.st[p] == kOut);
  scan_chunks(s.masks, s.prefix, chunks);
  const int total_out = s.prefix[chunks];
  if (emit) {
    const size_t obase = static_cast<size_t>(page) * a.outlier_cap;
    for (int p = tid; p < P; p += blockDim.x) {
      if (!flag_of(s.masks, p)) continue;
      const int r = rank_of(s.masks, s.prefix, p);
      if (r < a.outlier_cap) {
        a.out_vals[obase + r] = s.x[p];
        a.out_idx[obase + r] = p;
      }
    }
    if (my_spill) atomicAdd(&s.misc[8], my_spill);
  }
  __syncthreads();
  return total_out;
}

__global__ void __launch_bounds__(kThreads) encode_kernel(EncArgs a) {
  extern __shared__ int smem[];
  const EncSmem s = carve(smem, a);
  const int page = blockIdx.x, P = a.P, tid = threadIdx.x;

  for (int j = tid; j < a.table_len; j += blockDim.x) {
    s.bases[j] = a.bases[j];
    s.cls[j] = a.cls[j];
  }
  if (tid < a.nc) s.misc[tid] = 1 << (a.widths[tid] - 1);
  if (tid == 0) s.misc[8] = 0;
  __syncthreads();

  // per-word assignment: zero word, narrowest fitting base, or outlier
  const int* xp = a.x + static_cast<size_t>(page) * P;
  for (int p = tid; p < P; p += blockDim.x) {
    const int x = xp[p];
    s.x[p] = x;
    int sel = 0;
    unsigned char st = kZero;
    if (x != 0) {
      const int j = best_base(a, s, x, -1);
      st = j >= 0 ? kActive : kOut;
      sel = j >= 0 ? j : 0;
    }
    s.sel0[p] = sel;
    s.st0[p] = st;
  }
  __syncthreads();

  // adaptive configs: cost every profile by its drops, keep the cheapest
  int pid = 0;
  if (a.np > 1) {
    const int* cost8 = a.meta + 2 * a.np * a.nc;
    int best = 0;
    for (int q = 0; q < a.np; ++q) {
      const int tot = run_chain(a, s, page, q, false);
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
  const int total_out = run_chain(a, s, page, pid, true);
  const int n_out = total_out < a.outlier_cap ? total_out : a.outlier_cap;

  // codes: zero / outlier / selected base
  const int zero_code = a.num_bases, outlier_code = a.num_bases + 1;
  for (int p = tid; p < P; p += blockDim.x) {
    const unsigned char st = s.st[p];
    s.sel[p] = st == kZero ? zero_code : (st == kOut ? outlier_code : s.sel[p]);
  }
  __syncthreads();

  const int per = 32 / a.ptr_bits;
  int* pp = a.ptrs + static_cast<size_t>(page) * a.ptr_lanes;
  for (int l = tid; l < a.ptr_lanes; l += blockDim.x) {
    unsigned v = 0;
    for (int q = 0; q < per; ++q)
      v |= static_cast<unsigned>(s.sel[l * per + q]) << (q * a.ptr_bits);
    pp[l] = static_cast<int>(v);
  }
  int* dp = a.deltas + static_cast<size_t>(page) * a.delta_lanes;
  for (int l = tid; l < a.delta_lanes; l += blockDim.x) dp[l] = s.lanes[l];
  const size_t obase = static_cast<size_t>(page) * a.outlier_cap;
  for (int r = n_out + tid; r < a.outlier_cap; r += blockDim.x) {
    a.out_vals[obase + r] = 0;
    a.out_idx[obase + r] = 0;
  }
  if (tid == 0) {
    a.n_out[page] = n_out;
    a.n_spilled[page] = s.misc[8];
    a.n_dropped[page] = total_out - n_out;
    if (a.profile) a.profile[page] = pid;
  }
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

}  // namespace

extern "C" long long gbdi_encode_smem_bytes(const int* ip) {
  return static_cast<long long>(enc_smem_bytes(ip[1], ip[9], ip[4]));
}

// Returns 0, a cudaError_t, or -1 when the page does not fit shared memory.
extern "C" int gbdi_encode_launch(const long long* ptr, const int* ip, void* stream) {
  const EncArgs a = unpack(ptr, ip);
  const size_t smem = enc_smem_bytes(a.P, a.delta_lanes, a.table_len);
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (a.n_pages == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_kernel<<<a.n_pages, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
