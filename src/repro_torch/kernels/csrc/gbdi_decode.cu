// GBDI-FR v2 page decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdi_decode.py
// (gbdi_decode_pallas / _decode_kernel).  Computes the same words bit for bit
// as the plain version repro_torch.core.gbdi_fr.fr_decode: unpack the pointer
// codes, look up each word's base and width class, recompute the encoder's
// page-order rank per class and read the field at that rank (clipped to the
// bucket) with sign extension, add the base (16-bit words masked to
// [0, 65535]), send the zero code and slot-less outlier codes to 0, and add
// every live outlier slot (< n_out) back at its index.  Adaptive configs
// read the page's profile id to pick the class caps and lane offsets.
//
// Bound: bytes.  The blob is read once and the page written once (4 B/word).
// Design: one 256-thread block per page; the page's delta lanes are staged
// in shared memory with coalesced loads, ranks come from warp ballots over
// 32-word chunks (gbdi_common.cuh), and the base lookup and outlier
// scatter-back are plain indexed reads and writes, where the TPU kernel
// needed one-hot multiply-reduces for lack of dynamic gather and scatter.
//
// Host interface: plain C, loaded with ctypes (no PyTorch headers).

#include "gbdi_common.cuh"

namespace {

using namespace gbdi;

struct DecArgs {
  const int* ptrs;
  const int* deltas;
  const int* out_vals;
  const int* out_idx;
  const int* n_out;
  const int* profile;  // null for single-profile configs
  const int* bases;    // table_len entries (padded table)
  const int* cls;
  const int* meta;     // caps[np*nc] | lane offsets[np*nc]
  int* out;
  int n_pages, P, word_bits, num_bases, table_len, nc, np, ptr_bits, ptr_lanes, delta_lanes,
      outlier_cap;
  int widths[kMaxClasses];
};

__host__ __device__ inline size_t dec_smem_bytes(int P, int delta_lanes, int table_len) {
  const int chunks = P / 32;
  return 4u * static_cast<size_t>(3 * P + 2 * chunks + 1 + delta_lanes + 2 * table_len +
                                  kMiscInts) +
         static_cast<size_t>(P);
}

__global__ void __launch_bounds__(kThreads) decode_kernel(DecArgs a) {
  extern __shared__ int smem[];
  const int P = a.P, chunks = P / 32, tid = threadIdx.x, page = blockIdx.x;
  int* s_code = smem;
  int* s_val = s_code + P;
  int* s_contrib = s_val + P;
  unsigned* s_masks = reinterpret_cast<unsigned*>(s_contrib + P);
  int* s_prefix = reinterpret_cast<int*>(s_masks + chunks);
  int* s_lanes = s_prefix + chunks + 1;
  int* s_bases = s_lanes + a.delta_lanes;
  int* s_cls = s_bases + a.table_len;
  unsigned char* s_isout = reinterpret_cast<unsigned char*>(s_cls + a.table_len + kMiscInts);

  for (int j = tid; j < a.table_len; j += blockDim.x) {
    s_bases[j] = a.bases[j];
    s_cls[j] = a.cls[j];
  }
  const int* dp = a.deltas + static_cast<size_t>(page) * a.delta_lanes;
  for (int l = tid; l < a.delta_lanes; l += blockDim.x) s_lanes[l] = dp[l];
  const int* pp = a.ptrs + static_cast<size_t>(page) * a.ptr_lanes;
  const unsigned cmask = (1u << a.ptr_bits) - 1u;
  for (int p = tid; p < P; p += blockDim.x) {
    const int bit = p * a.ptr_bits;
    s_code[p] = static_cast<int>((static_cast<unsigned>(pp[bit >> 5]) >> (bit & 31)) & cmask);
    s_val[p] = 0;
    s_contrib[p] = 0;
    s_isout[p] = 0;
  }
  // a profile id outside the table matches no layout: every delta stays 0
  const int pid = a.profile ? a.profile[page] : 0;
  const bool pid_ok = pid >= 0 && pid < a.np;
  __syncthreads();

  if (pid_ok) {
    const int* caps = a.meta + pid * a.nc;
    const int* offs = a.meta + a.np * a.nc + pid * a.nc;
    for (int c = 0; c < a.nc; ++c) {
      const int cap = caps[c], off = offs[c], w = a.widths[c];
      if (cap == 0) continue;
      const unsigned fmask = (1u << w) - 1u;
      const int half = 1 << (w - 1);
      __syncthreads();
      for (int p = tid; p < P; p += blockDim.x) {
        const int code = s_code[p];
        ballot_chunk(s_masks, p, code < a.num_bases && s_cls[code] == c);
      }
      scan_chunks(s_masks, s_prefix, chunks);
      for (int p = tid; p < P; p += blockDim.x) {
        if (!flag_of(s_masks, p)) continue;
        int r = rank_of(s_masks, s_prefix, p);
        r = r < cap ? r : cap - 1;
        const int bit = r * w;
        const int field = static_cast<int>(
            (static_cast<unsigned>(s_lanes[off + (bit >> 5)]) >> (bit & 31)) & fmask);
        s_val[p] = field >= half ? field - (1 << w) : field;
      }
    }
  }
  __syncthreads();

  const int zero_code = a.num_bases, outlier_code = a.num_bases + 1;
  for (int p = tid; p < P; p += blockDim.x) {
    const int code = s_code[p];
    int v = 0;
    if (code != zero_code && code != outlier_code) {
      const int bc = code < a.num_bases ? code : a.num_bases - 1;
      unsigned u = static_cast<unsigned>(s_bases[bc]) + static_cast<unsigned>(s_val[p]);
      if (a.word_bits == 16) u &= 0xFFFFu;
      v = static_cast<int>(u);
    }
    s_val[p] = v;
  }
  // live outlier slots add their value back at their index
  const size_t obase = static_cast<size_t>(page) * a.outlier_cap;
  const int live = a.n_out[page];
  for (int r = tid; r < a.outlier_cap; r += blockDim.x) {
    if (r >= live) continue;
    const int idx = a.out_idx[obase + r];
    if (idx < 0 || idx >= P) continue;
    atomicAdd(&s_contrib[idx], a.out_vals[obase + r]);
    s_isout[idx] = 1;
  }
  __syncthreads();

  int* op = a.out + static_cast<size_t>(page) * P;
  for (int p = tid; p < P; p += blockDim.x) op[p] = s_isout[p] ? s_contrib[p] : s_val[p];
}

// iparams: n_pages, page_words, word_bits, num_bases, table_len, num_classes,
//          num_profiles, ptr_bits, ptr_lanes, delta_lanes, outlier_cap,
//          (unused), widths[5]
// ptrs:    ptrs, deltas, out_vals, out_idx, n_out, profile, bases, cls, meta, out
DecArgs unpack(const long long* ptr, const int* ip) {
  DecArgs a;
  a.ptrs = reinterpret_cast<const int*>(ptr[0]);
  a.deltas = reinterpret_cast<const int*>(ptr[1]);
  a.out_vals = reinterpret_cast<const int*>(ptr[2]);
  a.out_idx = reinterpret_cast<const int*>(ptr[3]);
  a.n_out = reinterpret_cast<const int*>(ptr[4]);
  a.profile = reinterpret_cast<const int*>(ptr[5]);
  a.bases = reinterpret_cast<const int*>(ptr[6]);
  a.cls = reinterpret_cast<const int*>(ptr[7]);
  a.meta = reinterpret_cast<const int*>(ptr[8]);
  a.out = reinterpret_cast<int*>(ptr[9]);
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
  for (int c = 0; c < kMaxClasses; ++c) a.widths[c] = ip[12 + c];
  return a;
}

}  // namespace

extern "C" long long gbdi_decode_smem_bytes(const int* ip) {
  return static_cast<long long>(dec_smem_bytes(ip[1], ip[9], ip[4]));
}

// Returns 0, a cudaError_t, or -1 when the page does not fit shared memory.
extern "C" int gbdi_decode_launch(const long long* ptr, const int* ip, void* stream) {
  const DecArgs a = unpack(ptr, ip);
  const size_t smem = dec_smem_bytes(a.P, a.delta_lanes, a.table_len);
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (a.n_pages == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_kernel<<<a.n_pages, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
