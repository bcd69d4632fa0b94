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
// The per-page body is gbdi::decode_page, which the paged-attention kernel
// shares.
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
  int* out;
  int n_pages;
  PageGeom g;
};

__global__ void __launch_bounds__(kThreads) decode_kernel(DecArgs a) {
  extern __shared__ int smem[];
  const PageGeom& g = a.g;
  const DecodeSmem s = carve_decode_smem(smem, g);
  const int page = blockIdx.x;
  for (int j = threadIdx.x; j < g.table_len; j += blockDim.x) {
    s.bases[j] = a.bases[j];
    s.cls[j] = a.cls[j];
  }
  const size_t obase = static_cast<size_t>(page) * g.outlier_cap;
  int* op = a.out + static_cast<size_t>(page) * g.P;
  decode_page(g, s, a.ptrs + static_cast<size_t>(page) * g.ptr_lanes,
              a.deltas + static_cast<size_t>(page) * g.delta_lanes, a.out_vals + obase,
              a.out_idx + obase, a.n_out[page], a.profile ? a.profile[page] : 0,
              [op](int p, int w) { op[p] = w; });
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
  a.out = reinterpret_cast<int*>(ptr[9]);
  a.n_pages = ip[0];
  a.g = page_geom(reinterpret_cast<const int*>(ptr[8]), ip);
  return a;
}

}  // namespace

extern "C" long long gbdi_decode_smem_bytes(const int* ip) {
  return static_cast<long long>(decode_smem_bytes(ip[1], ip[9], ip[4]));
}

// Returns 0, a cudaError_t, or -1 when the page does not fit shared memory.
extern "C" int gbdi_decode_launch(const long long* ptr, const int* ip, void* stream) {
  const DecArgs a = unpack(ptr, ip);
  const size_t smem = decode_smem_bytes(a.g.P, a.g.delta_lanes, a.g.table_len);
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (a.n_pages == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_kernel<<<a.n_pages, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
