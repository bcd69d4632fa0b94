// Decode attention straight over GBDI-FR compressed K/V pages, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdi_paged_attn.py
// (paged_attention_decode / _kernel / _decode_words) and serves for its XLA
// twin src/repro/kernels/xla.py (_paged_attn) as well.  For every batch row,
// kv head and query group it returns the un-normalised flash-decoding state
// (acc, m, l) in float32 over the FULL pages of the cache: tokens at or past
// (pos / pt) * pt are masked, and the caller attends over the raw tail and
// merges the two streams with merge_softmax.  The plain version is
// repro_torch.kernels.gbdi_paged_attn.paged_attention_decode_plain.
//
// Bound: bytes and operations about evenly.  Each K and V page blob is
// read once (3,588 B of int32 lanes for the default KV page of 2,048 bf16
// words), and a decoded page costs 4 float32 operations per (query head,
// token, channel) plus the decode's integer work: at the serving shape
// (8 x 128 query heads, 32K tokens) 0.28 ms of bytes against 0.32 ms of
// operations on an H100.  The pages never round-trip through device
// memory in decoded form.
//
// Design: kernel 1 runs a grid of (splits, B) blocks; each block walks a
// contiguous run of page slots of one batch row.  The next slot's K and V
// blobs are copied into shared memory asynchronously (cp.async) while the
// block works on the current one.  Per slot it decodes the K page, then
// the V page, into shared memory as float32 (gbdi::decode_page,
// the same body as the decode kernel), forms q.K for every (kv, group,
// token) with one warp per (kv, group) row, updates the running (m, l)
// with one thread per (kv, group), and rescales and accumulates acc with
// the block's threads spread over (kv, group, channel).  q and acc stay in
// shared memory for the whole run (64 KB each at 128 query heads of 128
// channels), so no page is decoded more than once.  That is ~176 KB of
// shared memory at the serving shape, so one block runs per SM, and it has
// 1,024 threads so that 32 warps hide the decode's memory latency.  Slots
// at or past pos / pt hold no valid token and are skipped.  Blocks run in
// no order, so each writes its partial (acc, m, l); kernel 2 merges the
// splits with the merge_softmax identity.  Masking uses -1e30 and p = 0
// where a score is <= -1e29, so an empty run merges as (acc, m, l) =
// (0, -1e30, 0).
//
// Host interface: plain C, loaded with ctypes (no PyTorch headers).

#include "gbdi_common.cuh"

namespace {

using namespace gbdi;

constexpr float kMasked = -1e30f;
constexpr float kMaskedGuard = -1e29f;
constexpr int kAttnThreads = 1024;
constexpr int kMergeThreads = 128;

struct BlobPtrs {
  const int* ptrs;     // (B, S, ptr_lanes)
  const int* deltas;   // (B, S, delta_lanes)
  const int* out_vals; // (B, S, outlier_cap)
  const int* out_idx;
  const int* n_out;    // (B, S)
  const int* profile;  // (B, S), null for single-profile configs
};

struct AttnArgs {
  PageGeom g;
  const float* q;  // (B, n_kv, groups, hd)
  BlobPtrs k, v;
  const int* bases;  // table_len entries (padded table)
  const int* cls;
  float* part_acc;  // (B, splits, n_kv * groups, hd)
  float* part_m;    // (B, splits, n_kv * groups)
  float* part_l;
  float* acc;  // (B, n_kv, groups, hd)
  float* m;    // (B, n_kv, groups)
  float* l;
  int B, S, n_valid, splits, run, n_kv, groups, hd, pt;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// ints of one staged page blob: ptrs | deltas | out_vals | out_idx | n_out | profile
__host__ __device__ inline int blob_ints(int ptr_lanes, int delta_lanes, int outlier_cap) {
  return ptr_lanes + delta_lanes + 2 * outlier_cap + 2;
}

__host__ __device__ inline size_t attn_smem_bytes(int P, int ptr_lanes, int delta_lanes,
                                                  int outlier_cap, int table_len, int kg, int hd,
                                                  int pt) {
  return align16(decode_smem_bytes(P, delta_lanes, table_len)) +
         4u * (2 * static_cast<size_t>(P) + 2 * static_cast<size_t>(kg) * hd + 4 * kg +
               static_cast<size_t>(kg) * pt +
               4 * static_cast<size_t>(blob_ints(ptr_lanes, delta_lanes, outlier_cap)));
}

struct AttnSmem {
  DecodeSmem dec;
  float* kf;     // decoded K page, (pt, n_kv, hd)
  float* vf;     // decoded V page
  float* q;      // (kg, hd)
  float* acc;    // (kg, hd)
  float* m;      // (kg)
  float* l;
  float* alpha;
  float* p;      // (kg, pt): scores, then probabilities
  int* kv_of;    // (kg): the kv head of each (kv, group) row
  int* stage;    // two slots' K and V blobs, filled by asynchronous copies
};

__device__ AttnSmem carve(int* smem, const AttnArgs& a) {
  AttnSmem s;
  s.dec = carve_decode_smem(smem, a.g);
  float* f = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                      align16(decode_smem_bytes(a.g.P, a.g.delta_lanes,
                                                                a.g.table_len)));
  const int kg = a.n_kv * a.groups;
  s.kf = f;
  s.vf = s.kf + a.g.P;
  s.q = s.vf + a.g.P;
  s.acc = s.q + kg * a.hd;
  s.m = s.acc + kg * a.hd;
  s.l = s.m + kg;
  s.alpha = s.l + kg;
  s.p = s.alpha + kg;
  s.kv_of = reinterpret_cast<int*>(s.p + kg * a.pt);
  s.stage = s.kv_of + kg;
  return s;
}

// a bf16 word (the low 16 bits) as the float32 it widens to, exactly
__device__ __forceinline__ float bf16_word(int w) {
  return __uint_as_float(static_cast<unsigned>(w) << 16);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying one page's blob into shared memory (ptrs | deltas |
// out_vals | out_idx | n_out | profile, the profile 0 for single-profile
// configs), so the next slot's loads overlap this slot's work.
__device__ void stage_page(const PageGeom& g, const BlobPtrs& f, size_t page, int* dst) {
  const int o_dl = g.ptr_lanes, o_ov = o_dl + g.delta_lanes, o_oi = o_ov + g.outlier_cap,
            o_n = o_oi + g.outlier_cap;
  for (int i = threadIdx.x; i < o_n; i += blockDim.x) {
    const int* src = i < o_dl   ? f.ptrs + page * g.ptr_lanes + i
                     : i < o_ov ? f.deltas + page * g.delta_lanes + (i - o_dl)
                     : i < o_oi ? f.out_vals + page * g.outlier_cap + (i - o_ov)
                                : f.out_idx + page * g.outlier_cap + (i - o_oi);
    cp_async4(dst + i, src);
  }
  if (threadIdx.x == 0) {
    cp_async4(dst + o_n, f.n_out + page);
    if (f.profile) {
      cp_async4(dst + o_n + 1, f.profile + page);
    } else {
      dst[o_n + 1] = 0;
    }
  }
}

// Decode a staged page into dst as float32; the copies must have landed and
// the block synced.
__device__ __forceinline__ void decode_staged(const PageGeom& g, const DecodeSmem& s,
                                              const int* st, float* dst) {
  const int o_dl = g.ptr_lanes, o_ov = o_dl + g.delta_lanes, o_oi = o_ov + g.outlier_cap,
            o_n = o_oi + g.outlier_cap;
  decode_page(g, s, st, st + o_dl, st + o_ov, st + o_oi, st[o_n], st[o_n + 1],
              [dst](int p, int w) { dst[p] = bf16_word(w); });
}

__global__ void __launch_bounds__(kAttnThreads) attn_kernel(AttnArgs a) {
  extern __shared__ int smem[];
  const AttnSmem s = carve(smem, a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int b = blockIdx.y, split = blockIdx.x;
  const int kg = a.n_kv * a.groups, kgh = kg * a.hd, row = a.n_kv * a.hd, pt = a.pt;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.hd));

  for (int j = tid; j < a.g.table_len; j += blockDim.x) {
    s.dec.bases[j] = a.bases[j];
    s.dec.cls[j] = a.cls[j];
  }
  const float* qb = a.q + static_cast<size_t>(b) * kgh;
  for (int o = tid; o < kgh; o += blockDim.x) {
    s.q[o] = qb[o];
    s.acc[o] = 0.f;
  }
  for (int j = tid; j < kg; j += blockDim.x) {
    s.m[j] = kMasked;
    s.l[j] = 0.f;
    s.kv_of[j] = j / a.groups;
  }
  // this thread's first (row, channel) of the accumulator, and the step to
  // its next one: no division inside the slot loop
  const int hg0 = tid / a.hd, h0 = tid - hg0 * a.hd;
  const int dhg = blockDim.x / a.hd, dh = blockDim.x - dhg * a.hd;

  const int first = split * a.run;
  const int last = min(a.n_valid, first + a.run);
  const int bi = blob_ints(a.g.ptr_lanes, a.g.delta_lanes, a.g.outlier_cap);
  const size_t row0 = static_cast<size_t>(b) * a.S;
  if (first < last) {
    stage_page(a.g, a.k, row0 + first, s.stage);
    stage_page(a.g, a.v, row0 + first, s.stage + bi);
    cp_async_commit();
  }
  for (int slot = first; slot < last; ++slot) {
    // every thread finished reading the other buffer (the previous slot's
    // decode) behind the barriers since, so it can take the next slot
    const int* cur = s.stage + ((slot - first) & 1) * 2 * bi;
    if (slot + 1 < last) {
      int* nxt = s.stage + ((slot + 1 - first) & 1) * 2 * bi;
      stage_page(a.g, a.k, row0 + slot + 1, nxt);
      stage_page(a.g, a.v, row0 + slot + 1, nxt + bi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    decode_staged(a.g, s.dec, cur, s.kf);
    decode_staged(a.g, s.dec, cur + bi, s.vf);
    __syncthreads();

    // scores: one warp per (kv, group) row and its tokens, lanes over channels
    for (int hg = warp; hg < kg; hg += n_warps) {
      const float* qr = s.q + hg * a.hd;
      const float* kr = s.kf + s.kv_of[hg] * a.hd;
      for (int t = 0; t < pt; ++t, kr += row) {
        float dot = 0.f;
        for (int h = lane; h < a.hd; h += 32) dot = fmaf(qr[h], kr[h], dot);
#pragma unroll
        for (int o = 16; o; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
        if (lane == 0) s.p[hg * pt + t] = dot * scale;
      }
    }
    __syncthreads();

    // online softmax: one thread per (kv, group)
    for (int hg = tid; hg < kg; hg += blockDim.x) {
      float* lg = s.p + hg * pt;
      float mx = kMasked;
      for (int t = 0; t < pt; ++t) mx = fmaxf(mx, lg[t]);
      const float m_prev = s.m[hg], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < pt; ++t) {
        const float e = lg[t] <= kMaskedGuard ? 0.f : expf(lg[t] - m_new);
        lg[t] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      s.alpha[hg] = alpha;
      s.m[hg] = m_new;
      s.l[hg] = s.l[hg] * alpha + sum;
    }
    __syncthreads();

    // acc = acc * alpha + p . V, threads over (kv, group, channel)
    for (int o = tid, hg = hg0, h = h0; o < kgh; o += blockDim.x) {
      const float* pr = s.p + hg * pt;
      const float* vr = s.vf + s.kv_of[hg] * a.hd + h;
      float acc = s.acc[o] * s.alpha[hg];
      for (int t = 0; t < pt; ++t) acc = fmaf(pr[t], vr[t * row], acc);
      s.acc[o] = acc;
      hg += dhg;
      h += dh;
      if (h >= a.hd) {
        h -= a.hd;
        ++hg;
      }
    }
  }
  __syncthreads();

  const size_t part = static_cast<size_t>(b) * a.splits + split;
  for (int o = tid; o < kgh; o += blockDim.x) a.part_acc[part * kgh + o] = s.acc[o];
  for (int j = tid; j < kg; j += blockDim.x) {
    a.part_m[part * kg + j] = s.m[j];
    a.part_l[part * kg + j] = s.l[j];
  }
}

// One block per (batch row, kv, group): the merge_softmax identity over the
// row's splits.  All-masked splits carry (0, -1e30, 0), so a row with no
// valid token ends as m = -1e30, l = 0, acc = 0 exactly.
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(AttnArgs a) {
  const int kg = a.n_kv * a.groups;
  const int r = blockIdx.x, b = r / kg, hg = r - b * kg;
  const size_t first = static_cast<size_t>(b) * a.splits;
  float m = kMasked;
  for (int sp = 0; sp < a.splits; ++sp) m = fmaxf(m, a.part_m[(first + sp) * kg + hg]);
  float l = 0.f;
  for (int sp = 0; sp < a.splits; ++sp) {
    const size_t j = (first + sp) * kg + hg;
    l += a.part_l[j] * expf(a.part_m[j] - m);
  }
  for (int h = threadIdx.x; h < a.hd; h += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const size_t j = (first + sp) * kg + hg;
      acc += a.part_acc[j * a.hd + h] * expf(a.part_m[j] - m);
    }
    a.acc[static_cast<size_t>(r) * a.hd + h] = acc;
  }
  if (threadIdx.x == 0) {
    a.m[r] = m;
    a.l[r] = l;
  }
}

BlobPtrs blob_ptrs(const long long* ptr) {
  BlobPtrs f;
  f.ptrs = reinterpret_cast<const int*>(ptr[0]);
  f.deltas = reinterpret_cast<const int*>(ptr[1]);
  f.out_vals = reinterpret_cast<const int*>(ptr[2]);
  f.out_idx = reinterpret_cast<const int*>(ptr[3]);
  f.n_out = reinterpret_cast<const int*>(ptr[4]);
  f.profile = reinterpret_cast<const int*>(ptr[5]);
  return f;
}

// iparams: the kPageParams page parameters, then B, S, n_valid, splits, run,
//          n_kv, groups, hd, pt
// ptrs:    q, K blob (ptrs, deltas, out_vals, out_idx, n_out, profile),
//          V blob (the same six), bases, cls, meta, part_acc, part_m,
//          part_l, acc, m, l
AttnArgs unpack(const long long* ptr, const int* ip) {
  AttnArgs a;
  a.q = reinterpret_cast<const float*>(ptr[0]);
  a.k = blob_ptrs(ptr + 1);
  a.v = blob_ptrs(ptr + 7);
  a.bases = reinterpret_cast<const int*>(ptr[13]);
  a.cls = reinterpret_cast<const int*>(ptr[14]);
  a.g = page_geom(reinterpret_cast<const int*>(ptr[15]), ip);
  a.part_acc = reinterpret_cast<float*>(ptr[16]);
  a.part_m = reinterpret_cast<float*>(ptr[17]);
  a.part_l = reinterpret_cast<float*>(ptr[18]);
  a.acc = reinterpret_cast<float*>(ptr[19]);
  a.m = reinterpret_cast<float*>(ptr[20]);
  a.l = reinterpret_cast<float*>(ptr[21]);
  const int* x = ip + kPageParams;
  a.B = x[0];
  a.S = x[1];
  a.n_valid = x[2];
  a.splits = x[3];
  a.run = x[4];
  a.n_kv = x[5];
  a.groups = x[6];
  a.hd = x[7];
  a.pt = x[8];
  return a;
}

size_t smem_of(const int* ip) {
  const int* x = ip + kPageParams;
  return attn_smem_bytes(ip[1], ip[8], ip[9], ip[10], ip[4], x[5] * x[6], x[7], x[8]);
}

}  // namespace

extern "C" long long gbdi_paged_attn_smem_bytes(const int* ip) {
  return static_cast<long long>(smem_of(ip));
}

// Returns 0, a cudaError_t, or -1 when a block does not fit shared memory.
extern "C" int gbdi_paged_attn_launch(const long long* ptr, const int* ip, void* stream) {
  const AttnArgs a = unpack(ptr, ip);
  const size_t smem = smem_of(ip);
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (a.B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_kernel<<<dim3(a.splits, a.B), kAttnThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<<<a.B * a.n_kv * a.groups, kMergeThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
