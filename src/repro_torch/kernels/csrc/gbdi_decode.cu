// GBDI-FR v2 page decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gbdi_decode.py
// (gbdi_decode_pallas, pl.pallas_call at :148).  Computes the same words bit
// for bit as the plain version repro_torch.core.gbdi_fr.fr_decode, on any
// blob of the right shapes: unpack the pointer codes, look up each word's
// base and width class, recompute the encoder's page-order rank per class
// and read the field at that rank (clipped to the bucket) with sign
// extension, add the base (16-bit words masked to [0, 65535]), send the
// zero and outlier codes to 0 and codes past them to the last base, and
// put at every page index of a live outlier slot (< n_out) the int32 sum of
// its live values, unmasked.  Adaptive configs read the page's profile id
// to pick the class caps and lane offsets; an id outside the table gives
// every field 0.
//
// Bound: bytes.  The blob is read once and the page written once (4 B a
// word, 70 % of the bytes at the default 16-bit config).
//
// What held the first design back (kernel_b_profile.py on it, PERF.md): one
// 256-thread block per page and about 28,500 cycles a page.  39-44 % of
// them waited at the barrier after the blob's loads (a block held only one
// page's loads in flight); the ballot pass and one-warp scan of chunk
// counts of each class, with their barriers, took 20-21 %; every word went
// through four shared planes (codes, deltas, outlier sums, flags), zeroed
// for every page, and left with a 4-byte store; the table was staged again
// for every page.
//
// Design.  One warp decodes one page at a time (a block of up to 4 warps
// loops over pages; the grid holds one wave of the occupancy query).
//   * The warp stages its page's blob (ptr and delta lanes, outlier
//     indices and values) in its own shared memory with cp.async, 16 bytes
//     a copy where aligned, so all of a page's loads are in flight at once.
//   * It walks the page's 128-word groups in page order, 4 consecutive
//     words a lane, carrying each class's running count in registers: no
//     count pass, no block barrier, and each staged word read once.  (Kernel
//     C's pass decode spreads a page's groups over warps and so needs a
//     count pass and barriers.)
//   * Per group: one shared load gives the lane's 4 codes; one 8-byte
//     table load per word gives base and class (the table, staged once per
//     block, has an entry for every code of pointers up to 8 bits, so no
//     clamp).  A word's rank is its class's running count, plus the class's
//     words of lower lanes (four ballots), plus its own lower words; a
//     warp scan of the lanes' class counts, packed 16 bits a class, timed
//     no faster at two classes.  The field comes from the staged
//     delta lanes through the page's class table (cap - 1, offset, width;
//     a class with no field reads a zero lane, so no branch), is
//     sign-extended by two shifts and added to the base; the 4 words leave
//     as one 16-byte store, the same for 16- and 32-bit words.  A word
//     lives in registers from its code to its store and is written once.
//   * Outliers: per page the warp sets a bitmap of the live in-page
//     indices and, where the live indices rise strictly (as the encoder
//     writes them), the slot of each 32 bits' first set bit (a warp scan).
//     A word whose bit is set then takes its slot's value inside the same
//     group step.  Any other blob (repeated or falling indices) takes a
//     plain path: the sum of the live values at the word's index.
//   * 64 registers a thread under __launch_bounds__(128, 8), chosen by
//     timing copies of 6, 8, 10, 12 and 16 blocks an SM
//     (kernel_b_profile.py --min-blocks): fewer registers spill.
//
// Host interface: plain C, loaded with ctypes (no PyTorch headers).

#include <algorithm>

#include "gbdi_common.cuh"

// kernel_b_profile.py defines these in its instrumented copies
#ifndef DEC_STEP
#define DEC_PROF_START
#define DEC_STEP(k)
#define DEC_PROF_PAGE
#define DEC_PROF_END
#endif
// the __launch_bounds__ minimum of blocks an SM (kernel_b_profile.py times others)
#ifndef DEC_MIN_BLOCKS
#define DEC_MIN_BLOCKS 8
#endif

namespace {

using namespace gbdi;

constexpr int kMaxWarps = 4;  // warps of a block (fewer where a page's blob is large)
constexpr int kGroupWords = 128;  // words of a group: 4 a lane

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

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Shared memory.  A block: the code table as (base, class) pairs, an entry
// for every code where pointers have at most 8 bits (else a base's own
// entry, one for the zero and outlier codes, one for the codes past them),
// then the profiles' caps and lane offsets, 16-byte aligned.  Then per warp: the
// outlier bitmap as (32 bits, slot of the first) pairs, the page's class
// table ((cap - 1, lane offset, width, 32 - width) per class, then one for
// words with no field that reads a zero lane), that zero lane, and the
// staged blob (ptr lanes, delta lanes, outlier indices, outlier values),
// each part 16-byte aligned.
struct DecLayout {
  int fixed_ints, warp_ints, o_ct, o_zero, o_ptr, o_dl, o_oi, o_ov;
};

// Entries of the code table.
__host__ __device__ inline int tab_len(int num_bases, int ptr_bits) {
  return ptr_bits <= 8 ? 1 << ptr_bits : num_bases + 2;
}

__host__ __device__ inline DecLayout dec_layout(int P, int num_bases, int nc, int np, int ptr_bits,
                                                int ptr_lanes, int delta_lanes, int cap) {
  DecLayout L;
  L.fixed_ints = align4(2 * tab_len(num_bases, ptr_bits) + 2 * np * nc);
  L.o_ct = 2 * (P / 32);
  L.o_zero = L.o_ct + 4 * (kMaxClasses + 1);
  L.o_ptr = L.o_zero + 4;
  L.o_dl = L.o_ptr + align4(ptr_lanes);
  L.o_oi = L.o_dl + align4(delta_lanes);
  L.o_ov = L.o_oi + align4(cap);
  L.warp_ints = L.o_ov + align4(cap);
  return L;
}

// Warps a block: as many as fit shared memory, at most kMaxWarps (0: none fits).
__host__ __device__ inline int dec_warps(const DecLayout& L) {
  const long long room = kSmemLimit / 4 - L.fixed_ints;
  const long long w = room > 0 ? room / L.warp_ints : 0;
  return static_cast<int>(w < kMaxWarps ? w : kMaxWarps);
}

// Shared memory of a block (one warp's, past the limit, where none fits).
__host__ __device__ inline size_t dec_smem_bytes(const DecLayout& L) {
  const int w = dec_warps(L);
  return 4u * (static_cast<size_t>(L.fixed_ints) + static_cast<size_t>(w > 0 ? w : 1) * L.warp_ints);
}

// The table entry of a pointer code past 8 bits (as fr_decode clips the code).
__device__ __forceinline__ int tab_index(int code, int nb) {
  return code < nb ? code : code <= nb + 1 ? nb : nb + 1;
}

// Start copying n ints from src to dst with the warp's lanes: 16-byte
// copies where src is 16-byte aligned and n a multiple of 4, else 4-byte.
__device__ __forceinline__ void stage_warp(int* dst, const int* src, int n, int lane) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = lane; e < n >> 2; e += 32) cp_async16(dst + 4 * e, src + 4 * e);
  } else {
    for (int e = lane; e < n; e += 32) cp_async4(dst + e, src + e);
  }
}

// NC: the config's number of width classes, so that every per-class value
// stays in a register.
template <int NC>
__global__ void __launch_bounds__(kMaxWarps * 32, DEC_MIN_BLOCKS) decode_kernel(DecArgs a) {
  extern __shared__ __align__(16) int smem[];
  DEC_PROF_START;
  const PageGeom& g = a.g;
  const int P = g.P, nb = g.num_bases, b = g.ptr_bits, cap_out = g.outlier_cap;
  const int tid = threadIdx.x, lane = tid & 31, warps = blockDim.x >> 5;
  const DecLayout L = dec_layout(P, nb, NC, g.np, b, g.ptr_lanes, g.delta_lanes, cap_out);
  const int n_tab = tab_len(nb, b);
  int2* tab = reinterpret_cast<int2*>(smem);
  int* meta = smem + 2 * n_tab;
  int* ws = smem + L.fixed_ints + (tid >> 5) * L.warp_ints;
  uint2* bm = reinterpret_cast<uint2*>(ws);
  int4* ct = reinterpret_cast<int4*>(ws + L.o_ct);
  const int* sp = ws + L.o_ptr;
  const int* sd = ws + L.o_dl;
  const int* soi = ws + L.o_oi;
  const int* sov = ws + L.o_ov;

  for (int j = tid; j < n_tab; j += blockDim.x) {
    // entry j: code j, or past 8-bit pointers code nb + 2 for every code past nb + 1
    const int code = b <= 8 || j <= nb ? j : nb + 2;
    int base = 0, c = NC;  // the zero and outlier codes: 0, no class
    if (code < nb) {
      base = a.bases[code];
      c = a.cls[code] >= 0 && a.cls[code] < NC ? a.cls[code] : NC;
    } else if (code > nb + 1) {
      base = a.bases[nb - 1];  // codes past the outlier code: the last base
    }
    tab[j] = make_int2(base, c);
  }
  for (int j = tid; j < 2 * g.np * NC; j += blockDim.x) meta[j] = g.meta[j];
  if (lane == 0) ws[L.o_zero] = 0;
  __syncthreads();
  DEC_STEP(0);

  const int bm_words = P / 32;
  const unsigned cmask = (1u << b) - 1u, lt = (1u << lane) - 1u;
  const unsigned wmask = g.word_bits == 16 ? 0xFFFFu : 0xFFFFFFFFu;
  const int groups = P / kGroupWords;
  for (int page = blockIdx.x * warps + (tid >> 5); page < a.n_pages; page += gridDim.x * warps) {
    const size_t pg = static_cast<size_t>(page);
    stage_warp(ws + L.o_ptr, a.ptrs + pg * g.ptr_lanes, g.ptr_lanes, lane);
    stage_warp(ws + L.o_dl, a.deltas + pg * g.delta_lanes, g.delta_lanes, lane);
    stage_warp(ws + L.o_oi, a.out_idx + pg * cap_out, cap_out, lane);
    stage_warp(ws + L.o_ov, a.out_vals + pg * cap_out, cap_out, lane);
    cp_async_commit();
    int* out = a.out + pg * P;

    // the page's class table from its profile; a class with cap 0, words
    // of no class and every word of a profile id outside the table read
    // their field from the zero lane
    const int pid = a.profile ? __ldg(a.profile + page) : 0;
    const int live = min(max(__ldg(a.n_out + page), 0), cap_out);
    if (lane <= NC) {
      int w = 1;
#pragma unroll
      for (int c = 0; c < NC; ++c) w = lane == c ? g.widths[c] : w;
      const bool ok = lane < NC && pid >= 0 && pid < g.np;
      const int cap = ok ? meta[pid * NC + lane] : 0;
      ct[lane] = cap > 0 ? make_int4(cap - 1, meta[g.np * NC + pid * NC + lane], w, 32 - w)
                         : make_int4(0, L.o_zero - L.o_dl, 1, 31);
    }
    for (int i = lane; i < bm_words; i += 32) bm[i].x = 0;
    cp_async_wait<0>();
    __syncwarp();
    DEC_STEP(1);

    // live outlier slots: the bitmap of their in-page indices, whether the
    // indices rise strictly, and how many lie below the page
    bool rising = true;
    int below = 0;
    for (int r = lane; r < live; r += 32) {
      const int i = soi[r];
      if (r + 1 < live) rising = rising && i < soi[r + 1];
      if (i >= 0 && i < P) atomicOr(&bm[i >> 5].x, 1u << (i & 31));
      below += i < 0;
    }
    rising = __all_sync(kFull, rising);
    below = __reduce_add_sync(kFull, below);
    __syncwarp();
    if (rising && live > 0) {
      // the slot of each bitmap word's first set bit: the live slots below
      // the page, plus the set bits of the earlier words
      int carry = below;
      for (int i0 = 0; i0 < bm_words; i0 += 32) {
        const int i = i0 + lane;
        const int n = i < bm_words ? __popc(bm[i].x) : 0;
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        if (i < bm_words) bm[i].y = static_cast<unsigned>(carry + incl - n);
        carry += __shfl_sync(kFull, incl, 31);
      }
      __syncwarp();
    }
    int run[NC];  // each class's words in the page's earlier groups
#pragma unroll
    for (int c = 0; c < NC; ++c) run[c] = 0;
    DEC_STEP(2);

    for (int grp = 0; grp < groups; ++grp) {
      const int p0 = grp * kGroupWords + 4 * lane;
      // the lane's 4 codes: ptr_bits divides 32, so they lie in one ptr
      // lane or, at 16 bits, fill two
      const int bit0 = p0 * b;
      int t[4];  // table entries
      if (b <= 8) {
        const unsigned bits = static_cast<unsigned>(sp[bit0 >> 5]) >> (bit0 & 31);
#pragma unroll
        for (int k = 0; k < 4; ++k) t[k] = static_cast<int>((bits >> (k * b)) & cmask);
      } else {
        const unsigned lo = static_cast<unsigned>(sp[bit0 >> 5]);
        const unsigned hi = static_cast<unsigned>(sp[(bit0 >> 5) + 1]);
        t[0] = tab_index(static_cast<int>(lo & 0xFFFFu), nb);
        t[1] = tab_index(static_cast<int>(lo >> 16), nb);
        t[2] = tab_index(static_cast<int>(hi & 0xFFFFu), nb);
        t[3] = tab_index(static_cast<int>(hi >> 16), nb);
      }
      int2 e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = tab[t[k]];
      DEC_STEP(3);

      // rank of each word within its class, in page order: the running
      // count, the class's words of lower lanes (four ballots), the lane's
      // own lower words
      int r[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const bool f0 = e[0].y == c, f1 = e[1].y == c, f2 = e[2].y == c, f3 = e[3].y == c;
        const unsigned b0 = __ballot_sync(kFull, f0), b1 = __ballot_sync(kFull, f1),
                       b2 = __ballot_sync(kFull, f2), b3 = __ballot_sync(kFull, f3);
        int n = run[c] + __popc(b0 & lt) + __popc(b1 & lt) + __popc(b2 & lt) + __popc(b3 & lt);
        if (f0) r[0] = n;
        n += f0;
        if (f1) r[1] = n;
        n += f1;
        if (f2) r[2] = n;
        n += f2;
        if (f3) r[3] = n;
        run[c] += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
      }
      DEC_STEP(4);

      // base + sign-extended field: the field to the top of the word, then
      // an arithmetic shift back
      unsigned v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int4 c = ct[e[k].y];  // cap - 1, lane offset, width, 32 - width
        const int bit = min(r[k], c.x) * c.z;
        const unsigned lane_bits = static_cast<unsigned>(sd[c.y + (bit >> 5)]);
        const int field = static_cast<int>(lane_bits << (c.w - (bit & 31))) >> c.w;
        v[k] = (static_cast<unsigned>(e[k].x) + static_cast<unsigned>(field)) & wmask;
      }
      DEC_STEP(5);

      // outlier positions take their slot's value (or the sum at the index)
      const uint2 ow = bm[grp * 4 + (lane >> 3)];
      const int sh = (lane & 7) * 4;
      const unsigned mine = (ow.x >> sh) & 0xFu;
      if (mine) {
        if (rising) {
          int s = static_cast<int>(ow.y) + __popc(ow.x & ((1u << sh) - 1u));
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if ((mine >> k) & 1u) v[k] = static_cast<unsigned>(sov[s++]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!((mine >> k) & 1u)) continue;
            unsigned sum = 0;
            for (int x = 0; x < live; ++x)
              if (soi[x] == p0 + k) sum += static_cast<unsigned>(sov[x]);
            v[k] = sum;
          }
        }
      }
      DEC_STEP(6);
      *reinterpret_cast<int4*>(out + p0) = make_int4(static_cast<int>(v[0]), static_cast<int>(v[1]),
                                                     static_cast<int>(v[2]), static_cast<int>(v[3]));
      DEC_STEP(7);
    }
    DEC_PROF_PAGE;
    // the next page's copies and bitmap overwrite what every lane has read
    __syncwarp();
  }
  DEC_PROF_END;
}

using Kernel = void (*)(DecArgs);

Kernel kernel_for(int nc) {
  switch (nc) {
    case 1: return decode_kernel<1>;
    case 2: return decode_kernel<2>;
    case 3: return decode_kernel<3>;
    case 4: return decode_kernel<4>;
    case 5: return decode_kernel<5>;
    default: return nullptr;
  }
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

DecLayout layout_of(const int* ip) {
  return dec_layout(ip[1], ip[3], ip[5], ip[6], ip[7], ip[8], ip[9], ip[10]);
}

// The kernel for the config with its shared memory set, or null with rc:
// -1 when not one warp's blob fits shared memory, -2 for no instantiation,
// else the cudaError_t.
Kernel prepare(const int* ip, const DecLayout& L, int* rc) {
  *rc = 0;
  if (dec_warps(L) < 1) {
    *rc = -1;
    return nullptr;
  }
  const Kernel k = kernel_for(ip[5]);
  if (!k) {
    *rc = -2;
    return nullptr;
  }
  const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(dec_smem_bytes(L)));
  if (e != cudaSuccess) {
    *rc = static_cast<int>(e);
    return nullptr;
  }
  return k;
}

}  // namespace

extern "C" long long gbdi_decode_smem_bytes(const int* ip) {
  return static_cast<long long>(dec_smem_bytes(layout_of(ip)));
}

// Blocks one SM holds at once (registers and shared memory both counted),
// or a negative code as gbdi_decode_launch.
extern "C" int gbdi_decode_blocks_per_sm(const int* ip) {
  const DecLayout L = layout_of(ip);
  int rc = 0;
  const Kernel k = prepare(ip, L, &rc);
  if (!k) return rc > 0 ? -rc - 100 : rc;
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, 32 * dec_warps(L), dec_smem_bytes(L));
  return e == cudaSuccess ? n : -static_cast<int>(e) - 100;
}

// Returns 0, a cudaError_t, or a negative code as prepare() above.
extern "C" int gbdi_decode_launch(const long long* ptr, const int* ip, void* stream) {
  const DecArgs a = unpack(ptr, ip);
  const DecLayout L = layout_of(ip);
  int rc = 0;
  const Kernel k = prepare(ip, L, &rc);
  if (!k) return rc;
  if (a.n_pages == 0) return 0;
  const int warps = dec_warps(L), threads = 32 * warps;
  const size_t smem = dec_smem_bytes(L);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (static_cast<long long>(a.n_pages) + warps - 1) / warps;
  const int grid = static_cast<int>(std::min(need, static_cast<long long>(std::max(per_sm, 1)) * sms));
  k<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
