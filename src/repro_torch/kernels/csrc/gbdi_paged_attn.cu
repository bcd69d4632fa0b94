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
// repro_torch.kernels.gbdi_paged_attn.paged_attention_decode_plain.  Its
// tail form (gbdi_paged_attn_tail_launch) does the caller's part too: the
// split merge also scores the raw tail ring, folds it in and writes the
// normalised output in bf16 (plain version: paged_attention_decode_tail_plain).
// Only 16-bit (bf16) word configs are served; the wrapper raises for others.
//
// Bound: bytes and operations about evenly.  Each K and V page blob is
// read once (3,588 B of int32 lanes for the default KV page of 2,048 bf16
// words), and a decoded page costs 4 float32 operations per (query head,
// token, channel) plus the decode's integer work: at the serving shape
// (8 x 128 query heads, 32K tokens) 0.28 ms of bytes against 0.32 ms of
// operations on an H100.  The pages never round-trip through device memory
// in decoded form.
//
// Design.  Kernel 1 runs a grid of (splits, B, row chunks) blocks of 512
// threads (one block per SM: 127 registers a thread); each block walks a
// contiguous run of page slots of one batch row in passes of N slots (N
// from the wrapper: up to 8, what fits shared memory, cut back to whole
// 8-token tiles; 4 at the serving shape).  While a pass computes, the next
// pass's 2N blobs (K and V) land in the other half of a double buffer
// through cp.async, staged field-major so that each field of the pass is
// one contiguous run of 16-byte copies.  A pass has two steps:
//
// 1. A batched page decode (decode_pass), private to this kernel and for
//    16-bit words only.  A warp takes one 128-word group of a page at a
//    time, 4 words a lane: one ptr-lane load gives the 4 codes, one table
//    load per word gives base and width class.  A count pass stores each
//    group's words per class; a second pass ranks each word in page order
//    (the counts of the page's earlier groups, one REDUX; the class's words
//    of lower lanes, four ballots; its own lower words) and writes base +
//    field (mod 2^16), 8 bytes a lane.  Live outlier slots go last, each
//    writing its own value where the indices rise strictly (as the encoder
//    writes them), else the sum of its index's live values.  Four block
//    barriers a pass for any number of classes; the first decode kernel's
//    page body needed about seven per page.  With one width class (every
//    serving config) the passes are branch-free and take two groups a step,
//    so a warp keeps two chains of shared-memory loads in flight.  The
//    words equal the decode kernel's (gbdi_decode.cu) and fr_decode's bit
//    for bit (decode_pages_kernel exposes them for that check).
// 2. Attention over the pass's T = N*pt tokens in tiles of 8, with no block
//    barrier.  The 16 warps form ts token slices of 16 / ts warps; slice j
//    takes the pass's tiles j, j + ts, j + 2 ts, ..., and within a slice
//    warp w owns a fixed set of (kv, group) rows for the whole run.  ts is
//    the largest power of two up to 16 that leaves a slice a tile a pass and
//    each warp at most rows_per_warp rows (token_slices): where a chunk has
//    few rows (6 at G 6 on one KV head), the warps that would own none
//    attend over other tiles instead of idling.  Lanes run over channel
//    pairs (one 32-bit load, two bf16 channels), and each thread keeps its
//    rows' accumulators in registers (32 floats).  Per tile and kv head a
//    warp loads the 8 K rows into registers once; each row's 8 dot products
//    are reduced across lanes by a splitting butterfly (9 shuffles for 8
//    sums), two rows at a time; the online softmax of a row runs across
//    lanes (each lane one token) and leaves p and alpha in shared memory,
//    each slice its own (m, l, alpha, p); then the 8 V rows come into
//    registers and acc = acc * alpha + p.V runs in registers.  q stays in
//    shared memory.  After the last pass the slices' (acc, m, l) are folded
//    by the merge_softmax identity in shared memory laid over the decoded
//    pass, which is dead by then.
//
// Ring mode (a sliding-window layer, its own instantiation: attn_kernel<.,
// ., true>).  The S page slots are a ring: page p lives in slot p % S, and
// the kernel is given cur = pos / pt and lo = pos - window + 1.  It reads
// slots [0, min(S, cur)); slot s holds page cur - 1 - ((cur - 1 - s) mod S),
// and a token counts only where its position lies in [lo, cur * pt).  That
// masks the oldest page's tokens before the window and, on the step whose
// append flushed page cur into slot cur % S, that whole slot (the formula
// gives it page cur - S, wholly before the window; the raw tail holds page
// cur).  Everything else is the full-attention kernel's.
//
// Rows wider than a page (a multipage row: Kv * hd = ppr * P, each page
// whole heads) fill ppr page slots a token: slot t * ppr + j holds heads
// [j Kv / ppr, (j + 1) Kv / ppr) of token t, and a page one token (pt 1).
// Grid axis z then runs over the ppr head groups too (z = head group x the
// group's row chunks and channel chunks): a block of group j stages and
// decodes only the slots t * ppr + j of its run, which hold every row it
// attends for, so each slot is still decoded once.  ppr comes from n_kv * hd
// and P at unpack; the slot index and the block's first row follow from
// (ppr, j) once a block and a pass, and a pass stages its slots as one range
// a field at ppr 1, 4-byte copies a slot above it.
//
// Rows past one block (16 warps x 8 rows at 4 channels a lane) go to
// further row chunks on grid axis z, each decoding the pages again.  Heads
// wider than 256 channels also split into channel chunks on axis z (z = row
// chunk x channel chunks + channel chunk): each chunk scores its rows over
// the whole head, the K tile taken 256 channels at a time, and accumulates V
// over its own 256 channels only, so its registers stay those of hd 256;
// m and l are the same in every channel chunk and chunk 0 writes them.  Blocks
// run in no order, so each writes its partial (acc, m, l); kernel 2 merges
// the splits with the merge_softmax identity.  Masking uses -1e30 and p = 0
// where a score is <= -1e29, so an empty run merges as (acc, m, l) =
// (0, -1e30, 0).  In the tail form kernel 2 also scores the row's raw tail
// (the tokens of page pos / pt at positions in [lo, pos], held as bf16 in
// the tail ring (B, pt, n_kv, hd)), folds those scores into the same max and
// sums, and writes acc / l as bf16 (B, n_kv, groups, hd) in place of the
// state: one launch pair a layer where the caller ran a dozen eager ops.
//
// What holds it back now (PERF.md): both steps are latency-bound at 16
// warps an SM.  With the attention in token slices every warp attends at
// every geometry, so the pass decode is the larger share of a pass where a
// chunk has few rows (G 6 on one KV head); the math is float32 CUDA-core,
// where bf16 tensor cores would take q.K and p.V.
//
// Host interface: plain C, loaded with ctypes (no PyTorch headers).

#include "gbdi_common.cuh"

namespace {

using namespace gbdi;

constexpr float kMasked = -1e30f;
constexpr float kMaskedGuard = -1e29f;
constexpr int kAttnThreads = 512;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMergeThreads = 128;
constexpr int kTile = 8;         // tokens per attention tile
constexpr int kMaxPassSlots = 8; // N is at most this
constexpr int kMaxCpl = 8;       // channels per lane of one channel chunk
constexpr int kChunkChannels = 32 * kMaxCpl;  // channels of one channel chunk

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
  float* acc;  // (B, n_kv, groups, hd); the state form only
  float* m;    // (B, n_kv, groups)
  float* l;
  const unsigned short* k_tail;  // the tail form only: (B, pt, n_kv, hd) bf16 bits
  const unsigned short* v_tail;
  unsigned short* out;           // the tail form only: (B, n_kv, groups, hd) bf16 bits
  short* out_k;  // decode_pages only: (B, n_valid, P) bf16 bits
  short* out_v;
  int B, S, n_valid, splits, run, n_kv, groups, hd, pt, N;  // S, n_valid, run: tokens where ppr > 1
  // ring mode and the tail form: pos / pt and the first position that counts
  // (pos - window + 1; 0 for a full layer); the tail form: the query's position
  int cur, lo, pos;
  int ts;                 // token slices of the attention step: token_slices, by unpack_params
  int ppr;                // page slots a row spans (row_pages), by unpack_params; 0: refused
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// page slots a row of n_kv * hd words spans: 1 where it fits in a page of P,
// else row / P where that is whole and a page holds whole heads; 0 otherwise
__host__ __device__ inline int row_pages(int n_kv, int hd, int P) {
  const int row = n_kv * hd;
  if (row <= P) return 1;
  return P > 0 && hd > 0 && row % P == 0 && P % hd == 0 ? row / P : 0;
}

// channels per lane: the power of two with 32 * cpl >= hd (0 if hd > 256)
__host__ __device__ inline int cpl_of(int hd) {
  for (int c = 1; c <= kMaxCpl; c *= 2)
    if (32 * c >= hd) return c;
  return 0;
}

// channel chunks of a head: 1 up to 256 channels, else one per 256
__host__ __device__ inline int chan_chunks(int hd) {
  return hd <= kChunkChannels ? 1 : (hd + kChunkChannels - 1) / kChunkChannels;
}

// rows a warp may own: 32 accumulators a thread, but 8 at 8 channels a
// lane, whose 8-token tile already takes 64 registers
__host__ __device__ constexpr int rows_per_warp(int cpl) { return cpl >= kMaxCpl ? 1 : 32 / cpl; }

// rows of one row chunk: 16 warps of rows_per_warp rows
__host__ __device__ inline int chunk_rows(int kg, int hd) {
  const int cpl = cpl_of(hd);
  const int most = kAttnWarps * rows_per_warp(cpl ? cpl : kMaxCpl);
  return kg < most ? kg : most;
}

// Token slices of the attention step: the largest power of two ts <= 16 with
// ts <= the pass's 8-token tiles and ceil(R ts / 16) <= rows_per_warp rows a
// warp, R the chunk's rows; 1 for a head wider than one channel chunk.  Rows
// past one chunk fill it (R = 16 rows_per_warp), so they take ts = 1.
__host__ __device__ inline int token_slices(int kg, int hd, int pass_tokens) {
  const int cpl = cpl_of(hd);
  if (cpl == 0) return 1;
  const int R = chunk_rows(kg, hd), tiles = (pass_tokens + kTile - 1) / kTile;
  int ts = kAttnWarps;
  while (ts > 1 && (ts > tiles || (R * ts + kAttnWarps - 1) / kAttnWarps > rows_per_warp(cpl))) ts >>= 1;
  return ts;
}

// A staged pass, field-major so that each blob field of the pass's page
// slots is one contiguous copy: per side (K, then V) the N slots' ptrs,
// deltas, out_vals, out_idx, n_out and profile, each region starting
// 16-byte aligned.  Offsets in ints.
struct StageLayout {
  int o_dl, o_ov, o_oi, o_n, o_pid, side;
};

__host__ __device__ inline StageLayout stage_layout(int N, int ptr_lanes, int delta_lanes,
                                                    int outlier_cap) {
  StageLayout L;
  L.o_dl = align4(N * ptr_lanes);
  L.o_ov = L.o_dl + align4(N * delta_lanes);
  L.o_oi = L.o_ov + align4(N * outlier_cap);
  L.o_n = L.o_oi + align4(N * outlier_cap);
  L.o_pid = L.o_n + align4(N);
  L.side = L.o_pid + align4(N);
  return L;
}

// 128-word groups of a page (page_words is a multiple of 128): a warp
// decodes one group at a time, 4 words a lane
constexpr int kGroupWords = 128;

__host__ __device__ inline int page_groups(int P) { return P / kGroupWords; }

// The bytes of the decoded pass (2N*P bf16), or where ts > 1 of the slices'
// fold (ts x R x hd floats) laid over it, whichever is larger.
__host__ __device__ inline size_t words_bytes(int P, int N, int ts, size_t R, int hd) {
  const size_t words = align16(2 * 2 * static_cast<size_t>(N) * P);
  const size_t fold = ts > 1 ? align16(4 * ts * R * hd) : 0;
  return words > fold ? words : fold;
}

// Dynamic shared memory of one block, in carve order (kg: the rows of a
// page's heads): q (R x hd), m, l,
// alpha, p (ts x R x kTile: each token slice its own), the code table
// (table_len + 2), class 0's mask of the first 32 codes, the profiles' caps
// and lane offsets (2 x np x nc), per-page caps and lane offsets, per-class
// counts of each 128-word group (nc x 2N x groups), the decoded pass (2N*P
// bf16) or the slices' fold, and two staged passes.
__host__ __device__ inline size_t attn_smem_bytes(int P, int ptr_lanes, int delta_lanes,
                                                  int outlier_cap, int table_len, int nc, int np,
                                                  int kg, int hd, int N, int pt) {
  const size_t R = static_cast<size_t>(chunk_rows(kg, hd));
  const int ts = token_slices(kg, hd, N * pt);
  const size_t SR = ts * R;
  const size_t pages = 2 * static_cast<size_t>(N);
  const StageLayout L = stage_layout(N, ptr_lanes, delta_lanes, outlier_cap);
  return align16(4 * R * hd) + 3 * align16(4 * SR) + align16(4 * SR * kTile) +
         align16(4 * (static_cast<size_t>(table_len) + 2)) + align16(4) +
         align16(8 * static_cast<size_t>(np) * nc) + 2 * align16(4 * pages * kMaxClasses) +
         align16(4 * nc * pages * page_groups(P)) + words_bytes(P, N, ts, R, hd) +
         4 * 2 * 2 * static_cast<size_t>(L.side);
}

struct AttnSmem {
  float* q;      // (R, hd): this chunk's query rows
  float* m;      // (ts, R): running max of each row, per token slice
  float* l;      // (ts, R): running sum
  float* alpha;  // (ts, R): this tile's rescale of each row
  float* p;      // (ts, R, kTile): this tile's probabilities
  int* tab;      // per code: (class + 1) << 16 | base & 0xFFFF (class 0: none)
  unsigned* cmask;  // bit `code` set where code < 32 has class 0
  int* meta;     // caps (np x nc) | lane offsets (np x nc) of every profile
  int* pcap;     // (2N, kMaxClasses): each page's class caps (0: no field)
  int* poff;     // (2N, kMaxClasses): each page's class lane offsets
  int* cnt;      // (nc, 2N, groups): flagged words of each class and group
  unsigned short* words;  // (2N, P): K pages of the pass, then V pages; after
                          // the last pass, the slices' acc (ts, R, hd) float
  int* stage;    // two passes of 2N staged blobs
};

__device__ AttnSmem carve(int* smem, const AttnArgs& a) {
  AttnSmem s;
  const int kg = a.n_kv / a.ppr * a.groups, R = chunk_rows(kg, a.hd);
  const int ts = a.ts, SR = ts * R;
  const int pages = 2 * a.N;
  char* c = reinterpret_cast<char*>(smem);
  auto take = [&c](size_t bytes) {
    char* at = c;
    c += align16(bytes);
    return at;
  };
  s.q = reinterpret_cast<float*>(take(4u * R * a.hd));
  s.m = reinterpret_cast<float*>(take(4u * SR));
  s.l = reinterpret_cast<float*>(take(4u * SR));
  s.alpha = reinterpret_cast<float*>(take(4u * SR));
  s.p = reinterpret_cast<float*>(take(4u * SR * kTile));
  s.tab = reinterpret_cast<int*>(take(4u * (a.g.table_len + 2)));
  s.cmask = reinterpret_cast<unsigned*>(take(4u));
  s.meta = reinterpret_cast<int*>(take(8u * a.g.np * a.g.nc));
  s.pcap = reinterpret_cast<int*>(take(4u * pages * kMaxClasses));
  s.poff = reinterpret_cast<int*>(take(4u * pages * kMaxClasses));
  s.cnt = reinterpret_cast<int*>(take(4u * a.g.nc * pages * page_groups(a.g.P)));
  s.words = reinterpret_cast<unsigned short*>(take(words_bytes(a.g.P, a.N, ts, R, a.hd)));
  s.stage = reinterpret_cast<int*>(c);
  return s;
}

// a bf16 word as the float32 it widens to, exactly
__device__ __forceinline__ float bf16_word(unsigned w) { return __uint_as_float(w << 16); }

// j / P for 0 <= j < 2^22 through a float reciprocal, corrected to exact.
__device__ __forceinline__ int div_exact(int j, int P, float inv_p) {
  int q = __float2int_rz(__int2float_rn(j) * inv_p);
  if (q * P > j) --q;
  if ((q + 1) * P <= j) ++q;
  return q;
}

// Start copying n ints from src to dst: 16-byte copies where src is
// 16-byte aligned and n a multiple of 4, else 4-byte copies.
__device__ __forceinline__ void stage_range(int* dst, const int* src, int n) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = threadIdx.x; e < n >> 2; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) cp_async4(dst + e, src + e);
  }
}

// Start copying n rows of len ints, each ppr * len apart, into consecutive
// rows: 4-byte copies, for the slots of a multipage row's head group.
__device__ __forceinline__ void stage_rows(int* dst, const int* src, int n, int len, int ppr) {
  const size_t stride = static_cast<size_t>(ppr) * len;
  for (int e = threadIdx.x; e < n * len; e += blockDim.x) {
    const int r = e / len;
    cp_async4(dst + e, src + r * stride + (e - r * len));
  }
}

// Start copying the K and V blobs of n_s page slots, the first at `page`
// and each a.ppr after the one before (head group hg's slots of consecutive
// tokens where a row spans ppr slots; consecutive slots at ppr 1), into a
// staged pass, each field's slots consecutive: at ppr 1 one range a field,
// else one a slot.  Single-profile configs stage profile 0.
__device__ void stage_pass(const AttnArgs& a, const StageLayout& L, size_t page, int n_s,
                           int* buf) {
  const PageGeom& g = a.g;
  const int ppr = a.ppr;
  for (int side = 0; side < 2; ++side) {
    const BlobPtrs& f = side ? a.v : a.k;
    int* dst = buf + side * L.side;
    if (ppr == 1) {
      stage_range(dst, f.ptrs + page * g.ptr_lanes, n_s * g.ptr_lanes);
      stage_range(dst + L.o_dl, f.deltas + page * g.delta_lanes, n_s * g.delta_lanes);
      stage_range(dst + L.o_ov, f.out_vals + page * g.outlier_cap, n_s * g.outlier_cap);
      stage_range(dst + L.o_oi, f.out_idx + page * g.outlier_cap, n_s * g.outlier_cap);
    } else {
      stage_rows(dst, f.ptrs + page * g.ptr_lanes, n_s, g.ptr_lanes, ppr);
      stage_rows(dst + L.o_dl, f.deltas + page * g.delta_lanes, n_s, g.delta_lanes, ppr);
      stage_rows(dst + L.o_ov, f.out_vals + page * g.outlier_cap, n_s, g.outlier_cap, ppr);
      stage_rows(dst + L.o_oi, f.out_idx + page * g.outlier_cap, n_s, g.outlier_cap, ppr);
    }
  }
  const int t = threadIdx.x;
  if (t < 2 * n_s) {
    const int side = t >= n_s, j = t - side * n_s;
    const BlobPtrs& f = side ? a.v : a.k;
    int* dst = buf + side * L.side;
    const size_t p = page + static_cast<size_t>(j) * ppr;
    cp_async4(dst + L.o_n + j, f.n_out + p);
    if (f.profile) {
      cp_async4(dst + L.o_pid + j, f.profile + p);
    } else {
      dst[L.o_pid + j] = 0;
    }
  }
}

// The staged fields of buffer page bp (K slots at 0..N-1, V at N..2N-1).
struct PageView {
  const int* side;  // the page's side of the staged pass
  int j;            // its slot in the pass
};

__device__ __forceinline__ PageView page_view(const int* st, const StageLayout& L, int bp, int N) {
  const int sd = bp >= N;
  return {st + sd * L.side, bp - sd * N};
}

// buffer page of valid page pg: K slots sit at 0..N-1, V slots at N..2N-1
__device__ __forceinline__ int buffer_page(int pg, int n_s, int N) {
  return pg < n_s ? pg : pg + N - n_s;
}

// The table entry of a pointer code: a base's own entry, then one entry
// for the zero and outlier codes (value 0) and one for the codes past them
// (the last base, as the decode kernel clips them); none has a class.
__device__ __forceinline__ int tab_index(int code, int nb) {
  return code < nb ? code : code <= nb + 1 ? nb : nb + 1;
}

// The codes of words p0..p0+3 (p0 a multiple of 4) of a staged page.
__device__ __forceinline__ void codes4(const int* ptrs, int p0, int b, unsigned cmask,
                                       int (&code)[4]) {
  const int bit0 = p0 * b;
  const unsigned lo = static_cast<unsigned>(ptrs[bit0 >> 5]);
  const unsigned hi = static_cast<unsigned>(ptrs[(bit0 >> 5) + (4 * b > 32)]);
  const unsigned long long both = static_cast<unsigned long long>(hi) << 32 | lo;
#pragma unroll
  for (int k = 0; k < 4; ++k) code[k] = static_cast<int>((both >> ((bit0 & 31) + k * b)) & cmask);
}

// Decode the staged pass `st` (n_s valid slots of K and V) into s.words as
// 16-bit words, bit for bit as the decode kernel and fr_decode.  The staged
// copies must have landed and the block synced; every thread calls it, and
// it ends with a barrier, so the words are ready on return.
//
// A warp takes one 128-word group of a page at a time, lane l words 4l..4l+3.
// Pass 1 counts each group's words of each class; pass 2 ranks a word as
// the counts of the page's earlier groups, plus the class's words of lower
// lanes (four ballots), plus its own lower words, and writes the group's
// words as base + field (mod 2^16), 8 bytes a lane.  Outlier slots go last.
__device__ void decode_pass(const AttnArgs& a, const AttnSmem& s, const StageLayout& L,
                            const int* st, int n_s) {
  const PageGeom& g = a.g;
  const int P = g.P, N = a.N, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int n_pages = 2 * n_s, nc = g.nc, nb = g.num_bases, b = g.ptr_bits;
  const unsigned cmask = (1u << b) - 1u, lt = (1u << lane) - 1u;
  const int gp = page_groups(P), items = n_pages * gp;
  const float inv_gp = 1.0f / static_cast<float>(gp);

  // each valid page's class caps and lane offsets, from its own profile; a
  // profile id outside the table matches no layout (every field stays 0)
  if (tid < n_pages) {
    const int bp = buffer_page(tid, n_s, N);
    const PageView v = page_view(st, L, bp, N);
    const int pid = v.side[L.o_pid + v.j];
    const bool ok = pid >= 0 && pid < g.np;
    for (int c = 0; c < nc; ++c) {
      s.pcap[bp * kMaxClasses + c] = ok ? s.meta[pid * nc + c] : 0;
      s.poff[bp * kMaxClasses + c] = ok ? s.meta[g.np * nc + pid * nc + c] : 0;
    }
  }
  if (nc == 1 && gp <= 32) {
    // One width class (every KV config of the serving path), pages of at
    // most 4,096 words: the same two passes, branch-free, two groups a step,
    // so that a warp has two chains of loads in flight.  Codes below 32 test
    // the class mask in a register, wider ones read the table.
    const bool small_codes = b <= 5;
    const unsigned cm0 = *s.cmask;
    auto count_one = [&](int it) {
      const int pg = div_exact(it, gp, inv_gp), grp = it - pg * gp, bp = buffer_page(pg, n_s, N);
      const PageView v = page_view(st, L, bp, N);
      int code[4];
      codes4(v.side + v.j * g.ptr_lanes, grp * kGroupWords + 4 * lane, b, cmask, code);
      int n = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        n += small_codes ? (cm0 >> (code[k] & 31)) & 1u : (s.tab[tab_index(code[k], nb)] >> 16) == 1;
      n = __reduce_add_sync(kFull, n);
      if (lane == 0) s.cnt[bp * gp + grp] = n;
    };
    auto full_one = [&](int it) {
      const int pg = div_exact(it, gp, inv_gp), grp = it - pg * gp, bp = buffer_page(pg, n_s, N);
      const PageView v = page_view(st, L, bp, N);
      const int p0 = grp * kGroupWords + 4 * lane;
      int code[4], ent[4];
      codes4(v.side + v.j * g.ptr_lanes, p0, b, cmask, code);
      bool f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ent[k] = s.tab[tab_index(code[k], nb)];
        f[k] = (ent[k] >> 16) == 1;
      }
      const unsigned b0 = __ballot_sync(kFull, f[0]), b1 = __ballot_sync(kFull, f[1]),
                     b2 = __ballot_sync(kFull, f[2]), b3 = __ballot_sync(kFull, f[3]);
      int r = __reduce_add_sync(kFull, lane < grp ? s.cnt[bp * gp + lane] : 0) +
              __popc(b0 & lt) + __popc(b1 & lt) + __popc(b2 & lt) + __popc(b3 & lt);
      const int cap = s.pcap[bp * kMaxClasses], wd = g.widths[0], half = 1 << (wd - 1);
      const int* lanes = v.side + L.o_dl + v.j * g.delta_lanes + s.poff[bp * kMaxClasses];
      const unsigned fmask = (1u << wd) - 1u;
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int bit = max(min(r, cap - 1), 0) * wd;
        const int field = static_cast<int>((static_cast<unsigned>(lanes[bit >> 5]) >> (bit & 31)) & fmask);
        const unsigned add = f[k] && cap > 0 ? static_cast<unsigned>(field >= half ? field - (1 << wd) : field) : 0u;
        w[k] = (static_cast<unsigned>(ent[k]) + add) & 0xFFFFu;
        r += f[k];
      }
      *reinterpret_cast<uint2*>(s.words + bp * P + p0) = make_uint2(w[0] | w[1] << 16, w[2] | w[3] << 16);
    };
    for (int it = warp; it < items; it += 2 * n_warps) {
      count_one(it);
      count_one(min(it + n_warps, items - 1));  // a repeat writes the same count
    }
    __syncthreads();
    for (int it = warp; it < items; it += 2 * n_warps) {
      full_one(it);
      full_one(min(it + n_warps, items - 1));  // a repeat writes the same words
    }
  } else {
    // any number of classes: pass 1 counts each class's words of a group
    // from the table, pass 2 ranks and writes them a class at a time
    for (int it = warp; it < items; it += n_warps) {
      const int pg = div_exact(it, gp, inv_gp), grp = it - pg * gp, bp = buffer_page(pg, n_s, N);
      const PageView v = page_view(st, L, bp, N);
      int code[4], cl[4];
      codes4(v.side + v.j * g.ptr_lanes, grp * kGroupWords + 4 * lane, b, cmask, code);
#pragma unroll
      for (int k = 0; k < 4; ++k) cl[k] = s.tab[tab_index(code[k], nb)] >> 16;
      for (int c = 1; c <= nc; ++c) {
        const int n = __reduce_add_sync(kFull, (cl[0] == c) + (cl[1] == c) + (cl[2] == c) + (cl[3] == c));
        if (lane == 0) s.cnt[((c - 1) * 2 * N + bp) * gp + grp] = n;
      }
    }
    __syncthreads();
    for (int it = warp; it < items; it += n_warps) {
      const int pg = div_exact(it, gp, inv_gp), grp = it - pg * gp, bp = buffer_page(pg, n_s, N);
      const PageView v = page_view(st, L, bp, N);
      const int p0 = grp * kGroupWords + 4 * lane;
      int code[4], ent[4];
      unsigned val[4];
      codes4(v.side + v.j * g.ptr_lanes, p0, b, cmask, code);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ent[k] = s.tab[tab_index(code[k], nb)];
        val[k] = static_cast<unsigned>(ent[k]) & 0xFFFFu;
      }
      for (int c = 1; c <= nc; ++c) {
        bool f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) f[k] = (ent[k] >> 16) == c;
        const unsigned b0 = __ballot_sync(kFull, f[0]), b1 = __ballot_sync(kFull, f[1]),
                       b2 = __ballot_sync(kFull, f[2]), b3 = __ballot_sync(kFull, f[3]);
        if ((b0 | b1 | b2 | b3) == 0) continue;
        const int* cnt = s.cnt + ((c - 1) * 2 * N + bp) * gp;
        int r = __popc(b0 & lt) + __popc(b1 & lt) + __popc(b2 & lt) + __popc(b3 & lt);
        for (int g0 = 0; g0 < grp; g0 += 32)
          r += __reduce_add_sync(kFull, g0 + lane < grp ? cnt[g0 + lane] : 0);
        const int cap = s.pcap[bp * kMaxClasses + c - 1];
        if (cap == 0) continue;
        const int* lanes =
            v.side + L.o_dl + v.j * g.delta_lanes + s.poff[bp * kMaxClasses + c - 1];
        const int wd = g.widths[c - 1], half = 1 << (wd - 1);
        const unsigned fmask = (1u << wd) - 1u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!f[k]) continue;
          const int bit = (r < cap ? r : cap - 1) * wd;
          const int field =
              static_cast<int>((static_cast<unsigned>(lanes[bit >> 5]) >> (bit & 31)) & fmask);
          val[k] = (val[k] + static_cast<unsigned>(field >= half ? field - (1 << wd) : field)) & 0xFFFFu;
          ++r;
        }
      }
      *reinterpret_cast<uint2*>(s.words + bp * P + p0) =
          make_uint2(val[0] | val[1] << 16, val[2] | val[3] << 16);
    }
  }
  __syncthreads();

  // live outlier slots (< n_out), one warp per page: the first live slot of
  // an index writes the sum of the page's live values at that index; an
  // index off the page is ignored.  Indices strictly rising (as the encoder
  // writes them) cannot repeat, so each slot then writes its own value.
  const int cap = g.outlier_cap;
  for (int pg = warp; pg < n_pages; pg += n_warps) {
    const int bp = buffer_page(pg, n_s, N);
    const PageView v = page_view(st, L, bp, N);
    const int* idx = v.side + L.o_oi + v.j * cap;
    const int* vals = v.side + L.o_ov + v.j * cap;
    unsigned short* out = s.words + bp * P;
    const int live = min(v.side[L.o_n + v.j], cap);
    bool rising = true;
    for (int r = lane; r + 1 < live; r += 32) rising = rising && idx[r] < idx[r + 1];
    if (__all_sync(kFull, rising)) {
      for (int r = lane; r < live; r += 32) {
        const int i = idx[r];
        if (i >= 0 && i < P) out[i] = static_cast<unsigned short>(vals[r] & 0xFFFF);
      }
      continue;
    }
    for (int r = lane; r < live; r += 32) {
      const int i = idx[r];
      if (i < 0 || i >= P) continue;
      bool first = true;
      for (int e = 0; e < r; ++e) first = first && idx[e] != i;
      if (!first) continue;
      unsigned sum = 0;
      for (int e = r; e < live; ++e)
        if (idx[e] == i) sum += static_cast<unsigned>(vals[e]);
      out[i] = static_cast<unsigned short>(sum & 0xFFFFu);
    }
  }
  __syncthreads();
}

// Stage the code table, then walk page slots [first, last) of batch row b in
// passes of N (of head group hg's slots where a row spans ppr of them): stage
// the next pass while this one decodes, then hand the decoded pass to
// body(slot0, n_s).  body must not sync the block: the next pass's first
// barrier is what keeps its reads ahead of the next decode.
template <class Body>
__device__ __forceinline__ void run_passes(const AttnArgs& a, const AttnSmem& s, int b, int hg,
                                           int first, int last, Body body) {
  const StageLayout L = stage_layout(a.N, a.g.ptr_lanes, a.g.delta_lanes, a.g.outlier_cap);
  const int nb = a.g.num_bases;
  for (int j = threadIdx.x; j < a.g.table_len + 2; j += blockDim.x) {
    int e = 0;
    if (j < nb) {
      const int c = a.cls[j];
      e = (c >= 0 && c < a.g.nc ? c + 1 : 0) << 16 | (a.bases[j] & 0xFFFF);
    } else if (j == nb + 1) {
      e = a.bases[nb - 1] & 0xFFFF;
    }
    s.tab[j] = e;
  }
  for (int j = threadIdx.x; j < 2 * a.g.np * a.g.nc; j += blockDim.x) s.meta[j] = a.g.meta[j];
  if (threadIdx.x == 0) {
    unsigned m = 0;
    for (int code = 0; code < min(nb, 32); ++code) m |= (a.cls[code] == 0 ? 1u : 0u) << code;
    *s.cmask = m;
  }
  // token slot t of the row is page slot base + t * ppr
  const size_t base = static_cast<size_t>(b) * a.S * a.ppr + hg;
  const int pass_ints = 2 * L.side;
  if (first < last) {
    stage_pass(a, L, base + static_cast<size_t>(first) * a.ppr, min(a.N, last - first), s.stage);
    cp_async_commit();
  }
  for (int s0 = first, it = 0; s0 < last; s0 += a.N, ++it) {
    const int n_s = min(a.N, last - s0);
    const int* cur = s.stage + (it & 1) * pass_ints;
    if (s0 + a.N < last) {
      // the other buffer was last read by the previous pass's decode, which
      // every thread left behind that decode's final barrier
      stage_pass(a, L, base + static_cast<size_t>(s0 + a.N) * a.ppr, min(a.N, last - s0 - a.N),
                 s.stage + ((it + 1) & 1) * pass_ints);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    decode_pass(a, s, L, cur, n_s);
    body(s0, n_s);
  }
}

// Lane `lane`'s k-th channel: lane for one channel a lane, else the pairs
// (2 lane, 2 lane + 1), (2 lane + 64, 2 lane + 65), ... so that one 32-bit
// load brings two bf16 channels.
template <int CPL>
__device__ __forceinline__ int chan(int lane, int k) {
  return CPL == 1 ? lane : 2 * lane + (k & 1) + 64 * (k >> 1);
}

// kTile tokens' rows of n channels from `off` of a decoded side (K or V) of
// the pass, widened to float32; tokens at or past T and channels at or past
// n read as 0.  Pairs of channels come in one 32-bit load where hd is even.
template <int CPL>
__device__ __forceinline__ void load_tile(const unsigned short* side, float (&r)[kTile][CPL],
                                          int t0, int T, int off, int rowlen, int n, int hd,
                                          int lane) {
  const bool pairs = CPL > 1 && (hd & 1) == 0;
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    const int tt = t0 + t;
    const unsigned short* src = side + static_cast<size_t>(tt) * rowlen + off;
    if (pairs) {
#pragma unroll
      for (int k = 0; k < CPL; k += 2) {
        const int c = chan<CPL>(lane, k);
        const unsigned w = tt < T && c < n ? *reinterpret_cast<const unsigned*>(src + c) : 0u;
        r[t][k] = __uint_as_float(w << 16);
        r[t][k + 1] = __uint_as_float(w & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = chan<CPL>(lane, k);
        r[t][k] = tt < T && c < n ? bf16_word(src[c]) : 0.f;
      }
    }
  }
}

// The sums over the warp's lanes of v[0..7]: a splitting butterfly leaves
// the sum of v[t] in every lane whose bits 4, 3, 2 spell t (9 shuffles).
__device__ __forceinline__ float warp_sum8(const float (&v)[kTile], int lane) {
  const bool h4 = (lane >> 4) & 1, h3 = (lane >> 3) & 1, h2 = (lane >> 2) & 1;
  float x[4], y[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = (h4 ? v[j + 4] : v[j]) + __shfl_xor_sync(kFull, h4 ? v[j] : v[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    y[j] = (h3 ? x[j + 2] : x[j]) + __shfl_xor_sync(kFull, h3 ? x[j] : x[j + 2], 8);
  float z = (h2 ? y[1] : y[0]) + __shfl_xor_sync(kFull, h2 ? y[0] : y[1], 4);
  z += __shfl_xor_sync(kFull, z, 2);
  z += __shfl_xor_sync(kFull, z, 1);
  return z;
}

// part[t] += q . K[t] over the n channels of a tile, for q row qr (its
// first channel matching the tile's); hd even lets a lane take its channel
// pairs in one 8-byte load.
template <int CPL>
__device__ __forceinline__ void tile_dots(const float* qr, const float (&tile)[kTile][CPL], int n,
                                          int hd, int lane, float (&part)[kTile]) {
  float q[CPL];
  if (CPL > 1 && (hd & 1) == 0) {
#pragma unroll
    for (int k = 0; k < CPL; k += 2) {
      const int c = chan<CPL>(lane, k);
      const float2 v = c < n ? *reinterpret_cast<const float2*>(qr + c) : make_float2(0.f, 0.f);
      q[k] = v.x;
      q[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = chan<CPL>(lane, k);
      q[k] = c < n ? qr[c] : 0.f;
    }
  }
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    float d = part[t];
#pragma unroll
    for (int k = 0; k < CPL; ++k) d = fmaf(q[k], tile[t][k], d);
    part[t] = d;
  }
}

// The token of the tile that lane `lane` scores (lane bits 4..2, as
// warp_sum8 leaves the sums).
__device__ __forceinline__ int tile_token(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// Ring mode: whether token tt of the pass that starts at slot s0 lies in
// the window, [lo, cur * pt) by position (see the head of this file).
__device__ __forceinline__ bool ring_live(const AttnArgs& a, int s0, int tt, int T) {
  if (tt >= T) return false;
  const int k = tt / a.pt, slot = s0 + k;
  const int page = a.cur - 1 - (a.cur - 1 - slot) % a.S;
  const int p = page * a.pt + tt - k * a.pt;
  return p >= a.lo && p < a.cur * a.pt;
}

// The online softmax of NR consecutive rows (from rl, of the block's chunk)
// given each row's dot product for the token t of this lane (lane bits 4..2):
// the tile's max, p = exp(s - m) (0 where s <= -1e29), and the updates of m,
// l, alpha and the tile's p in shared memory.  The rows' chains are
// independent, so a warp has NR of them in flight.  RING: `live` says
// whether the lane's token counts (ring_live), in place of t0 + t < T.
template <int NR, bool RING>
__device__ __forceinline__ void online_softmax(const AttnSmem& s, const float (&dot)[NR], int rl,
                                               int t0, int T, float scale, int lane, bool live) {
  const int tl = tile_token(lane);
  float sc[NR], mx[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    if constexpr (RING) {
      sc[j] = live ? dot[j] * scale : kMasked;
    } else {
      sc[j] = t0 + tl < T ? dot[j] * scale : kMasked;
    }
    mx[j] = sc[j];
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < NR; ++j) mx[j] = fmaxf(mx[j], __shfl_xor_sync(kFull, mx[j], o));
  float m_prev[NR], m_new[NR], p[NR], sum[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    m_prev[j] = s.m[rl + j];
    m_new[j] = fmaxf(m_prev[j], mx[j]);
    p[j] = sc[j] <= kMaskedGuard ? 0.f : expf(sc[j] - m_new[j]);
    sum[j] = p[j];
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < NR; ++j) sum[j] += __shfl_xor_sync(kFull, sum[j], o);
  __syncwarp();  // every lane has read m before lane 0 rewrites it
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    if ((lane & 3) == 0) s.p[(rl + j) * kTile + tl] = p[j];
    if (lane == 0) {
      const float alpha = expf(m_prev[j] - m_new[j]);
      s.alpha[rl + j] = alpha;
      s.m[rl + j] = m_new[j];
      s.l[rl + j] = s.l[rl + j] * alpha + sum[j];
    }
  }
}

// Scores and the online softmax of NR consecutive rows of one kv head
// against its K tile: each row's 8 dot products, reduced across lanes by
// warp_sum8 (every lane: its shuffles are full-warp).  Row rl's state is
// row so + rl of (m, l, alpha, p): so is the token slice's first.
template <int CPL, int NR, bool RING>
__device__ __forceinline__ void score_rows(const AttnSmem& s, const float (&tile)[kTile][CPL],
                                           int rl, int so, int t0, int T, int hd, float scale,
                                           int lane, bool live) {
  float dot[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    float part[kTile] = {};
    tile_dots<CPL>(s.q + (rl + j) * hd, tile, hd, hd, lane, part);
    dot[j] = warp_sum8(part, lane);
  }
  online_softmax<NR, RING>(s, dot, so + rl, t0, T, scale, lane, live);
}

// The same for one row of a head wider than a channel chunk: the K tile of
// kv head kv comes 256 channels at a time, and the partial dots of the
// blocks are summed before the reduction, so every channel chunk scores
// the whole head.
template <bool RING>
__device__ __forceinline__ void score_row_wide(const AttnSmem& s, const unsigned short* kside,
                                               int rl, int so, int kv, int t0, int T, int hd,
                                               int rowlen, float scale, int lane, bool live) {
  float part[kTile] = {};
  for (int c0 = 0; c0 < hd; c0 += kChunkChannels) {
    float tile[kTile][kMaxCpl];
    const int n = min(kChunkChannels, hd - c0);
    load_tile<kMaxCpl>(kside, tile, t0, T, kv * hd + c0, rowlen, n, hd, lane);
    tile_dots<kMaxCpl>(s.q + rl * hd + c0, tile, n, hd, lane, part);
  }
  const float dot[1] = {warp_sum8(part, lane)};
  online_softmax<1, RING>(s, dot, so + rl, t0, T, scale, lane, live);
}

// acc = acc * alpha + p . V for one row (state row rs) against the kv
// head's V tile.
template <int CPL>
__device__ __forceinline__ void update_row(const AttnSmem& s, const float (&tile)[kTile][CPL],
                                           float (&acc)[CPL], int rs) {
  const float alpha = s.alpha[rs];
  const float4 p0 = reinterpret_cast<const float4*>(s.p + rs * kTile)[0];
  const float4 p1 = reinterpret_cast<const float4*>(s.p + rs * kTile)[1];
  const float p[kTile] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    float v = acc[k] * alpha;
#pragma unroll
    for (int t = 0; t < kTile; ++t) v = fmaf(p[t], tile[t][k], v);
    acc[k] = v;
  }
}

// WIDE: a head past 256 channels (CPL 8), split into channel chunks.
// RING: the slots are a sliding window's ring (the head of this file).
template <int CPL, bool WIDE, bool RING>
__global__ void __launch_bounds__(kAttnThreads) attn_kernel(AttnArgs a) {
  constexpr int RPW = rows_per_warp(CPL);
  extern __shared__ int smem[];
  const AttnSmem s = carve(smem, a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, split = blockIdx.x;
  const int kg = a.n_kv * a.groups, hd = a.hd;
  // a page's heads and rows: all of them, or head group hg's of a multipage row
  const int kvp = a.n_kv / a.ppr, kgp = kvp * a.groups, rowlen = kvp * hd;
  // head group, row chunk and channel chunk; the channels [c0, c0 + hc) this block owns
  const int n_cc = WIDE ? chan_chunks(hd) : 1, cr = chunk_rows(kgp, hd);
  const int zg = (kgp + cr - 1) / cr * n_cc;  // blocks on axis z a head group
  const int hg = blockIdx.z / zg, zl = blockIdx.z - hg * zg;
  const int rz = WIDE ? zl / n_cc : zl, cc = WIDE ? zl - rz * n_cc : 0;
  const int c0 = cc * kChunkChannels, hc = WIDE ? min(kChunkChannels, hd - c0) : hd;
  const int r0 = hg * kgp + rz * cr;  // first row of this chunk, of the call's kg
  const int R = min(cr, (hg + 1) * kgp - r0);
  // token slice `slice` of ts takes tiles slice, slice + ts, ...; its wps
  // warps share the chunk's rows, rpw a warp
  const int ts = a.ts, wps = kAttnWarps / ts;
  const int slice = warp / wps, ws = warp - slice * wps;
  const int rpw = (R + wps - 1) / wps;
  const int wr0 = ws * rpw;  // this warp's first row in the chunk
  const int n_rows = max(0, min(rpw, R - wr0));
  // the warp's first row's kv head in the page (its head group's) and group
  const int kv_row = (r0 + wr0) / a.groups, g_first = r0 + wr0 - kv_row * a.groups;
  const int kv_first = kv_row - hg * kvp;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  const float* qb = a.q + (static_cast<size_t>(b) * kg + r0) * hd;
  for (int o = tid; o < R * hd; o += blockDim.x) s.q[o] = qb[o];
  for (int j = tid; j < ts * R; j += blockDim.x) {
    s.m[j] = kMasked;
    s.l[j] = 0.f;
  }
  const int so = slice * R;  // this slice's first row of (m, l, alpha, p)
  float acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[i][k] = 0.f;

  const int first = split * a.run, last = min(a.n_valid, first + a.run);
  const unsigned short* kside = s.words;
  const unsigned short* vside = s.words + static_cast<size_t>(a.N) * a.g.P;

  run_passes(a, s, b, hg, first, last, [&]([[maybe_unused]] int s0, int n_s) {
    const int T = n_s * a.pt;
    for (int t0 = slice * kTile; t0 < T; t0 += ts * kTile) {
      bool live = false;
      if constexpr (RING) live = ring_live(a, s0, t0 + tile_token(lane), T);
      // the warp's rows by kv head (one segment where they share one): a K
      // tile, the rows' scores two at a time, then a V tile and the updates
      float tile[kTile][CPL];
      for (int lo = 0, kv = kv_first, g0 = g_first; lo < n_rows; lo += a.groups - g0, ++kv, g0 = 0) {
        const int hi = min(n_rows, lo + a.groups - g0);
        if constexpr (WIDE) {
          for (int i = lo; i < hi; ++i)
            score_row_wide<RING>(s, kside, wr0 + i, so, kv, t0, T, hd, rowlen, scale, lane, live);
        } else {
          load_tile<CPL>(kside, tile, t0, T, kv * hd, rowlen, hd, hd, lane);
          int i = lo;
          if constexpr (CPL < kMaxCpl)  // at 8 channels a lane the tile leaves no room
            for (; i + 1 < hi; i += 2)
              score_rows<CPL, 2, RING>(s, tile, wr0 + i, so, t0, T, hd, scale, lane, live);
          for (; i < hi; ++i)
            score_rows<CPL, 1, RING>(s, tile, wr0 + i, so, t0, T, hd, scale, lane, live);
        }
        __syncwarp();
        load_tile<CPL>(vside, tile, t0, T, kv * hd + c0, rowlen, hc, hd, lane);
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          if (r >= lo && r < hi) update_row<CPL>(s, tile, acc[r], so + wr0 + r);
      }
      __syncwarp();  // the tile's p and alpha are read before the next tile's
    }
  });
  __syncthreads();

  const size_t part = static_cast<size_t>(b) * a.splits + split;
  // where ts > 1 the warp's rows go to its slice's fold over the dead words
  float* fold = reinterpret_cast<float*>(s.words);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i < n_rows) {
      float* dst = ts > 1 ? fold + (so + wr0 + i) * hd
                          : a.part_acc + (part * kg + r0 + wr0 + i) * hd + c0;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = chan<CPL>(lane, k);
        if (c < hc) dst[c] = acc[i][k];
      }
    }
  }
  if (ts == 1) {
    if (cc == 0)
      for (int j = tid; j < R; j += blockDim.x) {
        a.part_m[part * kg + r0 + j] = s.m[j];
        a.part_l[part * kg + r0 + j] = s.l[j];
      }
    return;
  }
  // fold the slices by the merge_softmax identity (ts = 1 where WIDE, so
  // the block owns every channel); a slice that saw no live token carries
  // (0, -1e30, 0) and adds nothing
  __syncthreads();
  for (int o = tid; o < R * hd; o += blockDim.x) {
    const int r = o / hd, c = o - r * hd;
    float mx = kMasked;
    for (int j = 0; j < ts; ++j) mx = fmaxf(mx, s.m[j * R + r]);
    float v = 0.f;
    for (int j = 0; j < ts; ++j) v += fold[(j * R + r) * hd + c] * expf(s.m[j * R + r] - mx);
    a.part_acc[(part * kg + r0 + r) * hd + c] = v;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    float mx = kMasked;
    for (int j = 0; j < ts; ++j) mx = fmaxf(mx, s.m[j * R + r]);
    float l = 0.f;
    for (int j = 0; j < ts; ++j) l += s.l[j * R + r] * expf(s.m[j * R + r] - mx);
    a.part_m[part * kg + r0 + r] = mx;
    a.part_l[part * kg + r0 + r] = l;
  }
}

// The batched pass decode alone, for holding it bit for bit against the
// decode kernel: writes the 16-bit words of the slots of tokens [0, n_valid)
// of every batch row (slot t * ppr + hg by head group hg, on grid axis z),
// split into runs as the attention splits them.
__global__ void __launch_bounds__(kAttnThreads, 1) decode_pages_kernel(AttnArgs a) {
  extern __shared__ int smem[];
  const AttnSmem s = carve(smem, a);
  const int b = blockIdx.y, hg = blockIdx.z, P = a.g.P;
  const int first = blockIdx.x * a.run, last = min(a.n_valid, first + a.run);
  const float inv_p = 1.0f / static_cast<float>(P);
  run_passes(a, s, b, hg, first, last, [&](int s0, int n_s) {
    for (int j = threadIdx.x; j < 2 * n_s * P; j += blockDim.x) {
      const int pg = div_exact(j, P, inv_p), p = j - pg * P;
      const int side = pg >= n_s, slot = pg - side * n_s;
      short* out = side ? a.out_v : a.out_k;
      out[((static_cast<size_t>(b) * a.n_valid + s0 + slot) * a.ppr + hg) * P + p] =
          static_cast<short>(s.words[buffer_page(pg, n_s, a.N) * P + p]);
    }
  });
}

// a float32 as bf16 bits, rounded to nearest even (NaN to the quiet 0x7FC0),
// as torch's .to(torch.bfloat16) rounds it
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0;
  return static_cast<unsigned short>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// One block per (batch row, kv, group): the merge_softmax identity over the
// row's splits.  All-masked splits carry (0, -1e30, 0), so a row with no
// valid token ends as m = -1e30, l = 0, acc = 0 exactly.
// TAIL: the row's query also scores the raw tail's pt tokens (one warp a
// token, a butterfly sum over the channels, the scale of attn_kernel), the
// tokens outside [lo, pos] masked to -1e30 and weighing 0 under the same
// guard; one max, one sum and one acc take the splits and the tail together,
// and the block writes acc / l as bf16 (dynamic shared memory: pt floats).
template <bool TAIL>
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(AttnArgs a) {
  extern __shared__ float tail_p[];  // TAIL: the tail's scores, then its weights
  const int kg = a.n_kv * a.groups;
  const int r = blockIdx.x, b = r / kg, hg = r - b * kg, kv = hg / a.groups;
  const size_t first = static_cast<size_t>(b) * a.splits;
  const size_t tail_row = static_cast<size_t>(a.n_kv) * a.hd;  // a tail token's words
  const size_t tail0 = static_cast<size_t>(b) * a.pt * tail_row + static_cast<size_t>(kv) * a.hd;
  float m = kMasked;
  for (int sp = 0; sp < a.splits; ++sp) m = fmaxf(m, a.part_m[(first + sp) * kg + hg]);
  if constexpr (TAIL) {
    const int lane = threadIdx.x & 31;
    const float* q = a.q + static_cast<size_t>(r) * a.hd;
    const float scale = 1.0f / sqrtf(static_cast<float>(a.hd));
    for (int t = threadIdx.x >> 5; t < a.pt; t += kMergeThreads / 32) {
      const unsigned short* k = a.k_tail + tail0 + t * tail_row;
      float dot = 0.f;
      for (int h = lane; h < a.hd; h += 32) dot = fmaf(q[h], bf16_word(k[h]), dot);
      for (int o = 16; o; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      const int p = a.cur * a.pt + t;
      if (lane == 0) tail_p[t] = p >= a.lo && p <= a.pos ? dot * scale : kMasked;
    }
    __syncthreads();
    for (int t = 0; t < a.pt; ++t) m = fmaxf(m, tail_p[t]);
    __syncthreads();  // every thread has the max before the scores become weights
    for (int t = threadIdx.x; t < a.pt; t += blockDim.x)
      tail_p[t] = tail_p[t] <= kMaskedGuard ? 0.f : expf(tail_p[t] - m);
    __syncthreads();
  }
  float l = 0.f;
  for (int sp = 0; sp < a.splits; ++sp) {
    const size_t j = (first + sp) * kg + hg;
    l += a.part_l[j] * expf(a.part_m[j] - m);
  }
  if constexpr (TAIL)
    for (int t = 0; t < a.pt; ++t) l += tail_p[t];
  for (int h = threadIdx.x; h < a.hd; h += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const size_t j = (first + sp) * kg + hg;
      acc += a.part_acc[j * a.hd + h] * expf(a.part_m[j] - m);
    }
    if constexpr (TAIL) {
      const unsigned short* v = a.v_tail + tail0 + h;
      for (int t = 0; t < a.pt; ++t) acc = fmaf(tail_p[t], bf16_word(v[t * tail_row]), acc);
      a.out[static_cast<size_t>(r) * a.hd + h] = bf16_bits(acc / l);
    } else {
      a.acc[static_cast<size_t>(r) * a.hd + h] = acc;
    }
  }
  if (!TAIL && threadIdx.x == 0) {
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
//          n_kv, groups, hd, pt, N (page slots per pass)
AttnArgs unpack_params(const int* ip) {
  AttnArgs a = {};
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
  a.N = x[9];
  a.ppr = row_pages(a.n_kv, a.hd, ip[1]);
  a.ts = token_slices(a.n_kv / (a.ppr > 1 ? a.ppr : 1) * a.groups, a.hd, a.N * a.pt);
  return a;
}

// ptrs: q, K blob (ptrs, deltas, out_vals, out_idx, n_out, profile), V blob
//       (the same six), bases, cls, meta, part_acc, part_m, part_l, then acc,
//       m, l (the state form) or k_tail, v_tail, out (the tail form)
AttnArgs unpack(const long long* ptr, const int* ip, bool tail = false) {
  AttnArgs a = unpack_params(ip);
  a.q = reinterpret_cast<const float*>(ptr[0]);
  a.k = blob_ptrs(ptr + 1);
  a.v = blob_ptrs(ptr + 7);
  a.bases = reinterpret_cast<const int*>(ptr[13]);
  a.cls = reinterpret_cast<const int*>(ptr[14]);
  a.g = page_geom(reinterpret_cast<const int*>(ptr[15]), ip);
  a.part_acc = reinterpret_cast<float*>(ptr[16]);
  a.part_m = reinterpret_cast<float*>(ptr[17]);
  a.part_l = reinterpret_cast<float*>(ptr[18]);
  if (tail) {
    a.k_tail = reinterpret_cast<const unsigned short*>(ptr[19]);
    a.v_tail = reinterpret_cast<const unsigned short*>(ptr[20]);
    a.out = reinterpret_cast<unsigned short*>(ptr[21]);
  } else {
    a.acc = reinterpret_cast<float*>(ptr[19]);
    a.m = reinterpret_cast<float*>(ptr[20]);
    a.l = reinterpret_cast<float*>(ptr[21]);
  }
  return a;
}

// the block's rows are those of a page's heads: n_kv / ppr of them a row
size_t smem_of(const int* ip) {
  const int* x = ip + kPageParams;
  const int rp = row_pages(x[5], x[7], ip[1]), ppr = rp > 1 ? rp : 1;
  return attn_smem_bytes(ip[1], ip[8], ip[9], ip[10], ip[4], ip[5], ip[6], x[5] / ppr * x[6], x[7],
                         x[9], x[8]);
}

using Kernel = void (*)(AttnArgs);

template <bool RING>
Kernel attn_kernel_for(int hd) {
  if (hd < 1) return nullptr;
  switch (cpl_of(hd)) {
    case 1: return attn_kernel<1, false, RING>;
    case 2: return attn_kernel<2, false, RING>;
    case 4: return attn_kernel<4, false, RING>;
    case 8: return attn_kernel<8, false, RING>;
    default: return attn_kernel<kMaxCpl, true, RING>;
  }
}

// 0, or -1 (no fit in shared memory), -2 (head_dim below 1), -3 (not
// 16-bit words), -4 (pass size outside 1..8), -5 (a row wider than a page
// that is not whole pages of whole heads, or such a row in a ring)
int check(const AttnArgs& a, size_t smem) {
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (a.hd < 1) return -2;
  if (a.g.word_bits != 16) return -3;
  if (a.N < 1 || a.N > kMaxPassSlots) return -4;
  if (a.ppr < 1) return -5;
  return 0;
}

// blocks on grid axis z: head groups x row chunks x channel chunks
int z_chunks(const AttnArgs& a) {
  const int kg = a.n_kv / a.ppr * a.groups, R = chunk_rows(kg, a.hd);
  return a.ppr * (R ? (kg + R - 1) / R : 1) * chan_chunks(a.hd);
}

template <bool RING>
int blocks_per_sm(const int* ip) {
  AttnArgs a = unpack_params(ip);
  a.g = page_geom(nullptr, ip);
  const size_t smem = smem_of(ip);
  const int rc = check(a, smem);
  if (rc) return rc;
  const Kernel k = attn_kernel_for<RING>(a.hd);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e) - 100;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kAttnThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e) - 100;
}

template <bool RING>
int launch(const AttnArgs& a, const int* ip, void* stream) {
  const size_t smem = smem_of(ip);
  const int rc = check(a, smem);
  if (rc) return rc;
  if (RING && a.ppr > 1) return -5;
  if (a.B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Kernel k = attn_kernel_for<RING>(a.hd);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<dim3(a.splits, a.B, z_chunks(a)), kAttnThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = a.B * a.n_kv * a.groups;
  if (a.out) {
    merge_kernel<true><<<rows, kMergeThreads, sizeof(float) * a.pt, st>>>(a);
  } else {
    merge_kernel<false><<<rows, kMergeThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long gbdi_paged_attn_smem_bytes(const int* ip) {
  return static_cast<long long>(smem_of(ip));
}

// Blocks of the attention kernel one SM holds at once (registers and shared
// memory both counted), or a negative code as gbdi_paged_attn_launch.
extern "C" int gbdi_paged_attn_blocks_per_sm(const int* ip) { return blocks_per_sm<false>(ip); }

// The same for the ring instantiation.
extern "C" int gbdi_paged_attn_ring_blocks_per_sm(const int* ip) { return blocks_per_sm<true>(ip); }

// Returns 0, a cudaError_t, or a negative code as check() above.
extern "C" int gbdi_paged_attn_launch(const long long* ptr, const int* ip, void* stream) {
  return launch<false>(unpack(ptr, ip), ip, stream);
}

// Ring mode: ring = {cur, lo} (pos / pt and pos - window + 1); the S page
// slots are the ring and n_valid is min(S, cur).  Returns as
// gbdi_paged_attn_launch.
extern "C" int gbdi_paged_attn_ring_launch(const long long* ptr, const int* ip, const int* ring,
                                           void* stream) {
  AttnArgs a = unpack(ptr, ip);
  a.cur = ring[0];
  a.lo = ring[1];
  return launch<true>(a, ip, stream);
}

// The tail form: ptrs as gbdi_paged_attn_launch with k_tail, v_tail and out
// in place of acc, m and l; tail = {pos, lo, ring}: the query's position, the
// first position that counts (0 for a full layer) and 1 where the S slots are
// a window's ring (n_valid is then min(S, pos / pt)).  Returns as
// gbdi_paged_attn_launch.
extern "C" int gbdi_paged_attn_tail_launch(const long long* ptr, const int* ip, const int* tail,
                                           void* stream) {
  AttnArgs a = unpack(ptr, ip, true);
  a.pos = tail[0];
  a.lo = tail[1];
  a.cur = a.pt > 0 ? a.pos / a.pt : 0;
  return tail[2] ? launch<true>(a, ip, stream) : launch<false>(a, ip, stream);
}

// The batched pass decode alone: words of page slots [0, n_valid).
// ptrs: K blob (six), V blob (six), bases, cls, meta, out_k, out_v
// (int16, (B, n_valid, P) each).  Returns as gbdi_paged_attn_launch.
extern "C" int gbdi_paged_attn_decode_launch(const long long* ptr, const int* ip, void* stream) {
  AttnArgs a = unpack_params(ip);
  a.k = blob_ptrs(ptr);
  a.v = blob_ptrs(ptr + 6);
  a.bases = reinterpret_cast<const int*>(ptr[12]);
  a.cls = reinterpret_cast<const int*>(ptr[13]);
  a.g = page_geom(reinterpret_cast<const int*>(ptr[14]), ip);
  a.out_k = reinterpret_cast<short*>(ptr[15]);
  a.out_v = reinterpret_cast<short*>(ptr[16]);
  const size_t smem = smem_of(ip);
  const int rc = check(a, smem);
  if (rc) return rc;
  if (a.B == 0 || a.n_valid == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(decode_pages_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_pages_kernel<<<dim3(a.splits, a.B, a.ppr), kAttnThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
