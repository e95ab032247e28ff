// The tensor-core form of the bitmap-filter verdict, shared by
// candidate_matrix_mxu (bitmap_filter.cu) and count_candidates_mxu
// (compaction.cu): the bit-plane inner product on wgmma s8, computed from
// the packed words, with the Eq. 2 verdict fused into the epilogue.
//
// The Hamming distance of two b-bit rows is ham = pc_r + pc_s - 2 <r, s>,
// with <r, s> the inner product of their {0, 1} bit planes.  So the Eq. 2
// test floor((lr + ls - ham) / 2) >= T becomes, in integers only,
//   2 <r, s> + (lr - pc_r) - 2 T >= pc_s - ls,
// and ub = min(.., lr, ls) >= T adds lr >= T and ls >= T.  T is the
// host-built prune table's entry (bounds.prune_table) at lr + ls, or lr * ls
// for cosine, as in verdict.cuh::verdict; no float reaches the device.
//
// Main loop: a persistent grid (one block of 640 threads an SM) walks
// 128 x 256 work tiles in row-major order.
//   * Warpgroup 0 is the producer.  Each of its 128 threads owns one R row
//     and two S rows of the tile: it loads their lengths (and the R row's
//     length window), then, four words (128 bits) a stage, loads the packed
//     words and expands each into 32 int8 {0, 1} bytes in 16 integer
//     operations ((w >> t) & 0x01010101 for t < 8: byte 4t + j is bit
//     8j + t; R and S share the order, so the inner product is the same),
//     stored straight into the 128-byte-swizzled K-major layout that the
//     wgmma descriptor (hopper.cuh::sw128_desc) reads.  Row popcounts come
//     from the same words (W popcounts a row, not a pair).  The next
//     stage's words are loaded before the current stage is expanded.  Rows
//     past NR or NS, and words past W, expand to zero; such rows read as
//     length 0.  Stores go through the generic proxy, so each thread fences
//     them for the async proxy (fence.proxy.async) before it arrives on the
//     stage's barrier.
//   * Warpgroups 1 to 4 are consumers, each a 64 x 128 quarter of the
//     tile: one wgmma m64n128k32 s8 a word, any W >= 1, 64 int32
//     accumulators a thread; then the verdict in the epilogue.  Four
//     consumers rather than two 64 x 256 ones: the epilogue is a chain of
//     dependent integer operations and a table load a pair, and 16 warps
//     hide its latency where 8 did not (PERF.md).
//   * A 3-stage ring of 48 KB stages (16 KB of R planes, 32 KB of S planes)
//     with full/empty mbarriers, and two slots of per-tile metadata (the
//     rows' lengths, popcount terms and windows, the columns' lengths and
//     popcount terms, a skip flag) with their own full/empty mbarriers, let
//     the producer run up to two tiles ahead of the consumers' epilogue.
//   * A tile whose outputs are all zero skips its main loop: in a self-join
//     every pair on or below the diagonal, no valid row or column, or (for
//     the count) no pair inside the length window (max ls < min lo, or
//     min ls > max hi).
//
// What it leaves on the table: the epilogue waits on the latency of its
// dependent chain (a table load, then compares) more than on issue slots;
// the consumers share one tile, so the tensor cores idle during the
// epilogue (ping-pong consumers on alternate tiles would overlap them);
// and the static walk gives a self-join's diagonal block no gain from the
// tiles it skips (each block keeps some of its four tiles).  Measured
// dead ends (PERF.md): two 64 x 256 consumers (8 warps: slower at
// W = 4), cp.async word prefetch several stages ahead (no faster), and two
// consumer teams ping-ponging 128 x 128 tiles so that one team's product
// overlaps the other's epilogue (no faster: the epilogue and the expansion
// share the integer pipe, which sets the pace).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace planes_mma {

constexpr int kBM = 128;                  // work tile rows: two consumer rows of 64
constexpr int kBN = 256;                  // work tile columns: two consumer columns of 128
constexpr int kCN = 128;                  // columns of a consumer's quarter
constexpr int kConsumers = 4;
constexpr int kWords = 4;                 // words a stage: 128 plane bytes a row
constexpr int kBK = 32 * kWords;          // the 128-byte swizzle span
constexpr int kStages = 3;
constexpr int kThreads = 128 * (1 + kConsumers);   // producer warpgroup + consumers
constexpr int kABytes = kBM * kBK;        // a stage of R planes
constexpr int kBBytes = kBN * kBK;        // a stage of S planes
constexpr int kPitchB = kCN + 16;         // bytes a row of a verdict staging tile
constexpr int kBig = 1 << 29;             // marks an empty row or column
constexpr int kProducerBar = 1 + kConsumers;   // named barrier of the producer warpgroup
constexpr int kConsumerWarps = 4 * kConsumers;

struct Meta {
  int4 row[kBM];   // lr, lr - pc_r (-kBig if lr <= 0), lo, hi - lo (lo = INT_MAX: no window)
  int2 col[kBN];   // ls, pc_s - ls (kBig if ls <= 0)
  int4 red[4];     // the producer warps' (min lo, max hi, min ls > 0, max ls)
  int skip;        // every output of the tile is zero
  int pad[3];
};

constexpr int kRingBytes = kStages * (kABytes + kBBytes);
constexpr int kMetaOff = kRingBytes;
constexpr int kStagingOff = kMetaOff + 2 * static_cast<int>(sizeof(Meta));
constexpr int kBarOff = kStagingOff + kConsumers * 64 * kPitchB;
constexpr int kSmemBytes = kBarOff + (2 * kStages + 4) * 8 + 1024;   // + alignment slack

struct Params {
  const uint32_t* wr;
  const uint32_t* ws;
  const int* len_r;
  const int* len_s;
  const int* lo;       // null: no length window
  const int* hi;
  const int* table;
  int nr, ns, w;
  int key_prod, self_join;
  int cutoff;          // max(cutoff, 0)
  int vec;             // 16-byte word loads: W % 4 == 0, both bases 16-byte aligned
  // count_candidates: int32[gr][gs] outputs of tile_r x tile_s tiles, zeroed.
  int tile_r, tile_s, gs;
  int aligned;         // tile_r % 8 == 0 and tile_s % 8 == 0
  int* out_win;
  int* out_cand;
  // candidate_matrix: bool[nr][ns].
  uint8_t* out;
};

// -- producer ----------------------------------------------------------------

__device__ __forceinline__ void load_words(const uint32_t* row, int k0, int nw, bool vec,
                                           uint32_t (&x)[kWords]) {
  if (row == nullptr) {
#pragma unroll
    for (int q = 0; q < kWords; ++q) x[q] = 0u;
  } else if (vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k0));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < kWords; ++q) x[q] = q < nw ? __ldg(row + k0 + q) : 0u;
  }
}

// Word kk of the stage into bytes 32 kk .. 32 kk + 31 of row r (whose
// 128 bytes start at `row_base`), 16-byte chunk c stored at chunk c ^ (r % 8).
__device__ __forceinline__ void expand_word(uint8_t* row_base, int r, int kk, uint32_t x) {
  const uint32_t m = 0x01010101u;
  const int sw = r & 7;
  *reinterpret_cast<uint4*>(row_base + (((2 * kk) ^ sw) << 4)) =
      make_uint4(x & m, (x >> 1) & m, (x >> 2) & m, (x >> 3) & m);
  *reinterpret_cast<uint4*>(row_base + (((2 * kk + 1) ^ sw) << 4)) =
      make_uint4((x >> 4) & m, (x >> 5) & m, (x >> 6) & m, (x >> 7) & m);
}

__device__ __forceinline__ void producer(const Params& p, uint8_t* ring_a, uint8_t* ring_b,
                                         Meta* metas, uint64_t* full, uint64_t* empty,
                                         uint64_t* meta_full, uint64_t* meta_empty,
                                         int tiles, int tiles_n) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nk = (p.w + kWords - 1) / kWords;
  int it = 0;
  int n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const int row0 = (tile / tiles_n) * kBM;
    const int col0 = (tile % tiles_n) * kBN;
    const int slot = n & 1;
    Meta& m = metas[slot];
    hopper::mbar_wait(meta_empty + slot, ((n >> 1) & 1) ^ 1);

    const int row = row0 + tid;
    int lr = 0, lo_e = INT_MAX, hi_e = INT_MIN;
    if (row < p.nr) {
      lr = max(__ldg(p.len_r + row), 0);
      if (lr > 0) {
        int lo = 1, hi = INT_MAX;
        if (p.lo != nullptr) {
          lo = max(__ldg(p.lo + row), 1);
          hi = __ldg(p.hi + row);
        }
        if (lo <= hi) lo_e = lo, hi_e = hi;
      }
    }
    m.row[tid] = make_int4(lr, 0, lo_e, lo_e <= hi_e ? hi_e - lo_e : 0);
    int ls[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = col0 + tid + 128 * q;
      ls[q] = col < p.ns ? max(__ldg(p.len_s + col), 0) : 0;
      m.col[tid + 128 * q] = make_int2(ls[q], 0);
    }
    const int4 red = make_int4(
        __reduce_min_sync(0xffffffffu, lo_e), __reduce_max_sync(0xffffffffu, hi_e),
        __reduce_min_sync(0xffffffffu, min(ls[0] > 0 ? ls[0] : INT_MAX,
                                           ls[1] > 0 ? ls[1] : INT_MAX)),
        __reduce_max_sync(0xffffffffu, max(ls[0], ls[1])));
    if (lane == 0) m.red[warp] = red;
    hopper::named_sync(kProducerBar, 128);
    int mn_lo = INT_MAX, mx_hi = INT_MIN, mn_ls = INT_MAX, mx_ls = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 v = m.red[k];
      mn_lo = min(mn_lo, v.x), mx_hi = max(mx_hi, v.y);
      mn_ls = min(mn_ls, v.z), mx_ls = max(mx_ls, v.w);
    }
    bool skip = mx_ls < mn_lo || mn_ls > mx_hi;
    if (p.self_join) skip = skip || min(col0 + kBN, p.ns) - 1 <= row0;
    if (tid == 0) m.skip = skip;
    hopper::mbar_arrive(meta_full + slot);
    if (skip) continue;

    const uint32_t* rows[3] = {
        row < p.nr ? p.wr + (size_t)row * p.w : nullptr,
        col0 + tid < p.ns ? p.ws + (size_t)(col0 + tid) * p.w : nullptr,
        col0 + tid + 128 < p.ns ? p.ws + (size_t)(col0 + tid + 128) * p.w : nullptr};
    uint32_t next[3][kWords];
#pragma unroll
    for (int q = 0; q < 3; ++q) load_words(rows[q], 0, min(kWords, p.w), p.vec, next[q]);
    int pc[3] = {0, 0, 0};
    for (int kt = 0; kt < nk; ++kt, ++it) {
      uint32_t cur[3][kWords];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int k = 0; k < kWords; ++k) cur[q][k] = next[q][k];
      if (kt + 1 < nk) {
        const int k1 = kWords * (kt + 1);
#pragma unroll
        for (int q = 0; q < 3; ++q) load_words(rows[q], k1, min(kWords, p.w - k1), p.vec, next[q]);
      }
      const int s = it % kStages;
      hopper::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
      uint8_t* dst[3] = {ring_a + s * kABytes + tid * kBK, ring_b + s * kBBytes + tid * kBK,
                         ring_b + s * kBBytes + (tid + 128) * kBK};
      // Words past W (in the last stage when W % 4 != 0) load as zero and
      // expand to zero planes, so every stage takes four unconditional
      // k-steps.
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          expand_word(dst[q], tid, k, cur[q][k]);   // (tid + 128) % 8 == tid % 8
          pc[q] += __popc(cur[q][k]);
        }
      }
      if (kt == nk - 1) {
        reinterpret_cast<int*>(&m.row[tid])[1] = lr > 0 ? lr - pc[0] : -kBig;
        m.col[tid].y = ls[0] > 0 ? pc[1] - ls[0] : kBig;
        m.col[tid + 128].y = ls[1] > 0 ? pc[2] - ls[1] : kBig;
      }
      hopper::fence_proxy_async_shared();
      hopper::mbar_arrive(full + s);
    }
  }
}

// -- consumers: the verdict ----------------------------------------------------

// The Eq. 2 verdict of one pair from its inner product `dot`, for a row
// (lr, ar = lr - pc_r, key = ka * ls + kb, cut) and a column (ls, nas =
// pc_s - ls).  `cut` is the row's cutoff test: a column passes when ls > cut
// (0 for a row past the cutoff, INT_MAX for an empty row).
__device__ __forceinline__ bool pair_passes(int dot, int lr, int ar, int ka, int kb, int cut,
                                            int ls, int nas, const int* __restrict__ table) {
  // An unsigned key: one 32 x 32 -> 64-bit multiply-add forms the address.
  const int t = __ldg(table + static_cast<unsigned>(ka * ls + kb));
  return (ls > cut) | ((lr >= t) & (ls >= t) & (2 * dot + ar - 2 * t >= nas));
}

struct RowTerms {
  int lr, ar, lo, range, ka, kb, cut, grow;
};

__device__ __forceinline__ RowTerms row_terms(const Params& p, const Meta& m, int rl,
                                              int row0) {
  const int4 r = m.row[rl];
  RowTerms t;
  t.lr = r.x, t.ar = r.y, t.lo = r.z, t.range = r.w;
  t.ka = p.key_prod ? r.x : 1;
  t.kb = p.key_prod ? 0 : r.x;
  t.cut = r.x <= 0 ? INT_MAX : (r.x > p.cutoff ? 0 : p.cutoff);
  t.grow = row0 + rl;
  return t;
}

// count_candidates: window pairs and candidates of this consumer's 64 x 128
// pairs (rows from row0 + 64 rh, columns from col0 + 128 ch), added to the
// outputs of their tile_r x tile_s tiles.  Lane (g, t) of warp w holds rows
// 16 w + g + 8 hr and columns 8 j + 2 t + e (hr, e < 2, j < 16).  kAligned
// (tile_r, tile_s multiples of 8): a warp's pairs at one (hr, j) share an
// output tile, so each thread sums in registers while the column tile is
// unchanged, then a warp reduction and one atomicAdd a tile and row half;
// otherwise each pair adds its own ones.
template <bool kTri, bool kAligned>
__device__ __forceinline__ void count_epilogue(const Params& p, const int (&acc)[64],
                                               const Meta& m, int row0, int col0, int rh,
                                               int ch, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  col0 += kCN * ch;
  RowTerms rt[2];
  int thr[2], ti[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rt[hr] = row_terms(p, m, 64 * rh + 16 * warp + 8 * hr + g, row0);
    thr[hr] = rt[hr].grow - col0 - 2 * t;   // pair (j, e) is above the diagonal: 8 j + e > thr
    ti[hr] = rt[hr].grow / p.tile_r;
  }
  const int4* cols = reinterpret_cast<const int4*>(m.col) + kCN / 2 * ch;
  // A thread's window pairs in the low 16 bits, its candidates in the high
  // ones: one select and one add a pair (at most 64 pairs between flushes).
  unsigned cnt[2] = {0, 0};
  int tj = col0 / p.tile_s;
  int rem = col0 - tj * p.tile_s;   // column of the tile where group j starts

  auto add = [&](int ti_, unsigned c) {
    const int w = static_cast<int>(__reduce_add_sync(0xffffffffu, c & 0xffffu));
    const int cc = static_cast<int>(__reduce_add_sync(0xffffffffu, c >> 16));
    if (lane == 0 && w != 0) {
      atomicAdd(p.out_win + (size_t)ti_ * p.gs + tj, w);
      if (cc != 0) atomicAdd(p.out_cand + (size_t)ti_ * p.gs + tj, cc);
    }
  };
  auto flush = [&]() {
    if (ti[0] == ti[1]) {
      add(ti[0], cnt[0] + cnt[1]);
    } else {
      add(ti[0], cnt[0]);
      add(ti[1], cnt[1]);
    }
    cnt[0] = cnt[1] = 0;
  };

#pragma unroll
  for (int j = 0; j < kCN / 8; ++j) {
    if (kAligned && rem >= p.tile_s) {   // warp-uniform: a new column tile
      flush();
      ++tj;
      rem -= p.tile_s;
    }
    const int4 cv = cols[4 * j + t];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const RowTerms& r = rt[hr];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ls = e ? cv.z : cv.x;
        const int nas = e ? cv.w : cv.y;
        bool win = static_cast<unsigned>(ls - r.lo) <= static_cast<unsigned>(r.range);
        if (kTri) win = win && 8 * j + e > thr[hr];
        const bool cand = win & pair_passes(acc[4 * j + 2 * hr + e], r.lr, r.ar, r.ka, r.kb,
                                            r.cut, ls, nas, p.table);
        if (kAligned) {
          if (win) cnt[hr] += cand ? 0x10001u : 1u;
        } else if (win) {
          const size_t o = (size_t)ti[hr] * p.gs + (col0 + 8 * j + 2 * t + e) / p.tile_s;
          atomicAdd(p.out_win + o, 1);
          if (cand) atomicAdd(p.out_cand + o, 1);
        }
      }
    }
    rem += 8;
  }
  if (kAligned) flush();
}

// candidate_matrix: this consumer's 64 x 128 verdicts as bytes into its
// staging tile (rows padded to kPitchB bytes: conflict-free 2-byte stores).
template <bool kTri>
__device__ __forceinline__ void candidate_epilogue(const Params& p, const int (&acc)[64],
                                                   const Meta& m, uint8_t* stage, int row0,
                                                   int col0, int rh, int ch, int warp,
                                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
  RowTerms rt[2];
  int thr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rt[hr] = row_terms(p, m, 64 * rh + 16 * warp + 8 * hr + g, row0);
    thr[hr] = rt[hr].grow - col0 - kCN * ch - 2 * t;
  }
  const int4* cols = reinterpret_cast<const int4*>(m.col) + kCN / 2 * ch;
#pragma unroll
  for (int j = 0; j < kCN / 8; ++j) {
    const int4 cv = cols[4 * j + t];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const RowTerms& r = rt[hr];
      bool p0 = pair_passes(acc[4 * j + 2 * hr], r.lr, r.ar, r.ka, r.kb, r.cut, cv.x, cv.y,
                            p.table);
      bool p1 = pair_passes(acc[4 * j + 2 * hr + 1], r.lr, r.ar, r.ka, r.kb, r.cut, cv.z,
                            cv.w, p.table);
      if (kTri) {
        p0 = p0 && 8 * j > thr[hr];
        p1 = p1 && 8 * j + 1 > thr[hr];
      }
      *reinterpret_cast<uint16_t*>(stage + (16 * warp + 8 * hr + g) * kPitchB + 8 * j + 2 * t) =
          static_cast<uint16_t>((p0 ? 1u : 0u) | (p1 ? 0x100u : 0u));
    }
  }
}

// The staging tile's rows into out[row_base + r][col_base ..], masked at NR
// and NS: 16-byte stores (8 threads a row's 128 bytes) when NS % 16 == 0,
// else a warp a row, a byte a lane.
__device__ __forceinline__ void store_verdicts(const Params& p, const uint8_t* stage,
                                               int row_base, int col0, int tid) {
  const int rows = min(64, p.nr - row_base);
  const int cols = min(kCN, p.ns - col0);
  if ((p.ns & 15) == 0) {
#pragma unroll 4
    for (int idx = tid; idx < 64 * (kCN / 16); idx += 128) {
      const int r = idx / (kCN / 16);
      const int q = idx - r * (kCN / 16);
      if (r < rows && 16 * q < cols)
        *reinterpret_cast<int4*>(p.out + (size_t)(row_base + r) * p.ns + col0 + 16 * q) =
            *reinterpret_cast<const int4*>(stage + r * kPitchB + 16 * q);
    }
  } else {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < rows; r += 4)
      for (int cc = lane; cc < cols; cc += 32)
        p.out[(size_t)(row_base + r) * p.ns + col0 + cc] = stage[r * kPitchB + cc];
  }
}

template <bool kCount>
__device__ __forceinline__ void consumer(const Params& p, uint8_t* ring_a, uint8_t* ring_b,
                                         const Meta* metas, uint8_t* staging, uint64_t* full,
                                         uint64_t* empty, uint64_t* meta_full,
                                         uint64_t* meta_empty, int tiles, int tiles_n) {
  const int c = threadIdx.x / 128 - 1;
  const int rh = c & 1, ch = c >> 1;   // the consumer's row and column half of the tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  uint8_t* stage = staging + c * 64 * kPitchB;
  const int nk = (p.w + kWords - 1) / kWords;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int it = 0;
  int n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const int row0 = (tile / tiles_n) * kBM;
    const int col0 = (tile % tiles_n) * kBN;
    const int slot = n & 1;
    const Meta& m = metas[slot];
    hopper::mbar_wait(meta_full + slot, (n >> 1) & 1);
    const bool skip = m.skip != 0;
    if (!skip) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(full + s, (it / kStages) & 1);
        const uint32_t a_base = hopper::smem_addr(ring_a + s * kABytes) + rh * 64 * kBK;
        const uint32_t b_base = hopper::smem_addr(ring_b + s * kBBytes) + ch * kCN * kBK;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWords; ++kk)
          hopper::wgmma_m64n128k32_s8(acc, hopper::sw128_desc(a_base + 32 * kk),
                                      hopper::sw128_desc(b_base + 32 * kk), kt > 0 || kk > 0);
        hopper::wgmma_commit();
        // The previous stage's group is done: release its stage.
        hopper::wgmma_wait<1>();
        hopper::fence_regs(acc);
        if (kt > 0 && lane == 0) hopper::mbar_arrive(empty + (it - 1) % kStages);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % kStages);
    }

    const bool tri = p.self_join && col0 < row0 + kBM;   // the tile meets the diagonal
    if (kCount) {
      if (!skip) {
        if (p.aligned) {
          if (tri) count_epilogue<true, true>(p, acc, m, row0, col0, rh, ch, warp, lane);
          else count_epilogue<false, true>(p, acc, m, row0, col0, rh, ch, warp, lane);
        } else {
          if (tri) count_epilogue<true, false>(p, acc, m, row0, col0, rh, ch, warp, lane);
          else count_epilogue<false, false>(p, acc, m, row0, col0, rh, ch, warp, lane);
        }
      }
    } else {
      // The previous tile's stores have read the staging tile.
      hopper::named_sync(1 + c, 128);
      if (skip) {
#pragma unroll 4
        for (int idx = tid; idx < 64 * (kCN / 16); idx += 128) {
          const int r = idx / (kCN / 16);
          *reinterpret_cast<int4*>(stage + r * kPitchB + 16 * (idx - r * (kCN / 16))) =
              make_int4(0, 0, 0, 0);
        }
      } else if (tri) {
        candidate_epilogue<true>(p, acc, m, stage, row0, col0, rh, ch, warp, lane);
      } else {
        candidate_epilogue<false>(p, acc, m, stage, row0, col0, rh, ch, warp, lane);
      }
      hopper::named_sync(1 + c, 128);
      store_verdicts(p, stage, row0 + 64 * rh, col0 + kCN * ch, tid);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(meta_empty + slot);
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, 1) planes_verdict_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte aligned by an offset from the shared array itself, so that
  // every access below compiles to LDS / STS (through an integer cast the
  // compiler loses the address space and emits generic loads and stores).
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = smem;
  uint8_t* ring_b = smem + kStages * kABytes;
  Meta* metas = reinterpret_cast<Meta*>(smem + kMetaOff);
  uint8_t* staging = smem + kStagingOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* meta_full = empty + kStages;
  uint64_t* meta_empty = meta_full + 2;

  const int tiles_n = (p.ns + kBN - 1) / kBN;
  const int tiles = ((p.nr + kBM - 1) / kBM) * tiles_n;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 128);   // every producer thread, after its stores
      hopper::mbar_init(empty + s, kConsumerWarps);   // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(meta_full + s, 128);
      hopper::mbar_init(meta_empty + s, kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // 640 threads launch with 96 registers each (61,440 in all), and
  // setmaxnreg can only move registers within that: the consumers take what
  // the producer gives back (128 x 56 + 512 x 104 = 60,416).
  if (threadIdx.x < 128) {
    hopper::reg_dealloc<56>();
    producer(p, ring_a, ring_b, metas, full, empty, meta_full, meta_empty, tiles, tiles_n);
  } else {
    hopper::reg_alloc<104>();
    consumer<kCount>(p, ring_a, ring_b, metas, staging, full, empty, meta_full, meta_empty,
                     tiles, tiles_n);
  }
}

// Fills in the grid-independent fields and launches on `stream`; returns
// cudaGetLastError() after the launch (0 on success).
template <bool kCount>
inline int launch(Params p, cudaStream_t stream) {
  if (p.nr <= 0 || p.ns <= 0) return 0;
  p.cutoff = max(p.cutoff, 0);
  p.vec = (p.w % kWords == 0) && (reinterpret_cast<uintptr_t>(p.wr) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(p.ws) % 16 == 0);
  const cudaError_t err = cudaFuncSetAttribute(
      planes_verdict_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long tiles = (long long)((p.nr + kBM - 1) / kBM) * ((p.ns + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  planes_verdict_kernel<kCount><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace planes_mma
