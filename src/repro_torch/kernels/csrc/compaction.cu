// count_candidates: the tile-count prepass of the device-resident join, in
// two forms (count_candidates_launch and count_candidates_mxu_launch below).
//
// Both replace the TPU kernel src/repro/kernels/compaction.py
// count_candidates_pallas (body _make_count_kernel, sharing _tile_verdict
// with candidate_matrix_pallas).  For each tile_r x tile_s tile of the pair
// grid it writes two int32 counts:
//   win  = #pairs with lr > 0, ls > 0, lo[i] <= ls <= hi[i] (when `window`)
//          and i < j (for a self-join);
//   cand = #of those that also pass the candidate_matrix verdict.
//
// What bounds the SWAR form on an H100: the same per-pair work as
// candidate_matrix (W XOR + popcount + add, then the verdict) plus the
// window and triangle tests, with no large output at all: two ints per
// tile.  Popcount issue rate bounds it; the memory traffic is the word rows
// and lengths only.
//
// Design: one block of 256 threads per output tile, walking the tile's
// 64 x 64 sub-tiles with the candidate kernel's staging (verdict.cuh); each
// thread counts in registers, then a warp-shuffle and shared-memory
// reduction ends in one store per output.  The order of the sums is fixed,
// so the result is deterministic and needs no atomics.
#include "planes_mma.cuh"
#include "verdict.cuh"

namespace bitmap_join {

__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int tid = threadIdx.y * 16 + threadIdx.x;
  __syncthreads();  // scratch is free from an earlier call
  if ((tid & 31) == 0) scratch[tid >> 5] = v;
  __syncthreads();
  int total = 0;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) total += scratch[k];
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
count_candidates_kernel(const uint32_t* __restrict__ wr,
                        const uint32_t* __restrict__ ws,
                        const int* __restrict__ len_r,
                        const int* __restrict__ len_s,
                        const int* __restrict__ lo,
                        const int* __restrict__ hi,
                        const int* __restrict__ table,
                        int nr, int ns, int w, int key_prod, int self_join,
                        int cutoff, int tile_r, int tile_s,
                        int* __restrict__ out_win, int* __restrict__ out_cand) {
  __shared__ Staging sm;
  __shared__ int scratch[kThreads / 32];
  const int tr0 = blockIdx.y * tile_r;
  const int ts0 = blockIdx.x * tile_s;
  const int row_end = min(nr, tr0 + tile_r);
  const int col_end = min(ns, ts0 + tile_s);
  int n_win = 0, n_cand = 0;
  for (int row0 = tr0; row0 < row_end; row0 += kSub) {
    for (int col0 = ts0; col0 < col_end; col0 += kSub) {
      int acc[kPer][kPer];
      subtile_hamming(wr, ws, len_r, len_s, lo, hi, w, row0, row_end, col0,
                      col_end, sm, acc);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int li = threadIdx.y + 16 * i;
        const int lr = sm.lr[li];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int lj = threadIdx.x + 16 * j;
          const int ls = sm.ls[lj];
          // Rows and columns past the tile's end read as length 0 and
          // count in neither output.
          bool in = lr > 0 && ls > 0;
          if (lo != nullptr) in = in && ls >= sm.lo[li] && ls <= sm.hi[li];
          if (self_join) in = in && row0 + li < col0 + lj;
          n_win += in;
          n_cand += in && verdict(acc[i][j], lr, ls, table, key_prod, cutoff);
        }
      }
    }
  }
  const int win_total = block_sum(n_win, scratch);
  const int cand_total = block_sum(n_cand, scratch);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const size_t t = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    out_win[t] = win_total;
    out_cand[t] = cand_total;
  }
}

}  // namespace bitmap_join

// Launches on `stream`; allocates nothing and does not synchronise.  lo and
// hi are null when the length window is off.  out_win/out_cand are
// int32[ceil(nr/tile_r)][ceil(ns/tile_s)].  Returns cudaGetLastError().
extern "C" int count_candidates_launch(const void* wr, const void* ws,
                                       const void* len_r, const void* len_s,
                                       const void* lo, const void* hi,
                                       const void* table, int nr, int ns, int w,
                                       int key_prod, int self_join, int cutoff,
                                       int tile_r, int tile_s, void* out_win,
                                       void* out_cand, void* stream) {
  using namespace bitmap_join;
  if (nr <= 0 || ns <= 0) return 0;
  const dim3 grid((ns + tile_s - 1) / tile_s, (nr + tile_r - 1) / tile_r);
  const dim3 block(16, 16);
  count_candidates_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wr), static_cast<const uint32_t*>(ws),
      static_cast<const int*>(len_r), static_cast<const int*>(len_s),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const int*>(table), nr, ns, w, key_prod, self_join, cutoff,
      tile_r, tile_s, static_cast<int*>(out_win), static_cast<int*>(out_cand));
  return static_cast<int>(cudaGetLastError());
}

// count_candidates_mxu: the same counts from the tensor cores
// (planes_mma.cuh), the form ops.count_candidates runs on the card.
//
// What bounds it on an H100: at the blocked join's 4096 x 4096 block pair,
// the per-pair epilogue (the window, the triangle, the verdict and the two
// sums: about 17 integer operations a pair, 4.3 us at 67 T/s) at W = 4, and
// the bit-plane product (2 NR NS b operations at the int8 tensor rate of
// 1,979 T/s, 17.4 us) at W = 32.  The SWAR form above issues W popcounts a
// pair at a quarter of the int32 rate: a floor of 16 us at W = 4 and 128 us
// at W = 32 that no tuning of it removes.
//
// Design: the product runs on wgmma s8 from the packed words (expanded to
// bit planes in shared memory by the producer warpgroup), and the
// epilogue takes the whole test in integers: a window check as one unsigned
// compare against the row's [lo, hi], the triangle only on tiles that meet
// the diagonal, the verdict as three compares after one table lookup.  A
// warp's pairs at one accumulator column group share an output tile when
// tile_r and tile_s are multiples of 8, so each thread sums in registers,
// and one warp reduction and one atomicAdd a tile and row half carry the
// sums into the zeroed outputs (any other tile: an atomicAdd a pair).
// Integer sums are exact in any order, so the counts are deterministic.
// Work tiles whose pairs all fail the window or the triangle are skipped.
// out_win/out_cand must be zeroed.  Launches on `stream`, allocates nothing
// and does not synchronise; returns cudaGetLastError().
extern "C" int count_candidates_mxu_launch(const void* wr, const void* ws, const void* len_r,
                                           const void* len_s, const void* lo, const void* hi,
                                           const void* table, int nr, int ns, int w,
                                           int key_prod, int self_join, int cutoff,
                                           int tile_r, int tile_s, void* out_win,
                                           void* out_cand, void* stream) {
  planes_mma::Params p{};
  p.wr = static_cast<const uint32_t*>(wr);
  p.ws = static_cast<const uint32_t*>(ws);
  p.len_r = static_cast<const int*>(len_r);
  p.len_s = static_cast<const int*>(len_s);
  p.lo = static_cast<const int*>(lo);
  p.hi = static_cast<const int*>(hi);
  p.table = static_cast<const int*>(table);
  p.nr = nr, p.ns = ns, p.w = w;
  p.key_prod = key_prod, p.self_join = self_join, p.cutoff = cutoff;
  p.tile_r = tile_r, p.tile_s = tile_s, p.gs = (ns + tile_s - 1) / tile_s;
  p.aligned = tile_r % 8 == 0 && tile_s % 8 == 0;
  p.out_win = static_cast<int*>(out_win);
  p.out_cand = static_cast<int*>(out_cand);
  return planes_mma::launch<true>(p, static_cast<cudaStream_t>(stream));
}
