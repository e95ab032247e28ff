// Shared tile machinery of the bitmap-filter kernels (bitmap_filter.cu,
// compaction.cu): a 64x64 sub-tile of pairs, its Hamming distances and the
// fused Eq. 2 verdict, which the pairwise kernels (postings.cu) share too.
//
// Layout: 256 threads as 16x16; thread (ty, tx) owns the 4x4 pairs
// (row0 + ty + 16*i, col0 + tx + 16*j).  Word rows of R and S are staged in
// shared memory in chunks of up to 32 words (W = b/32 is 4 at b = 128 and
// 128 at b = 4096), padded to 33 words a row so that the 16 threads reading
// 16 different S rows hit 16 different banks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bitmap_join {

constexpr int kSub = 64;          // sub-tile side, in pairs
constexpr int kThreads = 256;     // 16 x 16
constexpr int kPer = kSub / 16;   // pairs per thread along each side
constexpr int kChunk = 32;        // words staged per pass

struct Staging {
  uint32_t r[kSub][kChunk + 1];
  uint32_t s[kSub][kChunk + 1];
  int lr[kSub];
  int ls[kSub];
  int lo[kSub];
  int hi[kSub];
};

// Hamming distances of the sub-tile at (row0, col0) into acc.  Rows at or
// past row_end and columns at or past col_end read as empty (zero words,
// length 0), so they never pass a verdict or a window.  lo/hi may be null;
// len_r/len_s may be null too (hamming_matrix), and then read as 0.
__device__ __forceinline__ void subtile_hamming(
    const uint32_t* __restrict__ wr, const uint32_t* __restrict__ ws,
    const int* __restrict__ len_r, const int* __restrict__ len_s,
    const int* __restrict__ lo, const int* __restrict__ hi,
    int w, int row0, int row_end, int col0, int col_end,
    Staging& sm, int (&acc)[kPer][kPer]) {
  const int tid = threadIdx.y * 16 + threadIdx.x;
  __syncthreads();  // the previous sub-tile's readers are done with sm
  if (tid < kSub) {
    const int g = row0 + tid;
    const bool in = g < row_end;
    sm.lr[tid] = in && len_r != nullptr ? len_r[g] : 0;
    if (lo != nullptr) {
      sm.lo[tid] = in ? lo[g] : 0;
      sm.hi[tid] = in ? hi[g] : 0;
    }
  } else if (tid < 2 * kSub) {
    const int g = col0 + tid - kSub;
    sm.ls[tid - kSub] = g < col_end && len_s != nullptr ? len_s[g] : 0;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < w; k0 += kChunk) {
    const int wc = min(kChunk, w - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int idx = tid; idx < kSub * wc; idx += kThreads) {
      const int row = idx / wc;
      const int k = idx - row * wc;
      const int gr = row0 + row;
      const int gc = col0 + row;
      sm.r[row][k] = gr < row_end ? wr[(size_t)gr * w + k0 + k] : 0u;
      sm.s[row][k] = gc < col_end ? ws[(size_t)gc * w + k0 + k] : 0u;
    }
    __syncthreads();
    for (int k = 0; k < wc; ++k) {
      uint32_t rv[kPer], sv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) rv[i] = sm.r[threadIdx.y + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kPer; ++j) sv[j] = sm.s[threadIdx.x + 16 * j][k];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] += __popc(rv[i] ^ sv[j]);
    }
  }
  __syncthreads();  // lengths and windows are visible even when w == 0
}

// Eq. 2 bound min((lr + ls - ham) >> 1, min(lr, ls)) against the host-built
// integer prune table (key lr*ls for cosine, lr+ls otherwise), OR either
// length past the Alg. 7 cutoff; AND both lengths positive.  The arithmetic
// shift is the reference's floor division.
__device__ __forceinline__ bool verdict(int ham, int lr, int ls,
                                        const int* __restrict__ table,
                                        int key_prod, int cutoff) {
  if (lr <= 0 || ls <= 0) return false;
  if (lr > cutoff || ls > cutoff) return true;
  const int ub = min((lr + ls - ham) >> 1, min(lr, ls));
  const int key = key_prod ? lr * ls : lr + ls;
  return ub >= __ldg(table + key);
}

}  // namespace bitmap_join
