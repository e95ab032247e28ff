// candidate_matrix: the fused bitmap-filter verdict of every (r, s) pair, in
// two forms (candidate_matrix_launch, and candidate_matrix_mxu_launch at the
// end of the file), and hamming_matrix: the raw all-pairs Hamming distance.
//
// Both candidate_matrix forms replace the TPU kernel
// src/repro/kernels/bitmap_filter.py candidate_matrix_pallas (body
// _make_candidate_kernel, _tile_verdict).
// out[i][j] = (Eq. 2 bound >= prune_table[key] OR lr > cutoff OR ls > cutoff)
//             AND lr > 0 AND ls > 0 [AND i < j for a self-join]
// over uint32 words wr[NR][W], ws[NS][W] and int32 lengths; one byte (a
// torch.bool) per pair.
//
// What bounds the SWAR form on an H100: per pair, W XORs, W popcounts and
// W adds, plus about ten integer operations of verdict; __popc issues at a
// quarter of the int32 rate, so at W = 4 the popcounts, not the memory,
// set the pace.  The only large traffic is the bool output (NR*NS bytes,
// 16.8 MB for a 4096 x 4096 block pair); the words are read from L2/shared
// memory many times but amount to NR*W*4 + NS*W*4 bytes.
//
// Design: one block of 256 threads per 64 x 64 pairs, each thread 4 x 4 pairs
// in registers, so each word staged in shared memory feeds four popcounts;
// the threshold is an int32 table lookup (no float on the device, so no FMA
// can move an ulp); each warp's stores of a row land in 16 consecutive bytes.
// Packing the verdict into bits, wider per-thread tiles and fusing the
// compaction are left to later work.
#include "planes_mma.cuh"
#include "verdict.cuh"

namespace bitmap_join {

__global__ void __launch_bounds__(kThreads)
candidate_matrix_kernel(const uint32_t* __restrict__ wr,
                        const uint32_t* __restrict__ ws,
                        const int* __restrict__ len_r,
                        const int* __restrict__ len_s,
                        const int* __restrict__ table,
                        int nr, int ns, int w, int key_prod, int self_join,
                        int cutoff, uint8_t* __restrict__ out) {
  __shared__ Staging sm;
  const int row0 = blockIdx.y * kSub;
  const int col0 = blockIdx.x * kSub;
  int acc[kPer][kPer];
  subtile_hamming(wr, ws, len_r, len_s, nullptr, nullptr, w, row0, nr, col0,
                  ns, sm, acc);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int li = threadIdx.y + 16 * i;
    const int row = row0 + li;
    if (row >= nr) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int lj = threadIdx.x + 16 * j;
      const int col = col0 + lj;
      if (col >= ns) continue;
      bool c = verdict(acc[i][j], sm.lr[li], sm.ls[lj], table, key_prod, cutoff);
      if (self_join) c = c && row < col;
      out[(size_t)row * ns + col] = c ? 1 : 0;
    }
  }
}

// hamming_matrix replaces src/repro/kernels/bitmap_filter.py
// hamming_matrix_pallas (_hamming_kernel, _tile_hamming): out[i][j] =
// sum_k popcount(wr[i][k] ^ ws[j][k]) as int32.  Same tiling and staging
// as candidate_matrix; the accumulator is written out instead of a verdict.
// What bounds it: the popcounts at small W, as for candidate_matrix, but
// the output is 4 bytes a pair (67 MB for 4096 x 4096), so at W = 4 the
// int32 stores come close to the memory bound as well.
__global__ void __launch_bounds__(kThreads)
hamming_matrix_kernel(const uint32_t* __restrict__ wr,
                      const uint32_t* __restrict__ ws,
                      int nr, int ns, int w, int* __restrict__ out) {
  __shared__ Staging sm;
  const int row0 = blockIdx.y * kSub;
  const int col0 = blockIdx.x * kSub;
  int acc[kPer][kPer];
  subtile_hamming(wr, ws, nullptr, nullptr, nullptr, nullptr, w, row0, nr,
                  col0, ns, sm, acc);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = row0 + threadIdx.y + 16 * i;
    if (row >= nr) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = col0 + threadIdx.x + 16 * j;
      if (col < ns) out[(size_t)row * ns + col] = acc[i][j];
    }
  }
}

}  // namespace bitmap_join

// Launches on `stream`; allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int candidate_matrix_launch(const void* wr, const void* ws,
                                       const void* len_r, const void* len_s,
                                       const void* table, int nr, int ns, int w,
                                       int key_prod, int self_join, int cutoff,
                                       void* out, void* stream) {
  using namespace bitmap_join;
  if (nr <= 0 || ns <= 0) return 0;
  const dim3 grid((ns + kSub - 1) / kSub, (nr + kSub - 1) / kSub);
  const dim3 block(16, 16);
  candidate_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wr), static_cast<const uint32_t*>(ws),
      static_cast<const int*>(len_r), static_cast<const int*>(len_s),
      static_cast<const int*>(table), nr, ns, w, key_prod, self_join, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out is int32[nr][ns].  Launches on `stream`; returns cudaGetLastError().
extern "C" int hamming_matrix_launch(const void* wr, const void* ws, int nr,
                                     int ns, int w, void* out, void* stream) {
  using namespace bitmap_join;
  if (nr <= 0 || ns <= 0) return 0;
  const dim3 grid((ns + kSub - 1) / kSub, (nr + kSub - 1) / kSub);
  const dim3 block(16, 16);
  hamming_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wr), static_cast<const uint32_t*>(ws), nr,
      ns, w, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// candidate_matrix_mxu: the same verdicts from the tensor cores
// (planes_mma.cuh), the form ops.candidate_matrix runs on the card.
//
// What bounds it on an H100: at the blocked join's 4096 x 4096 block pair
// its bool output (16.8 MB, 5.0 us at 3.35 TB/s) at W = 4, and the
// bit-plane product (17.4 us at the int8 tensor rate) at W = 32, where it
// takes the place of unpacking both sides, bitplane_hamming's int32 matrix
// (67 MB) and an elementwise verdict in PyTorch.  The SWAR form above
// issues W popcounts a pair at a quarter of the int32 rate.
//
// Design: the product on wgmma s8 from the packed words, the verdict in the
// epilogue (one table lookup and three compares a pair, the triangle only on
// tiles that meet the diagonal), each consumer's 64 x 256 bytes staged in
// shared memory and written as 16-byte stores, 256 contiguous bytes a row
// (a byte a lane when NS % 16 breaks their alignment), masked at NR and NS.
// Tiles entirely on or below the diagonal of a self-join, or with no
// non-empty row or column, skip the product and store zeros.
// out is bool[nr][ns].  Launches on `stream`, allocates nothing and does
// not synchronise; returns cudaGetLastError().
extern "C" int candidate_matrix_mxu_launch(const void* wr, const void* ws, const void* len_r,
                                           const void* len_s, const void* table, int nr,
                                           int ns, int w, int key_prod, int self_join,
                                           int cutoff, void* out, void* stream) {
  planes_mma::Params p{};
  p.wr = static_cast<const uint32_t*>(wr);
  p.ws = static_cast<const uint32_t*>(ws);
  p.len_r = static_cast<const int*>(len_r);
  p.len_s = static_cast<const int*>(len_s);
  p.table = static_cast<const int*>(table);
  p.nr = nr, p.ns = ns, p.w = w;
  p.key_prod = key_prod, p.self_join = self_join, p.cutoff = cutoff;
  p.out = static_cast<uint8_t*>(out);
  return planes_mma::launch<false>(p, static_cast<cudaStream_t>(stream));
}
