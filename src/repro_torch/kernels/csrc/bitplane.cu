// bitplane_hamming: the all-pairs Hamming distance of {0, 1} int8 bit planes
// on the int8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/bitplane.py
// bitplane_hamming_pallas (_bitplane_kernel): with planes pr[NR][b],
// ps[NS][b] (one byte per bit) and int32 row popcounts,
//   out[i][j] = pc_r[i] + pc_s[j] - 2 * sum_k pr[i][k] * ps[j][k]
// exactly, as int32.  The TPU kernel exists to put this product on the
// matrix unit; here it goes to the tensor cores through the warp-level
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
//
// What bounds it on an H100 (published peaks, 700 W): 2*NR*NS*b operations
// at the dense int8 tensor rate of 1,979 T/s against (NR + NS)*b bytes of
// planes read plus 4*NR*NS bytes of int32 output written at 3.35 TB/s.  At
// a 4096 x 4096 block pair and b = 1024 that is 17.4 us of operations and
// 22.5 us of memory, 20.0 us of it the output: the int32 Hamming matrix, not
// the product, bounds it.
//
// Design (simple and right first): a block of 4 warps owns a 64 x 64 output
// tile; each warp a 32 x 32 quarter, as 2 x 4 m16n8 tiles held in 32
// int32 registers.  The block stages 64 rows x kChunk bytes of each side in
// shared memory with 16-byte loads (rows past the edge read as zero), then
// walks the chunk in k-steps of 32 bytes.  Both operands are K-contiguous
// rows: pr is A in row layout and ps is B in column layout, so no transpose
// is needed.  Rows are padded by 16 bytes, so the 8 rows x 4 words a warp
// reads for one fragment fall in 32 different banks.  The epilogue adds the
// popcounts and masks the ragged edge.  ldmatrix, cp.async double
// buffering, wgmma and a fused verdict epilogue are left to later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace bitplane {

constexpr int kTile = 64;               // output tile side
constexpr int kThreads = 128;           // 4 warps, 2 x 2 over the tile
constexpr int kChunk = 128;             // K bytes staged per pass
constexpr int kPitch = kChunk + 16;     // shared row pitch, bytes

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
bitplane_hamming_kernel(const int8_t* __restrict__ pr,
                        const int8_t* __restrict__ ps,
                        const int* __restrict__ pc_r,
                        const int* __restrict__ pc_s, int nr, int ns, int b,
                        int* __restrict__ out) {
  __shared__ __align__(16) uint8_t sa[kTile * kPitch];
  __shared__ __align__(16) uint8_t sb[kTile * kPitch];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // groupID
  const int t = lane & 3;           // threadID_in_group
  const int wm = (warp >> 1) * 32;  // the warp's quarter of the tile
  const int wn = (warp & 1) * 32;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;

  for (int k0 = 0; k0 < b; k0 += kChunk) {
    const int kc = min(kChunk, b - k0);  // a multiple of 32
    const int vecs = kc >> 4;            // 16-byte vectors per row
    __syncthreads();                     // the previous chunk is consumed
    for (int idx = tid; idx < kTile * vecs; idx += kThreads) {
      const int row = idx / vecs;
      const int v = idx - row * vecs;
      const int gr = row0 + row;
      const int gc = col0 + row;
      const int4 zero = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(sa + row * kPitch + v * 16) =
          gr < nr ? __ldg(reinterpret_cast<const int4*>(pr + (size_t)gr * b + k0) + v)
                  : zero;
      *reinterpret_cast<int4*>(sb + row * kPitch + v * 16) =
          gc < ns ? __ldg(reinterpret_cast<const int4*>(ps + (size_t)gc * b + k0) + v)
                  : zero;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 32) {
      // A fragment (16 x 32, row): a0 = (g, 4t..4t+3), a1 = (g+8, same),
      // a2 = (g, 16+4t..), a3 = (g+8, 16+4t..).  B fragment (32 x 8, col):
      // b0 = k 4t..4t+3 of column g, b1 = k 16+4t.. of column g.
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* base = sa + (wm + mi * 16 + g) * kPitch + kk + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kPitch);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kPitch + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* base = sb + (wn + ni * 8 + g) * kPitch + kk + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }

  // Accumulator (16 x 8): c0, c1 at row g, columns 2t and 2t+1; c2, c3 at
  // row g+8.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm + mi * 16 + g + 8 * half;
      if (row >= nr) continue;
      const int pcr = pc_r[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + wn + ni * 8 + 2 * t + e;
          if (col < ns)
            out[(size_t)row * ns + col] = pcr + pc_s[col] - 2 * acc[mi][ni][2 * half + e];
        }
      }
    }
  }
}

}  // namespace bitplane

// out is int32[nr][ns]; pr/ps must be 16-byte aligned with b % 32 == 0.
// Launches on `stream`, allocates nothing and does not synchronise; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bitplane_hamming_launch(const void* pr, const void* ps,
                                       const void* pc_r, const void* pc_s,
                                       int nr, int ns, int b, void* out,
                                       void* stream) {
  using namespace bitplane;
  if (nr <= 0 || ns <= 0) return 0;
  const dim3 grid((ns + kTile - 1) / kTile, (nr + kTile - 1) / kTile);
  bitplane_hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pr), static_cast<const int8_t*>(ps),
      static_cast<const int*>(pc_r), static_cast<const int*>(pc_s), nr, ns, b,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
