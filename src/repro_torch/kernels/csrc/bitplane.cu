// bitplane_hamming: the all-pairs Hamming distance of {0, 1} int8 bit planes
// on the int8 tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/bitplane.py
// bitplane_hamming_pallas (_bitplane_kernel): with planes pr[NR][b],
// ps[NS][b] (one byte per bit) and int32 row popcounts,
//   out[i][j] = pc_r[i] + pc_s[j] - 2 * sum_k pr[i][k] * ps[j][k]
// exactly, as int32.  The TPU kernel exists to put this product on the
// matrix unit; here it goes to Hopper's tensor cores through
// wgmma.mma_async.m64n256k32.s32.s8.s8.
//
// What bounds it on an H100 (published peaks, 700 W): 2*NR*NS*b operations
// at the dense int8 tensor rate of 1,979 T/s against (NR + NS)*b bytes of
// planes read plus 4*NR*NS bytes of int32 output written at 3.35 TB/s.  At
// a 4096 x 4096 block pair and b = 1024 that is 17.4 us of operations and
// 22.5 us of memory, 20.0 us of it the output: the int32 Hamming matrix, not
// the product, bounds it.  So the design first cuts operand re-reads and
// store traffic, and lets the product hide under them.
//
// Design: a persistent grid (one block of 384 threads an SM) walks the
// 128 x 256 output tiles (L2 -> SM traffic of (1/256 + 1/128) * b bytes an
// output element, 12 bytes at b = 1024, against 32 for 64 x 64 tiles).
// Warpgroup 0 is the producer (setmaxnreg down to 40): one thread keeps a
// ring of 4 K-stages of 128 bytes in flight by TMA with 128-byte swizzle,
// 16 KB of pr rows and 32 KB of ps rows a stage, each guarded by full and
// empty mbarriers, and runs on into the next tile while the consumers store
// the last one.  TMA's zero fill covers the ragged NR and NS edges and b
// below a stage's 128 bytes: zero planes add nothing.  Warpgroups 1 and 2
// (setmaxnreg up to 232) each own 64 x 256 of a tile in 128 int32
// accumulators and run 4 k-steps of wgmma m64n256k32 a stage, A (pr) and B
// (ps) both K-major in shared memory, the only layout s8 wgmma takes and the
// one the planes' rows already have; one stage's group stays in flight
// while the next is issued.  Epilogue, per consumer: the tile's popcounts
// into shared memory once, then 8 chunks of 32 columns, each written to a
// 64 x 32 staging tile (rows padded by 8 words: conflict-free), read back
// row-contiguously, pc_r[row] + pc_s[col] - 2 acc, and written with 16-byte
// streaming stores masked at NR and NS (where NS % 4 breaks their alignment,
// 4-byte stores, a warp's 32 on one row's contiguous 128 bytes).
//
// What it leaves on the table: TMA multicast of the shared operand across a
// cluster, the 1-bit and.popc form on packed words (no unpacking), and a
// fused verdict epilogue.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace bitplane {

constexpr int kBM = 128;                 // output rows per tile: two consumers of 64
constexpr int kBN = 256;                 // output columns per tile
constexpr int kBK = 128;                 // plane bytes per stage: the 128-byte swizzle span
constexpr int kStages = 4;
constexpr int kThreads = 384;            // producer warpgroup + two consumer warpgroups
constexpr int kChunk = 32;               // output columns per epilogue chunk
constexpr int kPitch = kChunk + 8;       // int32 per row of a staging tile
constexpr int kABytes = kBM * kBK;       // a stage of pr rows
constexpr int kBBytes = kBN * kBK;       // a stage of ps rows
constexpr int kRing = kStages * (kABytes + kBBytes);
constexpr int kStaging = kRing;          // int32[2][64][kPitch]
constexpr int kPcR = kStaging + 2 * 64 * kPitch * 4;   // int32[2][64]
constexpr int kPcS = kPcR + 2 * 64 * 4;  // int32[2][kBN]
constexpr int kBar = kPcS + 2 * kBN * 4;
constexpr int kSmemBytes = kBar + 2 * kStages * 8 + 1024;   // + alignment slack


__global__ void __launch_bounds__(kThreads, 1)
bitplane_hamming_kernel(const __grid_constant__ CUtensorMap tm_r,
                        const __grid_constant__ CUtensorMap tm_s, const int* __restrict__ pc_r,
                        const int* __restrict__ pc_s, int nr, int ns, int b,
                        int* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring_a = smem;
  uint8_t* ring_b = smem + kStages * kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBar);
  uint64_t* empty = full + kStages;

  const int tiles_n = (ns + kBN - 1) / kBN;
  const int tiles = ((nr + kBM - 1) / kBM) * tiles_n;
  const int nk = (b + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    // Producer: the ring's stage counter runs on across tiles.
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = (tile / tiles_n) * kBM;
        const int col0 = (tile % tiles_n) * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          hopper::mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full + s, kABytes + kBBytes);
          hopper::tma_load_2d(ring_a + s * kABytes, &tm_r, full + s, kt * kBK, row0);
          hopper::tma_load_2d(ring_b + s * kBBytes, &tm_s, full + s, kt * kBK, col0);
        }
      }
    }
  } else {
    // Consumer c owns tile rows 64 c .. 64 c + 63; warp w of it rows
    // 16 w .. 16 w + 15, lane (g, t) the accumulator rows g and g + 8 and
    // columns 2 t, 2 t + 1 of each of the 32 8-column groups.
    hopper::reg_alloc<232>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    int* stage = reinterpret_cast<int*>(smem + kStaging) + c * 64 * kPitch;
    int* pcr_s = reinterpret_cast<int*>(smem + kPcR) + c * 64;
    int* pcs_s = reinterpret_cast<int*>(smem + kPcS) + c * kBN;
    const bool vec = (ns & 3) == 0;

    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / tiles_n) * kBM;
      const int col0 = (tile % tiles_n) * kBN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(full + s, (it / kStages) & 1);
        const uint32_t a_base = hopper::smem_addr(ring_a + s * kABytes) + c * 64 * kBK;
        const uint32_t b_base = hopper::smem_addr(ring_b + s * kBBytes);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          hopper::wgmma_m64n256k32_s8(acc, hopper::sw128_desc(a_base + 32 * kk),
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

      // Epilogue.  The previous tile's reads of the staging tile and the
      // popcounts are done before they are overwritten.
      hopper::named_sync(1 + c, 128);
      pcs_s[tid] = col0 + tid < ns ? pc_s[col0 + tid] : 0;
      pcs_s[tid + 128] = col0 + tid + 128 < ns ? pc_s[col0 + tid + 128] : 0;
      if (tid < 64) pcr_s[tid] = row0 + 64 * c + tid < nr ? pc_r[row0 + 64 * c + tid] : 0;
#pragma unroll
      for (int q = 0; q < kBN / kChunk; ++q) {
        if (q > 0) hopper::named_sync(1 + c, 128);
#pragma unroll
        for (int jj = 0; jj < kChunk / 8; ++jj)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int j = q * (kChunk / 8) + jj;
            const int r = 16 * warp + g + 8 * hr;
            *reinterpret_cast<int2*>(stage + r * kPitch + 8 * jj + 2 * t) =
                make_int2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
          }
        hopper::named_sync(1 + c, 128);
        if (vec) {
          // 16-byte stores: 8 threads a row's 128 bytes.
#pragma unroll
          for (int idx = tid; idx < 64 * (kChunk / 4); idx += 128) {
            const int r = idx / (kChunk / 4);
            const int v4 = idx - r * (kChunk / 4);   // 4-column group of the chunk
            const int row = row0 + 64 * c + r;
            const int cc = q * kChunk + 4 * v4;      // tile column
            if (row >= nr || col0 + cc >= ns) continue;
            const int4 dot = *reinterpret_cast<const int4*>(stage + r * kPitch + 4 * v4);
            const int4 pcs = *reinterpret_cast<const int4*>(pcs_s + cc);
            const int pcr = pcr_s[r];
            __stcs(reinterpret_cast<int4*>(out + (size_t)row * ns + col0 + cc),
                   make_int4(pcr + pcs.x - 2 * dot.x, pcr + pcs.y - 2 * dot.y,
                             pcr + pcs.z - 2 * dot.z, pcr + pcs.w - 2 * dot.w));
          }
        } else {
          // NS % 4 breaks 16-byte alignment: a warp writes a row's 32
          // columns as one contiguous run of 4-byte stores.
#pragma unroll 4
          for (int idx = tid; idx < 64 * kChunk; idx += 128) {
            const int r = idx / kChunk;
            const int cc = q * kChunk + (idx - r * kChunk);
            const int row = row0 + 64 * c + r;
            if (row >= nr || col0 + cc >= ns) continue;
            __stcs(out + (size_t)row * ns + col0 + cc,
                   pcr_s[r] + pcs_s[cc] - 2 * stage[r * kPitch + cc - q * kChunk]);
          }
        }
      }
    }
  }
}

}  // namespace bitplane

// out is int32[nr][ns]; pr/ps must be 16-byte aligned with b % 32 == 0.
// Launches on `stream`, allocates nothing and does not synchronise; returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a tensor map the driver refuses.
extern "C" int bitplane_hamming_launch(const void* pr, const void* ps,
                                       const void* pc_r, const void* pc_s,
                                       int nr, int ns, int b, void* out,
                                       void* stream) {
  using namespace bitplane;
  if (nr <= 0 || ns <= 0) return 0;
  // The planes as 2-D byte tensors (b, N): boxes of 128 bytes x 128 pr rows
  // or 256 ps rows.
  CUtensorMap tm_r, tm_s;
  const cuuint64_t stride[1] = {(cuuint64_t)b};
  const cuuint64_t dims_r[2] = {(cuuint64_t)b, (cuuint64_t)nr};
  const cuuint64_t dims_s[2] = {(cuuint64_t)b, (cuuint64_t)ns};
  const cuuint32_t box_r[2] = {kBK, kBM};
  const cuuint32_t box_s[2] = {kBK, kBN};
  int rc = hopper::encode_sw128(&tm_r, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, pr, dims_r, stride,
                                box_r);
  if (rc == 0)
    rc = hopper::encode_sw128(&tm_s, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ps, dims_s, stride,
                              box_s);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      bitplane_hamming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long tiles = (long long)((nr + kBM - 1) / kBM) * ((ns + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  bitplane_hamming_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_r, tm_s, static_cast<const int*>(pc_r), static_cast<const int*>(pc_s), nr, ns, b,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
