// flash_attention_bwd: the GQA attention backward, for the LM scaffold's
// training path.
//
// Replaces no TPU kernel.  The reference's backward is jnp
// (src/repro/models/layers.py:137 _flash_bwd_impl, under the custom VJP of
// _flash), which XLA compiles and fuses on a TPU; the port's plain version
// (kernels/ref.py flash_attention_bwd_ref) repeats it as about 25 PyTorch ops
// a block, a chain of small launches that the host paces.  This kernel
// computes _flash_bwd_impl's function.  With q, out, do[B][Sq][H][D],
// k, v[B][Sk][KV][D], lse[B][H][Sq] from the forward kernel (natural log),
// query head h reading KV head h / G (G = H / KV) and scale = D^-0.5:
//   p_ij  = exp(s_ij - lse_i),  s_ij = (q_i . k_j) scale, and p_ij = 0 for
//           j > q_off + i when causal (query row i at position q_off + i,
//           key j at j; a non-causal call ignores q_off);
//   D_i   = sum_d do_id out_id in float32;
//   ds_ij = p_ij (dp_ij - D_i),  dp_ij = do_i . v_j;
//   dq_i  = scale sum_j ds_ij k_j,  dk_j = scale sum_(i, g) ds_ij q_i,
//   dv_j  = sum_(i, g) p_ij do_i,
// each KV head's dk and dv summing its G query heads.  Every sum is float32;
// p and ds round to the operands' type before the products they feed (the
// reference's .astype calls); the outputs take q's, k's and v's type.  The
// scores stay unrounded float32, as in the forward kernel that wrote lse (the
// plain version rounds them to bf16, as its einsum does); D_i takes the
// float32 products of do and out (the plain version rounds each product to
// do's type before its float32 sum).
//
// What bounds it on an H100 (published peaks, 700 W), at a smollm-135m layer
// (B 8, S 2,048, H 9 / KV 3, D 64, causal): the five products S, dP, dV, dQ
// and dK do 2 D flops each for every (q, k) pair the mask leaves, 96.6 GFLOP
// at 989 TFLOP/s = 0.098 ms; the exps (one a pair) take 0.036 ms at 16 ex2 a
// clock an SM, the bytes (q, k, v, out, do, lse read once, dq, dk, dv written
// once; 101 MB) 0.030 ms.
//
// Two instances, chosen statically by dtype (never as a fallback):
//
// * bf16, every head dim (16, 32, 64, 112, 128): wgmma in two launches on one
//   stream, deterministic and free of atomics (two calls give bit-identical
//   gradients).  Both follow the forward's block (wg:: in
//   flash_attention.cu): 384 threads, warpgroup 0 the producer (setmaxnreg
//   down to 40; one thread issues every TMA load into a ring of stages with
//   full and empty mbarriers), warpgroups 1 and 2 consumers of 64 rows each
//   (setmaxnreg up to 232).  Tiles are swizzled over min(2 D, 128) bytes as
//   the forward's are, and D = 112 runs on D = 128's tiles as there (Swz).
//     1. dq_kernel, query-major: a block takes 128 q rows of one (batch,
//        head); q and do are loaded once, K and V stream in 64-key tiles.
//        Each consumer first takes D_i of its rows from do and out (read
//        from global memory; written to a float32 [B][H][Sq] buffer for the
//        second launch), then per tile
//          S = Q K^T and dP = dO V^T   wgmma.m64n64k16, both operands K-major
//                                      in shared memory, issued together;
//          P, dS                       in the accumulators: ex2 of s scaled
//                                      less lse, both in log2 units;
//          dQ += dS K                  wgmma.m64n{D}k16, dS as bf16 A
//                                      fragments from registers, K MN-major
//                                      through the transpose-B bit;
//        tile n's P and dS run while tile n - 1's dQ product is in flight.
//     2. dkdv_kernel, key-major: a block takes 128 keys of one (batch, KV
//        head), loaded once and kept; q and do tiles (64 rows; 32 at D = 128,
//        where dK and dV hold two 64 x 128 float32 accumulators a consumer)
//        stream over the group's G heads and, when causal, the q tiles from
//        the diagonal on.  Warp 1 of the producer puts each tile's lse and
//        D_i (in log2 units; -inf and 0 past Sq) into the stage beside it.
//        Per tile, transposed so that P^T and dS^T are already A fragments:
//          S^T = K Q^T and dP^T = V dO^T   wgmma.m64n{64,32}k16, K-major;
//          P^T, dS^T                       in the accumulators;
//          dV += P^T dO, dK += dS^T Q      wgmma.m64n{D}k16, A from
//                                          registers, B MN-major;
//        dK and dV are summed over the group in registers and stored once.
//   This takes 7 products where one fused launch with float32 atomics on dq
//   takes 5: S and dP are computed in both launches.
// * float32, every head dim: the same two launches on the CUDA cores
//   (flash_fwd_f32_kernel's pattern: 128 threads, 64-row and 64-key tiles
//   staged in shared memory, 4 rows x 8 columns of each score tile a
//   thread), correct and not fast.
//
// Masking is explicit: keys >= Sk and (when causal) keys above a row's
// diagonal take p = 0 by compare on the tiles that hold them, rows >= Sq take
// p = 0 through an lse of +inf and D_i = 0, so nothing rests on TMA's zero
// fill (a padded row whose lse read 0 would give p = 1).  No length has to
// divide anything.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace flash_bwd {

constexpr float kLog2e = 1.4426950408889634f;

// Keys a q tile of `rows` rows from q0 needs: up to its last row's position
// (q_off on) when causal.
__device__ __forceinline__ int kv_end(int q0, int rows, int sq, int sk, int causal, int q_off) {
  return causal ? min(sk, min(q0 + rows, sq) + q_off) : sk;
}

// The first q row whose position (q_off on) reaches key k0: when causal the
// rows before it see none of the keys from k0 on.
__device__ __forceinline__ int first_row(int k0, int causal, int q_off) {
  return causal ? max(k0 - q_off, 0) : 0;
}

// ---------------------------------------------------------------------------
// bf16, every head dim: wgmma fed by a warp-specialised TMA ring
// ---------------------------------------------------------------------------

namespace wg {

// A D-wide bf16 row is 2 D bytes; TMA and wgmma swizzle it over min(2 D, 128)
// bytes, so D = 128 is two boxes of 64 columns and D <= 64 one box.  D = 112
// runs D = 128's tiles and accumulators (kPad columns) as the forward does:
// the tensor maps keep the true width, so TMA fills columns 112-127 with
// zeros, S, dP, S^T and dP^T take the 7 k-steps below 112, and only 112
// columns of dq, dk and dv are stored.
template <int D>
struct Swz {
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  static constexpr int kPad = D > 64 ? 128 : D;             // columns of tiles and accumulators
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;   // bytes
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kBoxes = kPad / kBoxCols;
  static constexpr int kSteps = kBoxCols / 16;              // k-steps inside one box's rows
};

constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= kThreads * ((65536 / kThreads) & ~7),
              "register split");

// dq_kernel's shared memory, from a 1,024-byte aligned base: the q and do
// tiles of 128 rows (the epilogue stages dq in q's), the K and V rings of
// 64-key tiles, then the mbarriers.
template <int D>
struct DqCfg {
  using S = Swz<D>;
  static constexpr int kBlockM = 128;   // q rows per block
  static constexpr int kBlockN = 64;    // keys per K / V tile
  static constexpr int kStages = 4;
  static constexpr int kQBox = kBlockM * S::kSwizzle;
  static constexpr int kKVBox = kBlockN * S::kSwizzle;
  static constexpr int kQTile = S::kBoxes * kQBox;
  static constexpr int kTile = S::kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQTile;
  static constexpr int kK = kDO + kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;   // + alignment slack
  static_assert(kKVBox % 1024 == 0 && kQBox % 1024 == 0, "tiles keep 1,024-byte alignment");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// dkdv_kernel's shared memory: the block's K and V tiles of 128 keys (the
// epilogue stages dk and dv in them), the q and do rings, each stage's lse
// and D_i (kBlockM floats each), then the mbarriers.
template <int D>
struct DkvCfg {
  using S = Swz<D>;
  static constexpr int kBlockN = 128;                  // keys per block
  static constexpr int kBlockM = S::kPad == 128 ? 32 : 64;   // q rows per q / do tile
  static constexpr int kStages = 4;
  static constexpr int kKBox = kBlockN * S::kSwizzle;
  static constexpr int kQBox = kBlockM * S::kSwizzle;
  static constexpr int kKTile = S::kBoxes * kKBox;
  static constexpr int kQTile = S::kBoxes * kQBox;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKTile;
  static constexpr int kQ = kV + kKTile;
  static constexpr int kDO = kQ + kStages * kQTile;
  static constexpr int kLse = kDO + kStages * kQTile;
  static constexpr int kDi = kLse + kStages * kBlockM * 4;
  static constexpr int kBar = kDi + kStages * kBlockM * 4;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kKBox % 1024 == 0 && kQBox % 1024 == 0, "tiles keep 1,024-byte alignment");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// acc (64 x N, f32) = A (64 rows x D) B^T (N rows x D), A and B K-major in
// shared memory as boxes of kBoxCols columns, a_box and b_box bytes apart:
// k-step kk reads bytes 32 kk of each swizzled row, in box kk / kSteps.
template <int D, int N>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint32_t a, int a_box, uint32_t b,
                                       int b_box) {
  using S = Swz<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % S::kSteps) * 32;
    const uint64_t da = hopper::swizzled_desc<S::kSwizzle>(a + (kk / S::kSteps) * a_box + off);
    const uint64_t db = hopper::swizzled_desc<S::kSwizzle>(b + (kk / S::kSteps) * b_box + off);
    if constexpr (N == 64)
      hopper::wgmma_m64n64k16_ss(acc, da, db, kk > 0);
    else
      hopper::wgmma_m64n32k16_ss(acc, da, db, kk > 0);
  }
}

// acc (64 x kPad, f32) += A (64 x K, bf16 fragments in registers) B (K rows
// x kPad, MN-major in shared memory): k-step kk reads rows 16 kk .. 16 kk +
// 15; the kPad / 64 column blocks at D = 112 and 128 lie b_box bytes apart
// (LBO).
template <int D, int K>
__device__ __forceinline__ void mma_rs(float (&acc)[Swz<D>::kPad / 2],
                                       const uint32_t (&a)[K / 16][4], uint32_t b, int b_box) {
  using S = Swz<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t desc = hopper::swizzled_desc<S::kSwizzle>(b + kk * 16 * S::kSwizzle, b_box);
    if constexpr (S::kPad == 128)
      hopper::wgmma_m64n128k16_rs_tb(acc, a[kk], desc, 1);
    else if constexpr (D == 64)
      hopper::wgmma_m64n64k16_rs_tb(acc, a[kk], desc, 1);
    else if constexpr (D == 32)
      hopper::wgmma_m64n32k16_rs_tb(acc, a[kk], desc, 1);
    else
      hopper::wgmma_m64n16k16_rs_tb(acc, a[kk], desc, 1);
  }
}

// Query-major P and dS of one 64 x N tile, in place of S: lane (g, t) of
// warp w holds the rows at positions row_lo (halves 0) and row_lo + 8
// (halves 1; q_off included, as the mask compares them), columns
// k0 + 8 j + 2 t + {0, 1}.  neg_lse is -lse log2(e) of each row (-inf past
// Sq), so p = 2^(s scale log2(e) - lse log2(e)); `mask` (the tiles holding
// Sk's edge or the diagonal) zeroes keys >= Sk and above the diagonal.
template <int N>
__device__ __forceinline__ void ds_rows(float (&sacc)[N / 2], const float (&dpacc)[N / 2],
                                        bool mask, int k0, int row_lo, int t, int sk, int causal,
                                        float scale_log2, const float (&neg_lse)[2],
                                        const float (&di)[2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const int hr = e >> 1;
      float p = hopper::ex2(fmaf(sacc[i], scale_log2, neg_lse[hr]));
      if (mask) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        if (col >= sk || (causal && col > row_lo + 8 * hr)) p = 0.f;
      }
      sacc[i] = p * (dpacc[i] - di[hr]);
    }
}

// Key-major P^T and dS^T of one 64 x M tile, in place of S^T and dP^T: rows
// are keys (key_lo, key_lo + 8), columns the q rows at positions q0 + 8 j +
// 2 t + {0, 1} (q_off included), whose -lse log2(e) and D_i are read from
// the stage (nl, di).
template <int M>
__device__ __forceinline__ void ds_cols(float (&sacc)[M / 2], float (&dpacc)[M / 2], bool mask,
                                        int q0, int key_lo, int t, int sk, int causal,
                                        float scale_log2, const float* nl, const float* di) {
#pragma unroll
  for (int j = 0; j < M / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(nl + 8 * j + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = hopper::ex2(fmaf(sacc[i], scale_log2, (e & 1) ? l.y : l.x));
      if (mask) {
        const int col = q0 + 8 * j + 2 * t + (e & 1);
        const int key = key_lo + 8 * (e >> 1);
        if (key >= sk || (causal && col < key)) p = 0.f;
      }
      sacc[i] = p;
      dpacc[i] = p * (dpacc[i] - ((e & 1) ? d.y : d.x));
    }
  }
}

// A consumer's 64 rows of a float32 accumulator, its first D columns times
// `mul`, as bf16: staged in `stage` (its own rows of a tile in shared
// memory, boxes `box` bytes apart, in the tile's swizzled layout), then
// stored as 16-byte row-contiguous chunks to out + row * row_stride for rows
// row0 + r < rows.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[Swz<D>::kPad / 2], float mul,
                                           uint8_t* stage,
                                           int box, int c, int warp, int g, int t, int tid,
                                           __nv_bfloat16* out, size_t row_stride, int row0,
                                           int rows) {
  using S = Swz<D>;
  constexpr int kBoxChunks = S::kBoxCols / 8;   // 16-byte chunks of a box row
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * warp + g + 8 * hr;
      *reinterpret_cast<uint32_t*>(stage + (j / kBoxChunks) * box +
                                   hopper::swizzled_chunk<S::kSwizzle>(r, j % kBoxChunks) +
                                   4 * t) =
          hopper::pack_bf16(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
    }
  hopper::named_sync(1 + c, 128);
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int idx = tid; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks;
    const int ch = idx - r * kChunks;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * row_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + (ch / kBoxChunks) * box +
                                          hopper::swizzled_chunk<S::kSwizzle>(r, ch % kBoxChunks));
  }
}

// kOff: read q_offset; the instance without it compiles offset 0 in, so its
// code is the kernel's from before the offset (a runtime offset cost 2% at
// qwen3-8b's layer, PERF.md).  dkdv_kernel likewise.
template <int D, bool kOff>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
          const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
          float* __restrict__ dsum, int sq, int sk, int heads, int kv_heads, float scale,
          float scale_log2, int causal, int q_offset) {
  using C = DqCfg<D>;
  const int q_off = kOff ? q_offset : 0;
  using S = Swz<D>;
  constexpr int kSt = C::kStages;
  constexpr int kN = C::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSt;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBlockM;   // long causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int n_tiles = (kv_end(q0, C::kBlockM, sq, sk, causal, q_off) + kN - 1) / kN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, 2 * C::kQTile);
#pragma unroll
      for (int box = 0; box < S::kBoxes; ++box) {
        hopper::tma_load_4d(smem + C::kQ + box * C::kQBox, &tm_q, q_full, S::kBoxCols * box, h,
                            q0, b);
        hopper::tma_load_4d(smem + C::kDO + box * C::kQBox, &tm_do, q_full, S::kBoxCols * box,
                            h, q0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kSt;
        hopper::mbar_wait(empty + s, ((n / kSt) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full + s, 2 * C::kTile);
#pragma unroll
        for (int box = 0; box < S::kBoxes; ++box) {
          hopper::tma_load_4d(smem + C::kK + s * C::kTile + box * C::kKVBox, &tm_k, full + s,
                              S::kBoxCols * box, kvh, n * kN, b);
          hopper::tma_load_4d(smem + C::kV + s * C::kTile + box * C::kKVBox, &tm_v, full + s,
                              S::kBoxCols * box, kvh, n * kN, b);
        }
      }
    }
    return;
  }

  // Consumer c owns block rows 64 c .. 64 c + 63.
  hopper::reg_alloc<kConsumerRegs>();
  const int c = warpgroup - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + 64 * c + 16 * warp + g;   // accumulator halves 0; + 8 halves 1

  // D_i of the thread's two rows: the 4 lanes of a quad take D / 4 columns
  // each; lane t = 0 writes it for the second launch.  lse in log2 units.
  float di[2], neg_lse[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_lo + 8 * hr;
    float acc = 0.f;
    if (row < sq) {
      const size_t at = (((size_t)b * sq + row) * heads + h) * D + t * (D / 4);
#pragma unroll
      for (int i = 0; i < D / 4; i += 2) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + i));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + at + i));
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[hr] = acc;
    const size_t at = ((size_t)b * heads + h) * sq + row;
    neg_lse[hr] = row < sq ? -lse[at] * kLog2e : -INFINITY;
    if (t == 0 && row < sq) dsum[at] = acc;
  }

  const uint32_t q_base = hopper::smem_addr(smem + C::kQ) + c * 64 * S::kSwizzle;
  const uint32_t do_base = hopper::smem_addr(smem + C::kDO) + c * 64 * S::kSwizzle;
  const uint32_t k_ring = hopper::smem_addr(smem + C::kK);
  const uint32_t v_ring = hopper::smem_addr(smem + C::kV);
  auto needs_mask = [&](int k0) {
    return k0 + kN > sk || (causal && k0 + kN - 1 > q0 + 64 * c + q_off);
  };
  // A block's last 64-key tile can lie wholly above consumer 0's diagonal:
  // each consumer computes up to its own last tile.
  const int my_tiles = (kv_end(q0 + 64 * c, 64, sq, sk, causal, q_off) + kN - 1) / kN;

  float sacc[kN / 2];
  float dpacc[kN / 2];
  float dqacc[S::kPad / 2];
  uint32_t dsa[kN / 16][4];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < S::kPad / 2; ++i) dqacc[i] = 0.f;
  auto grads = [&](int n) {
    ds_rows<kN>(sacc, dpacc, needs_mask(n * kN), n * kN, row_lo + q_off, t, sk, causal,
                scale_log2, neg_lse, di);
  };

  // Tile 0: S and dP, then dS.
  hopper::mbar_wait(q_full, 0);
  hopper::mbar_wait(full, 0);
  hopper::wgmma_fence();
  mma_ss<D, kN>(sacc, q_base, C::kQBox, k_ring, C::kKVBox);
  mma_ss<D, kN>(dpacc, do_base, C::kQBox, v_ring, C::kKVBox);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sacc);
  hopper::fence_regs(dpacc);
  grads(0);
  hopper::pack_p<kN>(sacc, dsa);

  for (int n = 1; n < my_tiles; ++n) {
    const int s = n % kSt;
    const int sp = (n - 1) % kSt;
    hopper::mbar_wait(full + s, (n / kSt) & 1);
    hopper::wgmma_fence();
    mma_ss<D, kN>(sacc, q_base, C::kQBox, k_ring + s * C::kTile, C::kKVBox);
    mma_ss<D, kN>(dpacc, do_base, C::kQBox, v_ring + s * C::kTile, C::kKVBox);
    hopper::wgmma_commit();
    mma_rs<D, kN>(dqacc, dsa, k_ring + sp * C::kTile, C::kKVBox);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // S and dP of tile n are done; dQ of tile n - 1 runs on
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);
    grads(n);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqacc);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) hopper::fence_regs(dsa[kk]);
    if (lane == 0) hopper::mbar_arrive(empty + sp);
    hopper::pack_p<kN>(sacc, dsa);
  }
  {
    const int sp = (my_tiles - 1) % kSt;
    hopper::wgmma_fence();
    mma_rs<D, kN>(dqacc, dsa, k_ring + sp * C::kTile, C::kKVBox);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqacc);
    if (lane == 0) hopper::mbar_arrive(empty + sp);
  }
  // The block's tiles past this consumer's diagonal: released in order once
  // loaded, so the arrival counts toward that tile's round of the stage.
  for (int n = my_tiles; n < n_tiles; ++n) {
    const int s = n % kSt;
    hopper::mbar_wait(full + s, (n / kSt) & 1);
    if (lane == 0) hopper::mbar_arrive(empty + s);
  }

  // Epilogue: dq = scale * dQ as bf16, staged in this consumer's own rows of
  // the q tile (their last reader was its own S product).
  store_rows<D>(dqacc, scale, smem + C::kQ + c * 64 * S::kSwizzle, C::kQBox, c, warp, g, t, tid,
                dq + ((size_t)b * sq * heads + h) * D, (size_t)heads * D, q0 + 64 * c, sq);
}

template <int D, bool kOff>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq, int sk,
            int heads, int kv_heads, float scale, float scale_log2, int causal, int q_offset) {
  using C = DkvCfg<D>;
  const int q_off = kOff ? q_offset : 0;
  using S = Swz<D>;
  constexpr int kSt = C::kStages;
  constexpr int kM = C::kBlockM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* lse_s = reinterpret_cast<float*>(smem + C::kLse);
  float* di_s = reinterpret_cast<float*>(smem + C::kDi);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kSt;

  const int k0 = blockIdx.x * C::kBlockN;   // the long causal blocks first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int n_qt = (sq + kM - 1) / kM;
  // When causal, the first q tile holding a row at position >= k0; the
  // tiles before it see none of the block's keys.
  const int qt0 = min(first_row(k0, causal, q_off) / kM, n_qt);
  const int per_head = n_qt - qt0;
  const int n_tiles = group * per_head;
  // Tile n: query head kvh G + n / per_head, rows from (qt0 + n % per_head) kM.
  auto tile_head = [&](int n) { return kvh * group + n / per_head; };
  auto tile_q0 = [&](int n) { return (qt0 + n % per_head) * kM; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(full + s, 1 + 32);   // the TMA thread and warp 1's lanes
      hopper::mbar_init(empty + s, 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    hopper::reg_dealloc<kProducerRegs>();
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
      if (n_tiles > 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 2 * C::kKTile);
#pragma unroll
        for (int box = 0; box < S::kBoxes; ++box) {
          hopper::tma_load_4d(smem + C::kK + box * C::kKBox, &tm_k, kv_full, S::kBoxCols * box,
                              kvh, k0, b);
          hopper::tma_load_4d(smem + C::kV + box * C::kKBox, &tm_v, kv_full, S::kBoxCols * box,
                              kvh, k0, b);
        }
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kSt;
        hopper::mbar_wait(empty + s, ((n / kSt) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full + s, 2 * C::kQTile);
#pragma unroll
        for (int box = 0; box < S::kBoxes; ++box) {
          hopper::tma_load_4d(smem + C::kQ + s * C::kQTile + box * C::kQBox, &tm_q, full + s,
                              S::kBoxCols * box, tile_head(n), tile_q0(n), b);
          hopper::tma_load_4d(smem + C::kDO + s * C::kQTile + box * C::kQBox, &tm_do, full + s,
                              S::kBoxCols * box, tile_head(n), tile_q0(n), b);
        }
      }
    } else if (warp == 1) {
      // Each tile's -lse log2(e) and D_i beside it: -inf and 0 past Sq.
      const int lane = threadIdx.x & 31;
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kSt;
        hopper::mbar_wait(empty + s, ((n / kSt) & 1) ^ 1);
        const size_t base = ((size_t)b * heads + tile_head(n)) * sq;
        const int q0 = tile_q0(n);
        for (int i = lane; i < kM; i += 32) {
          const bool in = q0 + i < sq;
          lse_s[s * kM + i] = in ? -lse[base + q0 + i] * kLog2e : -INFINITY;
          di_s[s * kM + i] = in ? dsum[base + q0 + i] : 0.f;
        }
        hopper::mbar_arrive(full + s);
      }
    }
    return;
  }

  // Consumer c owns the block's keys 64 c .. 64 c + 63.
  hopper::reg_alloc<kConsumerRegs>();
  const int c = warpgroup - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_lo = k0 + 64 * c + 16 * warp + g;   // accumulator halves 0; + 8 halves 1
  const int last_key = k0 + 64 * c + 63;
  const uint32_t k_base = hopper::smem_addr(smem + C::kK) + c * 64 * S::kSwizzle;
  const uint32_t v_base = hopper::smem_addr(smem + C::kV) + c * 64 * S::kSwizzle;
  const uint32_t q_ring = hopper::smem_addr(smem + C::kQ);
  const uint32_t do_ring = hopper::smem_addr(smem + C::kDO);
  auto needs_mask = [&](int q0) {
    return last_key >= sk || (causal && q0 + q_off < last_key);
  };

  float sacc[kM / 2];
  float dpacc[kM / 2];
  float dkacc[S::kPad / 2];
  float dvacc[S::kPad / 2];
  uint32_t pa[kM / 16][4];
  uint32_t dsa[kM / 16][4];
#pragma unroll
  for (int i = 0; i < kM / 2; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < S::kPad / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  auto grads = [&](int n) {
    const int s = n % kSt;
    ds_cols<kM>(sacc, dpacc, needs_mask(tile_q0(n)), tile_q0(n) + q_off, key_lo, t, sk,
                causal, scale_log2, lse_s + s * kM, di_s + s * kM);
  };

  const size_t at = ((size_t)b * sk * kv_heads + kvh) * D;
  if (n_tiles == 0) {
    // No q row sees these keys (causal, Sk > Sq + q_off): dk = dv = 0.
    constexpr int kChunks = D / 8;
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int key = k0 + 64 * c + idx / kChunks;
      const size_t off = at + (size_t)key * kv_heads * D + (idx % kChunks) * 8;
      if (key < sk)
        *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<uint4*>(dv + off) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // Tile 0: S^T and dP^T, then P^T and dS^T.
  hopper::mbar_wait(kv_full, 0);
  hopper::mbar_wait(full, 0);
  hopper::wgmma_fence();
  mma_ss<D, kM>(sacc, k_base, C::kKBox, q_ring, C::kQBox);
  mma_ss<D, kM>(dpacc, v_base, C::kKBox, do_ring, C::kQBox);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sacc);
  hopper::fence_regs(dpacc);
  grads(0);
  hopper::pack_p<kM>(sacc, pa);
  hopper::pack_p<kM>(dpacc, dsa);

  for (int n = 1; n < n_tiles; ++n) {
    const int s = n % kSt;
    const int sp = (n - 1) % kSt;
    hopper::mbar_wait(full + s, (n / kSt) & 1);
    hopper::wgmma_fence();
    mma_ss<D, kM>(sacc, k_base, C::kKBox, q_ring + s * C::kQTile, C::kQBox);
    mma_ss<D, kM>(dpacc, v_base, C::kKBox, do_ring + s * C::kQTile, C::kQBox);
    hopper::wgmma_commit();
    mma_rs<D, kM>(dvacc, pa, do_ring + sp * C::kQTile, C::kQBox);
    mma_rs<D, kM>(dkacc, dsa, q_ring + sp * C::kQTile, C::kQBox);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // S^T and dP^T of tile n are done; tile n - 1's run on
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);
    grads(n);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dvacc);
    hopper::fence_regs(dkacc);
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk) {
      hopper::fence_regs(pa[kk]);
      hopper::fence_regs(dsa[kk]);
    }
    if (lane == 0) hopper::mbar_arrive(empty + sp);
    hopper::pack_p<kM>(sacc, pa);
    hopper::pack_p<kM>(dpacc, dsa);
  }
  const int sp = (n_tiles - 1) % kSt;
  hopper::wgmma_fence();
  mma_rs<D, kM>(dvacc, pa, do_ring + sp * C::kQTile, C::kQBox);
  mma_rs<D, kM>(dkacc, dsa, q_ring + sp * C::kQTile, C::kQBox);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dvacc);
  hopper::fence_regs(dkacc);
  if (lane == 0) hopper::mbar_arrive(empty + sp);

  // Epilogue: dk = scale * dK and dv as bf16, staged in this consumer's own
  // rows of the K and V tiles (their last readers were its own S^T and dP^T
  // products).
  store_rows<D>(dkacc, scale, smem + C::kK + c * 64 * S::kSwizzle, C::kKBox, c, warp, g, t, tid,
                dk + at, (size_t)kv_heads * D, k0 + 64 * c, sk);
  store_rows<D>(dvacc, 1.f, smem + C::kV + c * 64 * S::kSwizzle, C::kKBox, c, warp, g, t, tid,
                dv + at, (size_t)kv_heads * D, k0 + 64 * c, sk);
}

// A 4-D tensor map over (D, heads, S, B) in boxes of kBoxCols x 1 x rows x 1.
template <int D>
int encode(CUtensorMap* map, const void* base, int nheads, int len, int batch, int rows) {
  using S = Swz<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)nheads, (cuuint64_t)len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)nheads * D * 2,
                                 (cuuint64_t)len * nheads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)S::kBoxCols, 1, (cuuint32_t)rows, 1};
  return hopper::encode_swizzled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides,
                                 box, S::kSwizzle);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* dsum, int batch, int sq,
           int sk, int heads, int kv_heads, int causal, int q_off, float scale,
           cudaStream_t stream) {
  using Q = DqCfg<D>;
  using K = DkvCfg<D>;
  CUtensorMap m[8];
  int rc = 0;
  if ((rc = encode<D>(&m[0], q, heads, sq, batch, Q::kBlockM)) ||
      (rc = encode<D>(&m[1], k, kv_heads, sk, batch, Q::kBlockN)) ||
      (rc = encode<D>(&m[2], v, kv_heads, sk, batch, Q::kBlockN)) ||
      (rc = encode<D>(&m[3], dout, heads, sq, batch, Q::kBlockM)) ||
      (rc = encode<D>(&m[4], q, heads, sq, batch, K::kBlockM)) ||
      (rc = encode<D>(&m[5], k, kv_heads, sk, batch, K::kBlockN)) ||
      (rc = encode<D>(&m[6], v, kv_heads, sk, batch, K::kBlockN)) ||
      (rc = encode<D>(&m[7], dout, heads, sq, batch, K::kBlockM)))
    return rc;
  const auto dq_k = q_off ? dq_kernel<D, true> : dq_kernel<D, false>;
  const auto dkdv_k = q_off ? dkdv_kernel<D, true> : dkdv_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_k, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  using bf16 = __nv_bfloat16;
  dq_k<<<dim3((sq + Q::kBlockM - 1) / Q::kBlockM, heads, batch), kThreads, Q::kBytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dq), dsum, sq, sk, heads, kv_heads, scale, scale_log2, causal, q_off);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dkdv_k<<<dim3((sk + K::kBlockN - 1) / K::kBlockN, kv_heads, batch), kThreads, K::kBytes,
           stream>>>(m[4], m[5], m[6], m[7], lse, dsum, static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), sq, sk, heads, kv_heads, scale, scale_log2, causal,
                     q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kTile = 64;        // rows of every staged tile
constexpr int kThreads = 128;    // thread (ty, tx) owns rows 4 ty .. 4 ty + 3, columns tx + 8 j

template <int D>
struct Smem {
  static constexpr int kPitch = D + 4;         // floats per staged row
  static constexpr int kPPitch = kTile + 4;    // floats per row of a transposed score tile
  // Four row tiles and two score tiles; dq_kernel uses one score tile.
  static constexpr int kBytes = (4 * kTile * kPitch + 2 * kTile * kPPitch + 2 * kTile) * 4;
};

// Stage 64 float rows from row0 (row r at src + r * stride), pitch D + 4;
// rows past `valid` are 0.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, size_t stride, int row0,
                                      int valid) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx - r * kVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * stride + c));
    *reinterpret_cast<float4*>(dst + r * Smem<D>::kPitch + c) = val;
  }
}

// acc[i][j] = a row 4 ty + i . b row tx + 8 j over D, both staged.
template <int D>
__device__ __forceinline__ void dots(float (&acc)[4][8], const float* a, const float* bt, int ty,
                                     int tx) {
  constexpr int P = Smem<D>::kPitch;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * P + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(bt + (tx + 8 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// Output columns: thread tx holds tx VW + 8 VW jj + e of each of its rows.
template <int D>
struct Cols {
  static constexpr int VW = D % 32 == 0 ? 4 : 2;   // contiguous columns per group
  static constexpr int NJ = D / (8 * VW);      // column groups per thread
};

// acc[i] (row 4 ty + i, the thread's columns) += sum_c w[c][4 ty + i] x[c][cols]
// over the 64 staged rows c of x, w transposed ([c][row], pitch kPPitch).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][Cols<D>::NJ][Cols<D>::VW],
                                           const float* w, const float* x, int ty, int tx) {
  constexpr int P = Smem<D>::kPitch;
  constexpr int PP = Smem<D>::kPPitch;
  constexpr int VW = Cols<D>::VW;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    const float4 wv = *reinterpret_cast<const float4*>(w + c * PP + 4 * ty);
    const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int jj = 0; jj < Cols<D>::NJ; ++jj) {
      const float* xrow = x + c * P + tx * VW + 8 * VW * jj;
      float xv[VW];
      if constexpr (VW == 4) {
        const float4 u = *reinterpret_cast<const float4*>(xrow);
        xv[0] = u.x; xv[1] = u.y; xv[2] = u.z; xv[3] = u.w;
      } else {
        const float2 u = *reinterpret_cast<const float2*>(xrow);
        xv[0] = u.x; xv[1] = u.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[i][jj][e] = fmaf(wr[i], xv[e], acc[i][jj][e]);
    }
  }
}

// Rows 4 ty + i of acc times `mul` to out + row * stride, rows row0 + r < rows.
template <int D>
__device__ __forceinline__ void store(const float (&acc)[4][Cols<D>::NJ][Cols<D>::VW], float mul,
                                      float* out, size_t stride, int row0, int rows, int ty,
                                      int tx) {
  constexpr int VW = Cols<D>::VW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < Cols<D>::NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VW; ++e) out[(size_t)row * stride + tx * VW + 8 * VW * jj + e] = acc[i][jj][e] * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ o, const float* __restrict__ lse,
          const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dsum,
          int sq, int sk, int heads, int kv_heads, float scale, int causal, int q_off) {
  using C = Cols<D>;
  constexpr int P = Smem<D>::kPitch;
  constexpr int PP = Smem<D>::kPPitch;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;             // [64][P] the q tile
  float* dos = qs + kTile * P;      // [64][P] the do tile
  float* ks = dos + kTile * P;      // [64][P] K of one tile
  float* vs = ks + kTile * P;       // [64][P] V of one tile
  float* dss = vs + kTile * P;      // [64][PP] dS^T: dss[key][row]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const size_t q_stride = (size_t)heads * D;
  const size_t kv_stride = (size_t)kv_heads * D;
  const size_t q_at = ((size_t)b * sq * heads + h) * D;
  const size_t kv_at = ((size_t)b * sk * kv_heads + kvh) * D;
  const int valid_q = min(kTile, sq - q0);
  stage<D>(qs, q + q_at, q_stride, q0, valid_q);
  stage<D>(dos, dout + q_at, q_stride, q0, valid_q);
  __syncthreads();

  // D_i and lse of the thread's rows (its 8 lanes split the columns); rows
  // past Sq take lse = +inf, so p = 0.
  float di[4], lse_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    float acc = 0.f;
    if (row < sq)
      for (int d = tx; d < D; d += 8)
        acc = fmaf(dos[(4 * ty + i) * P + d], o[q_at + (size_t)row * q_stride + d], acc);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    di[i] = acc;
    const size_t at = ((size_t)b * heads + h) * sq + row;
    lse_r[i] = row < sq ? lse[at] : INFINITY;
    if (tx == 0 && row < sq) dsum[at] = acc;
  }

  float acc[4][C::NJ][C::VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < C::NJ; ++jj)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) acc[i][jj][e] = 0.f;

  const int end = kv_end(q0, kTile, sq, sk, causal, q_off);
  for (int k0 = 0; k0 < end; k0 += kTile) {
    const int valid = min(kTile, sk - k0);
    __syncthreads();                 // the last tile's K and dS^T are consumed
    stage<D>(ks, k + kv_at, kv_stride, k0, valid);
    stage<D>(vs, v + kv_at, kv_stride, k0, valid);
    __syncthreads();
    float s[4][8], dp[4][8];
    dots<D>(s, qs, ks, ty, tx);
    dots<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + tx + 8 * j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        const bool keep = col < sk && (!causal || row + q_off >= col);
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds[i] = p * (dp[i][j] - di[i]);
      }
      *reinterpret_cast<float4*>(dss + (tx + 8 * j) * PP + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    accumulate<D>(acc, dss, ks, ty, tx);
  }
  store<D>(acc, scale, dq + q_at, q_stride, q0, sq, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lse,
            const float* __restrict__ dout, const float* __restrict__ dsum,
            float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int heads,
            int kv_heads, float scale, int causal, int q_off) {
  using C = Cols<D>;
  constexpr int P = Smem<D>::kPitch;
  constexpr int PP = Smem<D>::kPPitch;
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;             // [64][P] the block's keys, kept
  float* vs = ks + kTile * P;       // [64][P] their values
  float* qs = vs + kTile * P;       // [64][P] q of one tile
  float* dos = qs + kTile * P;      // [64][P] do of one tile
  float* pts = dos + kTile * P;     // [64][PP] P^T transposed back: pts[q row][key]
  float* dst = pts + kTile * PP;    // [64][PP] dS likewise
  float* lse_s = dst + kTile * PP;  // [64] the tile's lse (+inf past Sq)
  float* di_s = lse_s + kTile;      // [64] its D_i (0 past Sq)

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int tx = threadIdx.x & 7;   // q rows tx + 8 j of a tile
  const int ty = threadIdx.x >> 3;  // keys k0 + 4 ty .. + 3
  const size_t q_stride = (size_t)heads * D;
  const size_t kv_stride = (size_t)kv_heads * D;
  const size_t kv_at = ((size_t)b * sk * kv_heads + kvh) * D;
  stage<D>(ks, k + kv_at, kv_stride, k0, min(kTile, sk - k0));
  stage<D>(vs, v + kv_at, kv_stride, k0, min(kTile, sk - k0));

  float dka[4][C::NJ][C::VW], dva[4][C::NJ][C::VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < C::NJ; ++jj)
#pragma unroll
      for (int e = 0; e < C::VW; ++e) dka[i][jj][e] = dva[i][jj][e] = 0.f;

  // When causal, the q tiles from the one holding the row at position k0 on.
  const int first = first_row(k0, causal, q_off) / kTile * kTile;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t q_at = ((size_t)b * sq * heads + h) * D;
    const size_t r_at = ((size_t)b * heads + h) * sq;
    for (int q0 = first; q0 < sq; q0 += kTile) {
      __syncthreads();               // the last tile's q, do, P^T and dS^T are consumed
      stage<D>(qs, q + q_at, q_stride, q0, min(kTile, sq - q0));
      stage<D>(dos, dout + q_at, q_stride, q0, min(kTile, sq - q0));
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < sq ? lse[r_at + row] : INFINITY;
        di_s[threadIdx.x] = row < sq ? dsum[r_at + row] : 0.f;
      }
      __syncthreads();
      float s[4][8], dp[4][8];
      dots<D>(s, ks, qs, ty, tx);    // s[i][j]: key 4 ty + i, q row tx + 8 j
      dots<D>(dp, vs, dos, ty, tx);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tx + 8 * j;
        const float l = lse_s[r];
        const float dd = di_s[r];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 4 * ty + i;
          const bool keep = key < sk && (!causal || q0 + r + q_off >= key);
          p[i] = keep ? expf(s[i][j] * scale - l) : 0.f;
          ds[i] = p[i] * (dp[i][j] - dd);
        }
        *reinterpret_cast<float4*>(pts + r * PP + 4 * ty) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(dst + r * PP + 4 * ty) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      accumulate<D>(dva, pts, dos, ty, tx);
      accumulate<D>(dka, dst, qs, ty, tx);
    }
  }
  store<D>(dka, scale, dk + kv_at, kv_stride, k0, sk, ty, tx);
  store<D>(dva, 1.f, dv + kv_at, kv_stride, k0, sk, ty, tx);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* dsum, int batch, int sq,
           int sk, int heads, int kv_heads, int causal, int q_off, float scale,
           cudaStream_t stream) {
  const auto dq_k = dq_kernel<D>;
  const auto dkdv_k = dkdv_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  dq_k<<<dim3((sq + kTile - 1) / kTile, heads, batch), kThreads, Smem<D>::kBytes, stream>>>(
      f(q), f(k), f(v), f(o), lse, f(dout), static_cast<float*>(dq), dsum, sq, sk, heads,
      kv_heads, scale, causal, q_off);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dkdv_k<<<dim3((sk + kTile - 1) / kTile, kv_heads, batch), kThreads, Smem<D>::kBytes, stream>>>(
      f(q), f(k), f(v), lse, f(dout), dsum, static_cast<float*>(dk), static_cast<float*>(dv), sq,
      sk, heads, kv_heads, scale, causal, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

}  // namespace flash_bwd

// q, o, dout, dq: [batch][sq][heads][head_dim]; k, v, dk, dv:
// [batch][sk][kv_heads][head_dim], contiguous and 16-byte aligned, heads %
// kv_heads == 0, sk >= 1; lse: float32 [batch][heads][sq] as the forward
// kernel writes it (natural log).  dtype 0 is float32 (the CUDA-core
// instance), 1 bfloat16 (wgmma); head_dim is 16, 32, 64, 112 or 128.  `dsum`
// is float32 scratch of batch * heads * sq, written by the first launch
// (D_i) and read by the second.  Launches both kernels on `stream`,
// allocates nothing and does not synchronise; returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for a dtype or
// head_dim it has no kernel for, a negative q_offset, or a tensor map
// cuTensorMapEncodeTiled refuses.  q_offset is the position of q's first row
// (keys start at 0), as the forward takes it; a non-causal call ignores it.
// Writes every element of dq (rows < sq), dk and dv: keys that no row sees
// get zeros.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const float* lse, const void* dout,
                                          void* dq, void* dk, void* dv, float* dsum, int batch,
                                          int sq, int sk, int heads, int kv_heads, int head_dim,
                                          int dtype, int causal, int q_offset, float scale,
                                          void* stream) {
  using namespace flash_bwd;
  if (batch <= 0 || sq <= 0) return 0;
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int q_off = causal ? q_offset : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_INSTANCES(DIM)                                                           \
  if (head_dim == DIM) {                                                                   \
    if (dtype == 1)                                                                        \
      return wg::launch<DIM>(q, k, v, o, lse, dout, dq, dk, dv, dsum, batch, sq, sk, heads, \
                             kv_heads, causal, q_off, scale, s);                           \
    if (dtype == 0)                                                                        \
      return simt::launch<DIM>(q, k, v, o, lse, dout, dq, dk, dv, dsum, batch, sq, sk,     \
                               heads, kv_heads, causal, q_off, scale, s);                  \
  }
  FLASH_BWD_INSTANCES(16)
  FLASH_BWD_INSTANCES(32)
  FLASH_BWD_INSTANCES(64)
  FLASH_BWD_INSTANCES(112)
  FLASH_BWD_INSTANCES(128)
#undef FLASH_BWD_INSTANCES
  return static_cast<int>(cudaErrorInvalidValue);
}
