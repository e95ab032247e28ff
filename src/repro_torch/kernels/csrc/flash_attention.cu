// flash_attention: the GQA attention forward with an online softmax, for the
// LM scaffold's prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention_fwd_pallas (_make_kernel).  With q[B][Sq][H][D] and
// k, v[B][Sk][KV][D], query head h reads KV head h / (H / KV) and
//   o[b][i][h] = sum_j p_ij v[b][j][h / (H / KV)] / max(sum_j p_ij, 1e-30),
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = (q_i . k_j) * D^-0.5,
// with s_ij = -1e30 for j > q_off + i when causal: query row i sits at
// position q_off + i and key j at position j (q_off = 0 when q and k start
// together; a slice of the q sequence passes its first row's position).
// The cast points are the TPU kernel's: the q . k products are exact in
// float32, p is rounded to v's type before PV, every sum is float32 and the
// output is rounded to q's type.  On request every instance also writes each
// query row's log-sum-exp, lse_i = log sum_j exp(s_ij), in float32 (the
// reference's _flash_fwd returns it for the training path's backward).
//
// What bounds it on an H100 (published peaks, 700 W), at the serving phase's
// shape B = 4, Sq = Sk = 4,096, H = 32, KV = 8, causal: the two products do
// 4 D flops for each of the 1.074e9 (q, k) pairs the mask leaves, and each
// pair takes one exponential.  At D = 128 (bf16) the products bound it,
// 549.8 GFLOP at 989 TFLOP/s = 0.556 ms; at D = 32 the exponentials, 1.074e9
// ex2 at 16 a clock on each of 132 SMs at 1.98 GHz = 0.257 ms (the products
// 0.139 ms, the bytes 0.025 ms).  In float32 at D = 128 the products bound
// it as three TF32 products each (below): 3 x 549.8 GFLOP at 495 TFLOP/s =
// 3.33 ms (the bytes 0.20 ms; on the CUDA cores 8.2 ms at 67 TFLOP/s).
//
// Three instances, chosen statically by dtype in flash_attention_launch
// (never as a fallback after a failed launch); flash_attention_launch_instance
// also takes a named one, for measurement and tests:
//
// * bf16, every head dim (16, 32, 64, 112, 128): wgmma with a TMA-fed,
//   warp-specialised K/V ring, since only wgmma reaches Hopper's tensor
//   rate.  A block of 384 threads takes 128 q rows of one (batch, head); q
//   tiles are issued longest-first (the long causal rows start early).
//   Warpgroup 0 is the producer (setmaxnreg down to 40): one thread loads
//   the q tile once by TMA and streams K and V tiles of the block's KV head
//   (128 keys; 64 at D = 16) into a ring of stages (3 at D = 112 and 128, 4
//   at 64, 6 at 16 and 32),
//   each with full and empty mbarriers; TMA's zero fill past Sq and Sk
//   replaces row masking on the loads.  A D-wide bf16 row is 2 D bytes, and
//   TMA and wgmma swizzle it over min(2 D, 128) bytes (descriptor layout
//   types 1, 2, 3 for 128, 64, 32), so D = 128 is two boxes of 64 columns
//   and D <= 64 one box.  D = 112 (zamba2-7b's shared attention) runs D =
//   128's shared memory and products on tiles padded to 128 columns: its
//   tensor maps keep the true width, so TMA writes zeros into columns
//   112-127, S skips the last k-step and P V's last 16 columns are zero and
//   never stored; at zamba2-7b's shapes that pads P V by 1/7 and leaves S at
//   the true work.  Warpgroups 1 and 2 are consumers (setmaxnreg up to
//   232) of 64 q rows each:
//     S = Q K^T   wgmma.m64n128k16.f32.bf16.bf16, A (q) and B (K) both from
//                 shared memory, K-major; D / 16 k-steps;
//     softmax     in the accumulator registers: D^-0.5 * log2(e) folded
//                 into one FMA before ex2.approx, row max over the 4 lanes
//                 of a quad by two shuffles (row sums stay per thread until
//                 the end); only the diagonal tile and the tile holding Sk's
//                 ragged edge take any compare;
//     O += P V    wgmma.m64n{D}k16 with A = P as bf16 from registers (the S
//                 accumulator layout is the A fragment layout) and B = V
//                 from shared memory, MN-major through the transpose-B bit,
//                 so no transpose pass.
//   Inside a consumer, tile n's softmax runs while tile n - 1's P V is in
//   flight: S of tile n and P V of tile n - 1 are issued together, the
//   consumer waits for S alone, exponentiates, then waits for P V before it
//   rescales O.  The epilogue divides by max(l, 1e-30), rounds to bf16 and
//   stores through the consumer's own rows of the q tile as 16-byte
//   row-contiguous stores masked at Sq.  Tensor maps (4-D over D, heads, S,
//   B) are encoded on the host each call through the runtime's driver entry
//   point.
//   At D = 16 and 32 the exponentials, not the products, set the bound, and
//   the registers and shared memory are nearly free; the shape there (Cfg) is
//   the fastest of those measured in turns by scripts/flash_variants.py.
//   Both head dims take turns issuing the two consumers' products over named
//   barriers (ping-pong, which paid here and not at D = 128) and run each
//   row's maximum as 4 independent chains; D = 32 keeps 128-key tiles and a
//   6-stage ring, D = 16 takes 64-key tiles, a 4-stage ring and two blocks
//   an SM (consumers at 104 registers), so one block's start-up and epilogue
//   run under the other's loop.  Three consumers, turns around the
//   exponentials, other ring depths, and S issued a tile ahead into a second
//   buffer measured no better.  The kernel reaches about half of its exp
//   bound: taking the exponentials out barely moves its time, and taking the
//   whole softmax out leaves three quarters of it, so the per-tile
//   synchronisation and wgmma latency, not the ex2 pipe, set the pace
//   (PERF.md).
// * float32, every head dim (x3::): 3xTF32 on wgmma.  A TF32 operand keeps
//   10 mantissa bits, so each float32 operand x is split into TF32 parts,
//   hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), |x - hi - lo| <= 2^-22 |x|,
//   and each product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi (the
//   small products first) in the tensor cores' float32 sums: float32
//   accuracy (the dropped a_lo b_lo is 2^-22 relative) for three TF32
//   products.  TF32 wgmma reads both shared-memory operands K-major only
//   (the transpose bits are f16 / bf16's), so a prepass (split_kv_kernel)
//   writes K's parts in k's layout and V's transposed, keys contiguous, into
//   scratch the wrapper allocates (0.12 ms of bytes at the layer shape, 4%
//   of the product bound).  q is read once a block, so its consumers split
//   it themselves: q_hi stays in registers as S's A fragments, q_lo goes to
//   shared memory.  The block is wg::'s: 384 threads over 128 q rows, a
//   producer warpgroup streaming K and V^T tiles (hi and lo) by TMA into a
//   ring, two consumer warpgroups of 64 rows with the softmax of wg::;
//     S = q_hi K_lo + q_lo K_hi + q_hi K_hi   wgmma.m64n{N}k8.f32.tf32.tf32;
//     O += P_lo V_hi + P_hi V_lo + P_hi V_hi   P split in registers.
//   In TF32 the S accumulator's layout (keys 2t, 2t + 1 of each 8-key group)
//   is not the A fragment's (slots t, t + 4), so the prepass stores each
//   8-key group of V^T in the order 0, 2, 4, 6, 1, 3, 5, 7 and P enters P V
//   as its accumulators lie.  Shared memory binds at D = 128: a float32 row
//   is 512 bytes (four 128-byte swizzle atoms), q_lo of 128 rows takes 64 KB
//   and a 32-key stage of K and V^T, hi and lo, 64 KB: 32-key tiles in two
//   stages; D <= 64 takes 64-key tiles in 3 (D = 64) or 4 stages.  D = 112
//   runs D = 128's q_lo and K tiles (TMA's zeros in K's columns 112-127, 14
//   k-steps of S) and a 112-row V^T, P V on wgmma.m64n112k8.
// * float32, CUDA cores (instance="simt_f32" only; the rule until the 3xTF32
//   instance measured faster): float32 FMAs, 4 rows x 8 keys of the score
//   tile and 4 rows x D/8 output columns a thread (in groups of 4, or of 2
//   at D = 16 and 112), P through shared memory.
// When causal, every instance stops after the diagonal tile (the TPU
// kernel's lower-triangle schedule, shifted by q_off) and masks the ragged
// Sq / Sk edges itself, so no length or offset has to divide anything.  A
// non-causal call ignores q_off.
//
// What the wgmma instance leaves on the table: a persistent grid (a block's
// start-up and epilogue are not overlapped with another block's loads), and
// the masked half of the diagonal tile's products.  At D = 128 ordering the
// two consumers' product issue by named barriers (ping-pong) measured no
// gain.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace flash {

using hopper::pack_bf16;

constexpr int kRows = 64;        // q rows per block; keys per K/V tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// Keys a q tile of `rows` rows from q0 visits: up to its last row's
// position (q_off on) when causal.
__device__ __forceinline__ int kv_end(int q0, int rows, int sq, int sk, int causal, int q_off) {
  return causal ? min(sk, min(q0 + rows, sq) + q_off) : sk;
}

// ---------------------------------------------------------------------------
// bf16, every head dim: wgmma fed by a warp-specialised TMA ring
// ---------------------------------------------------------------------------

namespace wg {

// The instance for head dim D.  A D-wide bf16 row is 2 D bytes; TMA and
// wgmma swizzle it over min(2 D, 128) bytes, so D = 128 is two boxes of 64
// columns and D <= 64 one box.  D = 112 runs D = 128's tiles and products
// (kPad columns): the tensor maps keep the true width, so TMA fills columns
// 112-127 of the second box with zeros, S takes only the 7 k-steps below
// 112, and the epilogue stores 112 columns.  Shared memory, from a 1,024-byte aligned
// base: the q tile (which the epilogue reuses to stage the output), the K
// and V rings (each tile kBlockN rows x D bf16, as kBoxes boxes), then the
// mbarriers.  Two consumer warpgroups of 64 q rows take setmaxnreg 40 / 232,
// or 24 / 104 at two blocks an SM.
//
// D = 64 and 128 are tensor-bound: 128-key tiles, 4 and 3 stages, one block
// an SM.  D = 16 and 32 are bound by the exponentials (one ex2 a score at
// 4 D tensor FLOPs); their shapes are the fastest of those measured in
// turns (PERF.md, scripts/flash_variants.py): the consumers take turns
// issuing their products over named barriers, each row's maximum runs as 4
// independent chains, D = 32 keeps 128-key tiles in 6 stages and D = 16
// takes 64-key tiles in 4 stages with two blocks an SM.
template <int D>
struct Cfg {
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  static constexpr int kPad = D > 64 ? 128 : D;             // columns of tiles and O
  static constexpr bool kSmall = D < 64;
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;   // bytes
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kBoxes = kPad / kBoxCols;
  static constexpr int kConsumers = 2;
  static constexpr int kStages = D == 16 ? 4 : D == 32 ? 6 : D == 64 ? 4 : 3;
  static constexpr bool kTurns = kSmall;                    // ping-pong the product issue
  static constexpr int kBlockN = D == 16 ? 64 : 128;        // keys per K/V tile
  static constexpr int kBlocksPerSM = D == 16 ? 2 : 1;
  static constexpr int kMaxChains = kSmall ? 4 : 1;
  static constexpr int kBlockM = 64 * kConsumers;           // q rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = kBlocksPerSM == 1 ? 40 : 24;
  static constexpr int kConsumerRegs = kBlocksPerSM == 1 ? 232 : 104;
  static constexpr int kQBox = kBlockM * kSwizzle;          // bytes of one q box
  static constexpr int kKVBox = kBlockN * kSwizzle;         // bytes of one K or V box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kTile = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + (1 + 3 * kStages) * 8 + 1024;   // + alignment slack
  // The split must fit the registers the block launched with (setmaxnreg
  // waits forever otherwise): 65,536 a SM over its threads, in steps of 8.
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kThreads * ((65536 / (kThreads * kBlocksPerSM)) & ~7),
                "register split");
  static_assert(kBlocksPerSM * kBytes <= 228 * 1024, "shared memory of the SM's blocks");
  static_assert(kQBox % 1024 == 0 && kKVBox % 1024 == 0, "tiles keep 1,024-byte alignment");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// Named barriers: 1 and 2 each consumer's epilogue, 3 and 4 the turns.
constexpr int kTurnBar = 3;

// The bf16 wgmma products and fragment helpers live in hopper.cuh.
using hopper::ex2;
using hopper::pack_p;
using hopper::swizzled_chunk;
using hopper::wgmma_m64n128k16_rs_tb;
using hopper::wgmma_m64n128k16_ss;
using hopper::wgmma_m64n16k16_rs_tb;
using hopper::wgmma_m64n32k16_rs_tb;
using hopper::wgmma_m64n64k16_rs_tb;
using hopper::wgmma_m64n64k16_ss;

// The consumer's per-thread view of one 64 x 128 S tile and of its rows:
// lane (g, t) of warp w holds rows 16 w + g (halves 0) and 16 w + g + 8
// (halves 1), columns 8 j + 2 t + {0, 1} of each 8-column group j.
struct RowState {
  float m[2];   // running maxima (raw scores)
  float l[2];   // this thread's part of the running sums
};

// lse[b][h][row] = m * D^-0.5 + log(max(l, 1e-30)) in natural-log units (m is
// the raw score maximum, scale_log2 = D^-0.5 log2(e)), from lane t = 0 of the
// row's quad and for rows below Sq only.
__device__ __forceinline__ void store_lse(float* lse, float m, float denom, float scale_log2,
                                          int row, int t, int b, int h, int sq, int heads) {
  if (t == 0 && row < sq)
    lse[((size_t)b * heads + h) * sq + row] =
        m * (scale_log2 * 0.6931471805599453f) + logf(denom);
}

// S = q K^T (64 x kBlockN): k-step kk reads bytes 32 kk of each swizzled
// row, in box kk / (steps a box).
template <int D>
__device__ __forceinline__ void mma_qk(float (&sacc)[Cfg<D>::kBlockN / 2], uint32_t q_base,
                                         uint32_t k_base) {
  using C = Cfg<D>;
  constexpr int kSteps = C::kBoxCols / 16;   // k-steps inside one box's rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % kSteps) * 32;
    const uint64_t desc_q =
        hopper::swizzled_desc<C::kSwizzle>(q_base + (kk / kSteps) * C::kQBox + off);
    const uint64_t desc_k =
        hopper::swizzled_desc<C::kSwizzle>(k_base + (kk / kSteps) * C::kKVBox + off);
    if constexpr (C::kBlockN == 128)
      wgmma_m64n128k16_ss(sacc, desc_q, desc_k, kk > 0);
    else
      wgmma_m64n64k16_ss(sacc, desc_q, desc_k, kk > 0);
  }
}

// O += P V: k-step kk reads keys 16 kk .. 16 kk + 15 (16 swizzled rows); the
// kPad / 64 column blocks of V at D = 112 and 128 lie one box apart (LBO).
template <int D>
__device__ __forceinline__ void mma_pv(float (&oacc)[Cfg<D>::kPad / 2],
                                         const uint32_t (&pa)[Cfg<D>::kBlockN / 16][4],
                                         uint32_t v_base) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::kBlockN / 16; ++kk) {
    const uint64_t desc =
        hopper::swizzled_desc<C::kSwizzle>(v_base + kk * 16 * C::kSwizzle, C::kKVBox);
    if constexpr (C::kPad == 128)
      wgmma_m64n128k16_rs_tb(oacc, pa[kk], desc, 1);
    else if constexpr (D == 64)
      wgmma_m64n64k16_rs_tb(oacc, pa[kk], desc, 1);
    else if constexpr (D == 32)
      wgmma_m64n32k16_rs_tb(oacc, pa[kk], desc, 1);
    else
      wgmma_m64n16k16_rs_tb(oacc, pa[kk], desc, 1);
  }
}

// Masks S (64 x N) when asked (the diagonal tile and the one holding Sk's
// edge; row_lo is the position of the thread's first row, q_off included),
// then the online softmax's row maxima: each row's rescale factor and
// -max * scale_log2 for softmax_exp.
template <int N, int kChains>
__device__ __forceinline__ void softmax_max(float (&sacc)[N / 2], RowState& st,
                                            float (&alpha)[2], float (&neg_ms)[2], bool mask,
                                            int k0, int row_lo, int t, int sk, int causal,
                                            float scale_log2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row_lo + 8 * (e >> 1);
        if (col >= sk || (causal && col > row)) sacc[4 * j + e] = kNegInf;
      }
  }
  // kChains independent chains a row (max is exact: any order gives the
  // same value), so the first exponentials wait for a shorter chain.
  float chain[2][kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) chain[0][i] = chain[1][i] = i == 0 ? st.m[0] : kNegInf;
  chain[1][0] = st.m[1];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      chain[e >> 1][j % kChains] = fmaxf(chain[e >> 1][j % kChains], sacc[4 * j + e]);
  float mx[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = chain[hr][0];
#pragma unroll
    for (int i = 1; i < kChains; ++i) mx[hr] = fmaxf(mx[hr], chain[hr][i]);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    alpha[hr] = ex2((st.m[hr] - mx[hr]) * scale_log2);
    neg_ms[hr] = -mx[hr] * scale_log2;
    st.m[hr] = mx[hr];
  }
}

// The online softmax in the log2 domain: p = 2^(s * scale_log2 - m *
// scale_log2), in place, and the running sums.
template <int N>
__device__ __forceinline__ void softmax_exp(float (&sacc)[N / 2], RowState& st,
                                            const float (&alpha)[2], const float (&neg_ms)[2],
                                            float scale_log2) {
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = sacc[4 * j + e];
      x = ex2(fmaf(x, scale_log2, neg_ms[e >> 1]));
      rs[e >> 1] += x;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) st.l[hr] = st.l[hr] * alpha[hr] + rs[hr];
}

template <int D>
__device__ __forceinline__ void rescale(float (&oacc)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    oacc[4 * j] *= alpha[0];
    oacc[4 * j + 1] *= alpha[0];
    oacc[4 * j + 2] *= alpha[1];
    oacc[4 * j + 3] *= alpha[1];
  }
}

// Consumer c's turn at issuing its products, when Cfg<D>::kTurns: it waits
// for the other consumer's signal, issues, then signals the other one.  Both
// consumers take the same number of turns.
template <int D>
__device__ __forceinline__ void wait_turn(int c) {
  if constexpr (Cfg<D>::kTurns) hopper::named_sync(kTurnBar + c, 256);
}

template <int D>
__device__ __forceinline__ void pass_turn(int c, bool last) {
  // The last consumer's last signal would have no reader.
  if constexpr (Cfg<D>::kTurns) {
    if (!(last && c == 1)) hopper::named_arrive(kTurnBar + (c ^ 1), 256);
  }
}

// kLse: also write lse (a parameter after the others, so they keep their
// offsets; the instance without it is the serving path's kernel).  kOff:
// read q_offset (after lse); the instance without it compiles offset 0 in,
// so its code is the kernel's from before the offset (measured: a runtime
// offset cost 1-2% at qwen3-8b's layer, PERF.md).
template <int D, bool kLse, bool kOff>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kBlocksPerSM)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       int sq, int sk, int heads, int kv_heads, float scale_log2, int causal,
                       float* __restrict__ lse, int q_offset) {
  using C = Cfg<D>;
  const int q_off = kOff ? q_offset : 0;
  constexpr int kSt = C::kStages;
  constexpr int kBlockN = C::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kSt;
  uint64_t* empty = v_full + kSt;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int end = kv_end(q0, C::kBlockM, sq, sk, causal, q_off);
  const int n_tiles = (end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 4 * C::kConsumers);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    // Producer.
    hopper::reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, C::kQTile);
#pragma unroll
      for (int box = 0; box < C::kBoxes; ++box)
        hopper::tma_load_4d(smem + C::kQ + box * C::kQBox, &tm_q, q_full, C::kBoxCols * box, h,
                            q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kSt;
        hopper::mbar_wait(empty + s, ((n / kSt) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(k_full + s, C::kTile);
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box)
          hopper::tma_load_4d(smem + C::kK + s * C::kTile + box * C::kKVBox, &tm_k, k_full + s,
                              C::kBoxCols * box, kvh, n * kBlockN, b);
        hopper::mbar_arrive_expect_tx(v_full + s, C::kTile);
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box)
          hopper::tma_load_4d(smem + C::kV + s * C::kTile + box * C::kKVBox, &tm_v, v_full + s,
                              C::kBoxCols * box, kvh, n * kBlockN, b);
      }
    }
  } else {
    // Consumer c owns block rows 64 c .. 64 c + 63.  Tile n's softmax runs
    // while tile n - 1's O += P V is in flight.
    hopper::reg_alloc<C::kConsumerRegs>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_lo = q0 + 64 * c + 16 * warp + g;   // accumulator halves 0; + 8 halves 1
    const int pos_lo = row_lo + q_off;                  // its position, the mask's row
    const uint32_t q_base = hopper::smem_addr(smem + C::kQ) + c * 64 * C::kSwizzle;
    const uint32_t k_ring = hopper::smem_addr(smem + C::kK);
    const uint32_t v_ring = hopper::smem_addr(smem + C::kV);
    auto needs_mask = [&](int k0) {
      return k0 + kBlockN > sk || (causal && k0 + kBlockN - 1 > q0 + 64 * c + q_off);
    };
    // With 64-key tiles a block's last tile can lie wholly above consumer
    // 0's diagonal: it computes up to its own last tile.
    int my_tiles = n_tiles;
    if constexpr (kBlockN < 128)
      my_tiles = (kv_end(q0 + 64 * c, 64, sq, sk, causal, q_off) + kBlockN - 1) / kBlockN;

    float sacc[kBlockN / 2];
    float oacc[C::kPad / 2];
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::kPad / 2; ++i) oacc[i] = 0.f;
    RowState st = {{kNegInf, kNegInf}, {0.f, 0.f}};
    float alpha[2];
    float neg_ms[2];
    if constexpr (C::kTurns) {
      if (c == 1) hopper::named_arrive(kTurnBar, 256);   // consumer 0 first
    }
    auto softmax = [&](int n) {
      softmax_max<kBlockN, C::kMaxChains>(sacc, st, alpha, neg_ms, needs_mask(n * kBlockN),
                                          n * kBlockN, pos_lo, t, sk, causal, scale_log2);
      softmax_exp<kBlockN>(sacc, st, alpha, neg_ms, scale_log2);
    };

    // Tile 0: S, softmax, P.
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(k_full, 0);
    wait_turn<D>(c);
    hopper::wgmma_fence();
    mma_qk<D>(sacc, q_base, k_ring);
    hopper::wgmma_commit();
    pass_turn<D>(c, false);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    softmax(0);
    pack_p<kBlockN>(sacc, pa);

    for (int n = 1; n < my_tiles; ++n) {
      const int s = n % kSt;
      const int sp = (n - 1) % kSt;
      hopper::mbar_wait(k_full + s, (n / kSt) & 1);
      wait_turn<D>(c);
      hopper::wgmma_fence();
      mma_qk<D>(sacc, q_base, k_ring + s * C::kTile);
      hopper::wgmma_commit();
      hopper::mbar_wait(v_full + sp, ((n - 1) / kSt) & 1);
      mma_pv<D>(oacc, pa, v_ring + sp * C::kTile);
      hopper::wgmma_commit();
      pass_turn<D>(c, false);
      hopper::wgmma_wait<1>();   // S of tile n is done; P V of tile n - 1 runs on
      hopper::fence_regs(sacc);
      softmax(n);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) hopper::fence_regs(pa[kk]);
      if (lane == 0) hopper::mbar_arrive(empty + sp);
      rescale<C::kPad>(oacc, alpha);
      pack_p<kBlockN>(sacc, pa);
    }
    {
      const int sp = (my_tiles - 1) % kSt;
      hopper::mbar_wait(v_full + sp, ((my_tiles - 1) / kSt) & 1);
      wait_turn<D>(c);
      hopper::wgmma_fence();
      mma_pv<D>(oacc, pa, v_ring + sp * C::kTile);
      hopper::wgmma_commit();
      pass_turn<D>(c, my_tiles == n_tiles);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      if (lane == 0) hopper::mbar_arrive(empty + sp);
    }
    // The block's tiles past this consumer's diagonal: released in order
    // once loaded (so the arrival counts toward that tile's round of the
    // stage), each still taking its turn.
    for (int n = my_tiles; n < n_tiles; ++n) {
      const int s = n % kSt;
      hopper::mbar_wait(k_full + s, (n / kSt) & 1);
      if (lane == 0) hopper::mbar_arrive(empty + s);
      wait_turn<D>(c);
      pass_turn<D>(c, n == n_tiles - 1);
    }

    // Epilogue: O / max(l, 1e-30) as bf16, staged in this consumer's own
    // rows of the q tile (its last reader was the consumer's own S), in the
    // q tile's swizzled layout, conflict-free both ways; then 16-byte
    // row-contiguous stores of the rows below Sq, D columns (O's columns
    // past D, zero at D = 112, stay behind).  lse, when asked, from
    // lane t = 0 of each quad (all four hold the row's m and l).
    float denom[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = st.l[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      denom[hr] = fmaxf(l, 1e-30f);
      if constexpr (kLse)
        store_lse(lse, st.m[hr], denom[hr], scale_log2, row_lo + 8 * hr, t, b, h, sq, heads);
    }
    constexpr int kBoxChunks = C::kBoxCols / 8;   // 16-byte chunks of a box row
    uint8_t* stage = smem + C::kQ + c * 64 * C::kSwizzle;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr;
        *reinterpret_cast<uint32_t*>(
            stage + (j / kBoxChunks) * C::kQBox +
            swizzled_chunk<C::kSwizzle>(r, j % kBoxChunks) + 4 * t) =
            pack_bf16(oacc[4 * j + 2 * hr] / denom[hr], oacc[4 * j + 2 * hr + 1] / denom[hr]);
      }
    hopper::named_sync(1 + c, 128);
    constexpr int kChunks = D / 8;   // 16-byte chunks of a row
#pragma unroll 4
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks;
      const int ch = idx - r * kChunks;
      const int row = q0 + 64 * c + r;
      if (row < sq)
        *reinterpret_cast<uint4*>(o + (((size_t)b * sq + row) * heads + h) * D + ch * 8) =
            *reinterpret_cast<const uint4*>(stage + (ch / kBoxChunks) * C::kQBox +
                                            swizzled_chunk<C::kSwizzle>(r, ch % kBoxChunks));
    }
  }
}

// q, k, v as 4-D tensor maps over (D, heads, S, B), boxes of kBoxCols x 1 x
// rows x 1 (rows: the block's q rows, or a K/V tile's keys).
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int sq,
           int sk, int heads, int kv_heads, int causal, int q_off, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const int lens[3] = {sq, sk, sk};
  const int nheads[3] = {heads, kv_heads, kv_heads};
  const int rows[3] = {C::kBlockM, C::kBlockN, C::kBlockN};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)nheads[i], (cuuint64_t)lens[i],
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)nheads[i] * D * 2,
                                   (cuuint64_t)lens[i] * nheads[i] * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::kBoxCols, 1, (cuuint32_t)rows[i], 1};
    const int rc = hopper::encode_swizzled(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                           bases[i], dims, strides, box, C::kSwizzle);
    if (rc != 0) return rc;
  }
  const auto kernel = lse ? (q_off ? flash_fwd_wgmma_kernel<D, true, true>
                                   : flash_fwd_wgmma_kernel<D, true, false>)
                          : (q_off ? flash_fwd_wgmma_kernel<D, false, true>
                                   : flash_fwd_wgmma_kernel<D, false, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + C::kBlockM - 1) / C::kBlockM, heads, batch);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), sq, sk, heads, kv_heads,
      scale * 1.4426950408889634f, causal, lse, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32, every head dim: 3xTF32 on wgmma, fed by a split prepass
// ---------------------------------------------------------------------------

namespace x3 {

// x rounded to TF32 (cvt.rna: 10 mantissa bits, ties away from zero) as a
// float32 bit pattern whose low 13 bits are cleared.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// x = hi + lo to within 2^-22 |x|, hi and lo TF32 (x - hi is exact).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The split K and V that the tf32x3 instance reads, one float32 buffer from
// `scratch`: k_hi, k_lo as [batch][sk][kv_heads][D] (k's layout), then
// vt_hi, vt_lo as [batch][kv_heads][D][skp], skp = sk rounded up to 8: V
// transposed, keys contiguous, each group of 8 keys in the slot order of
// slot_key, zero past sk.
struct Split {
  float* k_hi;
  float* k_lo;
  float* vt_hi;
  float* vt_lo;
  int skp;
};

inline Split split_parts(void* scratch, int batch, int sk, int kv_heads, int d) {
  const int skp = (sk + 7) / 8 * 8;
  const size_t nk = (size_t)batch * sk * kv_heads * d;
  const size_t nv = (size_t)batch * kv_heads * d * skp;
  float* base = static_cast<float*>(scratch);
  return {base, base + nk, base + 2 * nk, base + 2 * nk + nv, skp};
}

// The key in slot i of a group of 8 of V^T: 0, 2, 4, 6, 1, 3, 5, 7.  Lane
// (g, t) holds S's keys 2t and 2t + 1 of each 8-key group and the TF32 A
// fragment wants slots t and t + 4 from it (PTX ISA, wgmma .tf32 register
// fragments), so P enters P V as its accumulators lie once V^T's slots hold
// the keys in this order.
__host__ __device__ constexpr int slot_key(int i) { return 2 * (i % 4) + i / 4; }

constexpr int kSplitKeys = 32;      // keys a prepass block splits
constexpr int kSplitThreads = 256;

// The prepass: K split in place of k's layout (16-byte loads and stores),
// V staged through shared memory and written transposed, hi and lo.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, Split out, int sk,
                int kv_heads) {
  __shared__ float vs[kSplitKeys][D + 1];
  const int k0 = blockIdx.x * kSplitKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t stride = (size_t)kv_heads * D;                   // floats from key to key
  const size_t base = ((size_t)b * sk * kv_heads + kvh) * D;    // key 0 of this head
  for (int idx = threadIdx.x; idx < kSplitKeys * (D / 4); idx += kSplitThreads) {
    const int r = idx / (D / 4);
    const int c = 4 * (idx % (D / 4));
    float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < sk) {
      const size_t at = base + (size_t)(k0 + r) * stride + c;
      const float4 kx = __ldg(reinterpret_cast<const float4*>(k + at));
      vx = __ldg(reinterpret_cast<const float4*>(v + at));
      uint4 hi, lo;
      split(kx.x, hi.x, lo.x);
      split(kx.y, hi.y, lo.y);
      split(kx.z, hi.z, lo.z);
      split(kx.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(out.k_hi + at) = hi;
      *reinterpret_cast<uint4*>(out.k_lo + at) = lo;
    }
    vs[r][c] = vx.x;
    vs[r][c + 1] = vx.y;
    vs[r][c + 2] = vx.z;
    vs[r][c + 3] = vx.w;
  }
  __syncthreads();
  const size_t vt = ((size_t)b * kv_heads + kvh) * D * out.skp + k0;
  for (int idx = threadIdx.x; idx < D * kSplitKeys; idx += kSplitThreads) {
    const int d = idx / kSplitKeys;
    const int slot = idx % kSplitKeys;
    if (k0 + slot >= out.skp) continue;
    uint32_t hi, lo;
    split(vs[(slot & ~7) | slot_key(slot & 7)][d], hi, lo);
    reinterpret_cast<uint32_t*>(out.vt_hi)[vt + (size_t)d * out.skp + slot] = hi;
    reinterpret_cast<uint32_t*>(out.vt_lo)[vt + (size_t)d * out.skp + slot] = lo;
  }
}

// The instance for head dim D.  A float32 row of q or K is 4 D bytes, which
// TMA and wgmma swizzle over min(4 D, 128) bytes, so D = 128 is four boxes
// of 32 columns; V^T's rows are keys, 32 to a 128-byte box.  D = 112 takes
// D = 128's tiles for q_lo and K (kPad: TMA fills K's columns 112-127 with
// zeros, and S takes only the 14 k-steps below 112) and V^T's 112 rows as
// they are, so P V is a 112-wide product.  Shared memory,
// from a 1,024-byte aligned base: q_lo of both consumers (64 rows each),
// then the ring (each stage K_hi, K_lo, V^T_hi, V^T_lo of kBlockN keys),
// then the mbarriers.  q_hi lives in the consumers' registers.  At D = 128
// q_lo takes 64 KB and a 32-key stage 64 KB, so two stages fit; D <= 64
// keeps 64-key tiles.  Setmaxnreg 40 / 232 as in wg::.
template <int D>
struct Cfg {
  static constexpr int kPad = D > 64 ? 128 : D;             // columns of the q_lo and K tiles
  static constexpr int kSwizzle = D >= 32 ? 128 : 4 * D;   // bytes of a q / K swizzle span
  static constexpr int kBoxCols = kSwizzle / 4;
  static constexpr int kBoxes = kPad / kBoxCols;
  static constexpr int kSteps = kBoxCols / 8;               // k-steps of 8 inside a box
  static constexpr int kBlockN = kPad == 128 ? 32 : 64;     // keys per K/V tile
  static constexpr int kVBoxes = kBlockN / 32;              // V^T boxes: D rows x 32 keys
  static constexpr int kStages = kPad == 128 ? 2 : D == 64 ? 3 : 4;
  static constexpr int kConsumers = 2;
  static constexpr int kBlockM = 64 * kConsumers;           // q rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kQBox = 64 * kSwizzle;               // one consumer's rows of a q_lo box
  static constexpr int kKBox = kBlockN * kSwizzle;
  static constexpr int kVBox = D * 128;
  static constexpr int kKPart = kBoxes * kKBox;             // the hi or lo part of a K tile
  static constexpr int kVPart = kVBoxes * kVBox;            // the hi or lo part of a V^T tile
  static constexpr int kStage = 2 * kKPart + 2 * kVPart;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kConsumers * kBoxes * kQBox;
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 3 * kStages * 8 + 1024;   // + alignment slack
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    kThreads * ((65536 / kThreads) & ~7),
                "register split");
  static_assert(kQBox % 1024 == 0 && kKBox % 1024 == 0 && kVBox % 1024 == 0,
                "tiles keep 1,024-byte alignment");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

#define X3_F8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x N, f32) (+)= A (64 x 8) B^T, TF32: "ss" with A and B K-major in
// shared memory, "rs" with A from registers (a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4) of each warp's 16 rows).

__device__ __forceinline__ void mma_ss_n32(float (&d)[16],
                                           uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : X3_F8(d, 0), X3_F8(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void mma_ss_n64(float (&d)[32],
                                           uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : X3_F8(d, 0), X3_F8(d, 8), X3_F8(d, 16), X3_F8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs_n16(float (&d)[8],
                                           const uint32_t (&a)[4], uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : X3_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : X3_F8(d, 0), X3_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : X3_F8(d, 0), X3_F8(d, 8), X3_F8(d, 16), X3_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs_n112(float (&d)[56],
                                            const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : X3_F8(d, 0), X3_F8(d, 8), X3_F8(d, 16), X3_F8(d, 24),
        X3_F8(d, 32), X3_F8(d, 40), X3_F8(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : X3_F8(d, 0), X3_F8(d, 8), X3_F8(d, 16), X3_F8(d, 24),
        X3_F8(d, 32), X3_F8(d, 40), X3_F8(d, 48), X3_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}


#undef X3_F8

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  if constexpr (N == 32)
    mma_ss_n32(d, desc_a, desc_b, accumulate);
  else
    mma_ss_n64(d, desc_a, desc_b, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t desc_b, int accumulate) {
  if constexpr (N == 16)
    mma_rs_n16(d, a, desc_b, accumulate);
  else if constexpr (N == 32)
    mma_rs_n32(d, a, desc_b, accumulate);
  else if constexpr (N == 64)
    mma_rs_n64(d, a, desc_b, accumulate);
  else if constexpr (N == 112)
    mma_rs_n112(d, a, desc_b, accumulate);
  else
    mma_rs_n128(d, a, desc_b, accumulate);
}

// Byte offset of k-step kk (8 columns, 32 bytes) in a K-major tile of
// `box`-byte boxes of kSteps k-steps each.
template <int kSteps, int kBox>
__device__ __forceinline__ uint32_t kstep(int kk) {
  return (kk / kSteps) * kBox + (kk % kSteps) * 32;
}

// S = q K^T (64 x kBlockN) = q_hi K_lo + q_lo K_hi + q_hi K_hi, the small
// products first; q_hi from registers, q_lo and K from shared memory.
template <int D>
__device__ __forceinline__ void issue_s(float (&sacc)[Cfg<D>::kBlockN / 2],
                                        const uint32_t (&qh)[D / 8][4], uint32_t q_lo,
                                        uint32_t k_hi, uint32_t k_lo) {
  using C = Cfg<D>;
  constexpr int N = C::kBlockN;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t ko = kstep<C::kSteps, C::kKBox>(kk);
    mma_rs<N>(sacc, qh[kk], hopper::swizzled_desc<C::kSwizzle>(k_lo + ko), kk > 0);
    mma_ss<N>(sacc, hopper::swizzled_desc<C::kSwizzle>(q_lo + kstep<C::kSteps, C::kQBox>(kk)),
              hopper::swizzled_desc<C::kSwizzle>(k_hi + ko), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_rs<N>(sacc, qh[kk],
              hopper::swizzled_desc<C::kSwizzle>(k_hi + kstep<C::kSteps, C::kKBox>(kk)), 1);
}

// O += P V = P_lo V_hi + P_hi V_lo + P_hi V_hi: k-step j takes the 8 slots
// of key group j (32 bytes of each V^T row, 4 k-steps a box).
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         const uint32_t (&ph)[Cfg<D>::kBlockN / 8][4],
                                         const uint32_t (&pl)[Cfg<D>::kBlockN / 8][4],
                                         uint32_t v_hi, uint32_t v_lo) {
  using C = Cfg<D>;
#pragma unroll
  for (int j = 0; j < C::kBlockN / 8; ++j)
    mma_rs<D>(oacc, pl[j], hopper::swizzled_desc<128>(v_hi + kstep<4, C::kVBox>(j)), 1);
#pragma unroll
  for (int j = 0; j < C::kBlockN / 8; ++j)
    mma_rs<D>(oacc, ph[j], hopper::swizzled_desc<128>(v_lo + kstep<4, C::kVBox>(j)), 1);
#pragma unroll
  for (int j = 0; j < C::kBlockN / 8; ++j)
    mma_rs<D>(oacc, ph[j], hopper::swizzled_desc<128>(v_hi + kstep<4, C::kVBox>(j)), 1);
}

// P as the TF32 A fragments of k-step j, hi and lo: slots t and t + 4 take
// the keys 2t and 2t + 1 this lane holds (V^T's slots are permuted to match).
template <int N>
__device__ __forceinline__ void split_p(const float (&sacc)[N / 2], uint32_t (&ph)[N / 8][4],
                                        uint32_t (&pl)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split(sacc[4 * j], ph[j][0], pl[j][0]);          // row g,     key 2t
    split(sacc[4 * j + 2], ph[j][1], pl[j][1]);      // row g + 8, key 2t
    split(sacc[4 * j + 1], ph[j][2], pl[j][2]);      // row g,     key 2t + 1
    split(sacc[4 * j + 3], ph[j][3], pl[j][3]);      // row g + 8, key 2t + 1
  }
}

// kLse and kOff as wg::flash_fwd_wgmma_kernel's.
template <int D, bool kLse, bool kOff>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_k_hi,
                        const __grid_constant__ CUtensorMap tm_k_lo,
                        const __grid_constant__ CUtensorMap tm_vt_hi,
                        const __grid_constant__ CUtensorMap tm_vt_lo,
                        const float* __restrict__ q, float* __restrict__ o, int sq, int sk,
                        int heads, int kv_heads, float scale_log2, int causal,
                        float* __restrict__ lse, int q_offset) {
  using C = Cfg<D>;
  const int q_off = kOff ? q_offset : 0;
  constexpr int kSt = C::kStages;
  constexpr int kBlockN = C::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* v_full = k_full + kSt;
  uint64_t* empty = v_full + kSt;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int end = kv_end(q0, C::kBlockM, sq, sk, causal, q_off);
  const int n_tiles = (end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSt; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 4 * C::kConsumers);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    // Producer: K_hi, K_lo, V^T_hi, V^T_lo of tile n into stage n % kSt.
    hopper::reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kSt;
        uint8_t* stage = smem + C::kRing + s * C::kStage;
        hopper::mbar_wait(empty + s, ((n / kSt) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(k_full + s, 2 * C::kKPart);
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box) {
          hopper::tma_load_4d(stage + box * C::kKBox, &tm_k_hi, k_full + s, C::kBoxCols * box,
                              kvh, n * kBlockN, b);
          hopper::tma_load_4d(stage + C::kKPart + box * C::kKBox, &tm_k_lo, k_full + s,
                              C::kBoxCols * box, kvh, n * kBlockN, b);
        }
        hopper::mbar_arrive_expect_tx(v_full + s, 2 * C::kVPart);
#pragma unroll
        for (int box = 0; box < C::kVBoxes; ++box) {
          hopper::tma_load_4d(stage + 2 * C::kKPart + box * C::kVBox, &tm_vt_hi, v_full + s,
                              n * kBlockN + 32 * box, 0, kvh, b);
          hopper::tma_load_4d(stage + 2 * C::kKPart + C::kVPart + box * C::kVBox, &tm_vt_lo,
                              v_full + s, n * kBlockN + 32 * box, 0, kvh, b);
        }
      }
    }
  } else {
    // Consumer c owns block rows 64 c .. 64 c + 63.  Tile n's softmax runs
    // while tile n - 1's O += P V is in flight.
    hopper::reg_alloc<C::kConsumerRegs>();
    const int c = warpgroup - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_lo = q0 + 64 * c + 16 * warp + g;   // accumulator halves 0; + 8 halves 1

    // q, split: q_hi as the A fragments of S in registers, q_lo into this
    // consumer's rows of the swizzled q_lo tile.  Rows past Sq read as 0.
    uint32_t qh[D / 8][4];
    uint8_t* q_lo_tile = smem + C::kQ + c * C::kBoxes * C::kQBox;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row_lo + 8 * hr;
      const float* src = q + (((size_t)b * sq + min(row, sq - 1)) * heads + h) * D;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * kk + t + 4 * e;
          uint32_t lo;
          split(row < sq ? __ldg(src + col) : 0.f, qh[kk][hr + 2 * e], lo);
          *reinterpret_cast<uint32_t*>(
              q_lo_tile + (col / C::kBoxCols) * C::kQBox +
              wg::swizzled_chunk<C::kSwizzle>(16 * warp + g + 8 * hr, (col % C::kBoxCols) / 4) +
              4 * (col % 4)) = lo;
        }
    }
    hopper::fence_proxy_async_shared();   // q_lo, written by threads, read by wgmma
    hopper::named_sync(1 + c, 128);

    const uint32_t q_lo = hopper::smem_addr(q_lo_tile);
    const uint32_t ring = hopper::smem_addr(smem + C::kRing);
    auto k_hi = [&](int s) { return ring + s * C::kStage; };
    auto v_hi = [&](int s) { return ring + s * C::kStage + 2 * C::kKPart; };
    auto needs_mask = [&](int k0) {
      return k0 + kBlockN > sk || (causal && k0 + kBlockN - 1 > q0 + 64 * c + q_off);
    };
    // With tiles under 128 keys a block's last tiles can lie wholly above
    // consumer 0's diagonal: it computes up to its own last tile.
    const int my_tiles =
        (kv_end(q0 + 64 * c, 64, sq, sk, causal, q_off) + kBlockN - 1) / kBlockN;

    float sacc[kBlockN / 2];
    float oacc[D / 2];
    uint32_t ph[kBlockN / 8][4];
    uint32_t pl[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    wg::RowState st = {{kNegInf, kNegInf}, {0.f, 0.f}};
    float alpha[2];
    float neg_ms[2];
    auto softmax = [&](int n) {
      wg::softmax_max<kBlockN, 1>(sacc, st, alpha, neg_ms, needs_mask(n * kBlockN),
                                  n * kBlockN, row_lo + q_off, t, sk, causal, scale_log2);
      wg::softmax_exp<kBlockN>(sacc, st, alpha, neg_ms, scale_log2);
    };

    // Tile 0: S, softmax, P.
    hopper::mbar_wait(k_full, 0);
    hopper::wgmma_fence();
    issue_s<D>(sacc, qh, q_lo, k_hi(0), k_hi(0) + C::kKPart);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    softmax(0);
    split_p<kBlockN>(sacc, ph, pl);

    for (int n = 1; n < my_tiles; ++n) {
      const int s = n % kSt;
      const int sp = (n - 1) % kSt;
      hopper::mbar_wait(k_full + s, (n / kSt) & 1);
      hopper::wgmma_fence();
      issue_s<D>(sacc, qh, q_lo, k_hi(s), k_hi(s) + C::kKPart);
      hopper::wgmma_commit();
      hopper::mbar_wait(v_full + sp, ((n - 1) / kSt) & 1);
      issue_pv<D>(oacc, ph, pl, v_hi(sp), v_hi(sp) + C::kVPart);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // S of tile n is done; P V of tile n - 1 runs on
      hopper::fence_regs(sacc);
      softmax(n);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        hopper::fence_regs(ph[j]);
        hopper::fence_regs(pl[j]);
      }
      if (lane == 0) hopper::mbar_arrive(empty + sp);
      wg::rescale<D>(oacc, alpha);
      split_p<kBlockN>(sacc, ph, pl);
    }
    {
      const int sp = (my_tiles - 1) % kSt;
      hopper::mbar_wait(v_full + sp, ((my_tiles - 1) / kSt) & 1);
      hopper::wgmma_fence();
      issue_pv<D>(oacc, ph, pl, v_hi(sp), v_hi(sp) + C::kVPart);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      if (lane == 0) hopper::mbar_arrive(empty + sp);
    }
    // The block's tiles past this consumer's diagonal: released in order
    // once loaded, so the arrival counts toward that tile's round.
    for (int n = my_tiles; n < n_tiles; ++n) {
      const int s = n % kSt;
      hopper::mbar_wait(k_full + s, (n / kSt) & 1);
      if (lane == 0) hopper::mbar_arrive(empty + s);
    }

    // Epilogue: O / max(l, 1e-30), 8-byte stores of the rows below Sq (the
    // 4 lanes of a quad write 32 contiguous bytes of a row); lse as wg::'s.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = st.l[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float denom = fmaxf(l, 1e-30f);
      const int row = row_lo + 8 * hr;
      if constexpr (kLse) wg::store_lse(lse, st.m[hr], denom, scale_log2, row, t, b, h, sq, heads);
      if (row >= sq) continue;
      float* out = o + (((size_t)b * sq + row) * heads + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(oacc[4 * j + 2 * hr] / denom, oacc[4 * j + 2 * hr + 1] / denom);
    }
  }
}

// The prepass over k and v into `scratch` (split_parts' layout).
template <int D>
int split_launch(const float* k, const float* v, void* scratch, int batch, int sk, int kv_heads,
                 cudaStream_t stream) {
  const dim3 grid((sk + kSplitKeys - 1) / kSplitKeys, kv_heads, batch);
  split_kv_kernel<D><<<grid, kSplitThreads, 0, stream>>>(
      k, v, split_parts(scratch, batch, sk, kv_heads, D), sk, kv_heads);
  return static_cast<int>(cudaGetLastError());
}

// K's parts as 4-D tensor maps over (D, KV, Sk, B) in boxes of kBoxCols x 1
// x kBlockN x 1, V^T's over (skp, D, KV, B) in boxes of 32 x D x 1 x 1.
template <int D>
int launch(const void* q, const void* scratch, void* o, float* lse, int batch, int sq, int sk,
           int heads, int kv_heads, int causal, int q_off, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const Split parts = split_parts(const_cast<void*>(scratch), batch, sk, kv_heads, D);
  const cuuint64_t skp = parts.skp;
  CUtensorMap maps[4];
  const float* bases[4] = {parts.k_hi, parts.k_lo, parts.vt_hi, parts.vt_lo};
  for (int i = 0; i < 4; ++i) {
    const bool is_k = i < 2;
    const cuuint64_t dims[4] = {is_k ? (cuuint64_t)D : skp,
                                is_k ? (cuuint64_t)kv_heads : (cuuint64_t)D,
                                is_k ? (cuuint64_t)sk : (cuuint64_t)kv_heads, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {dims[0] * 4, dims[0] * dims[1] * 4,
                                   dims[0] * dims[1] * dims[2] * 4};
    const cuuint32_t box[4] = {is_k ? (cuuint32_t)C::kBoxCols : 32u,
                               is_k ? 1u : (cuuint32_t)D,
                               is_k ? (cuuint32_t)C::kBlockN : 1u, 1u};
    const int rc = hopper::encode_swizzled(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                           bases[i], dims, strides, box,
                                           is_k ? C::kSwizzle : 128);
    if (rc != 0) return rc;
  }
  const auto kernel = lse ? (q_off ? flash_fwd_tf32x3_kernel<D, true, true>
                                   : flash_fwd_tf32x3_kernel<D, true, false>)
                          : (q_off ? flash_fwd_tf32x3_kernel<D, false, true>
                                   : flash_fwd_tf32x3_kernel<D, false, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + C::kBlockM - 1) / C::kBlockM, heads, batch);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(q), static_cast<float*>(o),
      sq, sk, heads, kv_heads, scale * 1.4426950408889634f, causal, lse, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace x3

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct SimtSmem {
  static constexpr int kPitch = D + 4;         // floats per staged q / k / v row
  static constexpr int kPPitch = kRows + 4;    // floats per row of P^T
  static constexpr int kBytes = (2 * kRows * kPitch + kRows * kPPitch) * 4;
};

// Stage 64 float rows from row0 (row r at src + r * stride), pitch D + 4;
// rows past `valid` are 0.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, size_t stride,
                                          int row0, int valid) {
  constexpr int kVecsPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kVecsPerRow; idx += kThreads) {
    const int r = idx / kVecsPerRow;
    const int c = (idx - r * kVecsPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * stride + c));
    *reinterpret_cast<float4*>(dst + r * SimtSmem<D>::kPitch + c) = val;
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
                     int heads, int kv_heads, float scale, int causal, float* __restrict__ lse,
                     int q_off) {
  constexpr int P = SimtSmem<D>::kPitch;
  constexpr int PP = SimtSmem<D>::kPPitch;
  constexpr int VW = D % 32 == 0 ? 4 : 2;      // contiguous output columns per group
  constexpr int NJ = D / (8 * VW);             // output column groups per thread
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;                        // [64][P]   the q tile
  float* kvs = qs + kRows * P;                 // [64][P]   K, then V, of one tile
  float* ps = kvs + kRows * P;                 // [64][PP]  P^T: ps[key][row]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tx = threadIdx.x & 7;              // key / output column lane
  const int ty = threadIdx.x >> 3;             // owns rows 4 ty .. 4 ty + 3
  const size_t kv_stride = (size_t)kv_heads * D;
  const float* kb = k + ((size_t)b * sk * kv_heads + kvh) * D;
  const float* vb = v + ((size_t)b * sk * kv_heads + kvh) * D;
  stage_f32<D>(qs, q + ((size_t)b * sq * heads + h) * D, (size_t)heads * D, q0,
               min(kRows, sq - q0));

  float acc[4][NJ][VW];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[i][jj][e] = 0.f;
  }

  const int end = kv_end(q0, kRows, sq, sk, causal, q_off);
  for (int k0 = 0; k0 < end; k0 += kRows) {
    const int valid = min(kRows, sk - k0);
    __syncthreads();                           // q is staged; the last V is consumed
    stage_f32<D>(kvs, kb, kv_stride, k0, valid);
    __syncthreads();

    // The 8 key rows a quarter-warp reads (tx + 8 j) fall in 8 bank groups.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * P + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(kvs + (tx + 8 * j) * P + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // Scale, mask, and the online softmax of each row (its 64 scores lie in
    // 8 neighbouring lanes).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool keep = col < sk && (!causal || row + q_off >= col);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[i][jj][e] *= alpha;
    }
    // P transposed into shared memory: 16-byte stores of a key's 4 rows.
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 8 * j) * PP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();                           // every thread is done with K
    stage_f32<D>(kvs, vb, kv_stride, k0, valid);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kRows; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(ps + c * PP + 4 * ty);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float* vrow = kvs + c * P + tx * VW + 8 * VW * jj;
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow);
          vv[0] = w.x; vv[1] = w.y; vv[2] = w.z; vv[3] = w.w;
        } else {
          const float2 w = *reinterpret_cast<const float2*>(vrow);
          vv[0] = w.x; vv[1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[i][jj][e] = fmaf(pr[i], vv[e], acc[i][jj][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m is the scaled maximum here; the row's 8 lanes hold the same m and l.
    if constexpr (kLse)
      if (tx == 0) lse[((size_t)b * heads + h) * sq + row] = m[i] + logf(denom);
    float* out = o + (((size_t)b * sq + row) * heads + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VW; ++e) out[tx * VW + 8 * VW * jj + e] = acc[i][jj][e] / denom;
  }
}

template <int D>
int simt_launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                int sq, int sk, int heads, int kv_heads, int causal, int q_off, float scale,
                cudaStream_t stream) {
  const auto kernel = lse ? flash_fwd_f32_kernel<D, true> : flash_fwd_f32_kernel<D, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SimtSmem<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, kThreads, SimtSmem<D>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, heads, kv_heads, scale, causal, lse, q_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// k, v: [batch][sk][kv_heads][head_dim] float32, contiguous and 16-byte
// aligned, sk >= 1, head_dim 16, 32, 64, 112 or 128.  Writes the split K and V
// that the tf32x3 instance reads into `scratch`, (2 batch sk kv_heads +
// 2 batch kv_heads skp) head_dim floats, skp = sk rounded up to 8 (layout:
// flash::x3::Split).  Launches on `stream`; returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a head_dim it has no
// kernel for.
extern "C" int flash_split_kv_launch(const void* k, const void* v, void* scratch, int batch,
                                     int sk, int kv_heads, int head_dim, void* stream) {
  using namespace flash;
  if (batch <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  switch (head_dim) {
    case 16: return x3::split_launch<16>(kf, vf, scratch, batch, sk, kv_heads, s);
    case 32: return x3::split_launch<32>(kf, vf, scratch, batch, sk, kv_heads, s);
    case 64: return x3::split_launch<64>(kf, vf, scratch, batch, sk, kv_heads, s);
    case 112: return x3::split_launch<112>(kf, vf, scratch, batch, sk, kv_heads, s);
    case 128: return x3::split_launch<128>(kf, vf, scratch, batch, sk, kv_heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, o: [batch][sq][heads][head_dim]; k, v: [batch][sk][kv_heads][head_dim],
// contiguous and 16-byte aligned, heads % kv_heads == 0, sk >= 1.  dtype 0 is
// float32, 1 bfloat16; head_dim is 16, 32, 64, 112 or 128.  q_offset >= 0 is
// the position of q's first row (keys start at 0): when causal, row i sees
// keys j <= q_offset + i; a non-causal call ignores it.  `instance` names the
// kernel: 0 wgmma (bf16), 1 3xTF32 on wgmma (float32), 2 CUDA cores
// (float32), each at every head dim; -1 takes the static rule: float32 ->
// 3xTF32, bf16 -> wgmma.  The 3xTF32 instance reads K and V from `scratch`,
// split from these k and v by flash_split_kv_launch (k and v themselves
// are not read); the others ignore `scratch`.  Launches on `stream`,
// allocates nothing and does not synchronise; returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for an
// instance, dtype or head_dim it has no kernel for, a missing scratch, or a
// tensor map cuTensorMapEncodeTiled refuses.  Never a fallback: an instance
// that fails is an error.  `lse`, when not null, receives each query row's
// log-sum-exp of its scaled scores, m + log(max(l, 1e-30)) in natural-log
// units, as float32 [batch][heads][sq] (the reference's (B, KV, G, Sq), head
// h = kv G + g); when null, the kernel is the instance without lse, the
// one built before the lse output.
extern "C" int flash_attention_launch_instance(const void* q, const void* k, const void* v,
                                               void* o, const void* scratch, float* lse,
                                               int batch, int sq, int sk, int heads,
                                               int kv_heads, int head_dim, int dtype, int causal,
                                               int q_offset, float scale, int instance,
                                               void* stream) {
  using namespace flash;
  if (instance == -1) instance = dtype == 0 ? 1 : 0;
  if (batch <= 0 || sq <= 0) return 0;
  if ((instance == 1 && scratch == nullptr) || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_off = causal ? q_offset : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_INSTANCES(DIM)                                                                \
  if (head_dim == DIM) {                                                                    \
    if (instance == 0 && dtype == 1)                                                        \
      return wg::launch<DIM>(q, k, v, o, lse, batch, sq, sk, heads, kv_heads, causal, q_off, \
                             scale, s);                                                     \
    if (instance == 1 && dtype == 0)                                                        \
      return x3::launch<DIM>(q, scratch, o, lse, batch, sq, sk, heads, kv_heads, causal,    \
                             q_off, scale, s);                                              \
    if (instance == 2 && dtype == 0)                                                        \
      return simt_launch<DIM>(q, k, v, o, lse, batch, sq, sk, heads, kv_heads, causal, q_off, \
                              scale, s);                                                    \
  }
  FLASH_INSTANCES(16)
  FLASH_INSTANCES(32)
  FLASH_INSTANCES(64)
  FLASH_INSTANCES(112)
  FLASH_INSTANCES(128)
#undef FLASH_INSTANCES
  return static_cast<int>(cudaErrorInvalidValue);
}

// The static rule's entry point (instance -1), query offset 0.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const void* scratch, float* lse, int batch, int sq, int sk,
                                      int heads, int kv_heads, int head_dim, int dtype,
                                      int causal, float scale, void* stream) {
  return flash_attention_launch_instance(q, k, v, o, scratch, lse, batch, sq, sk, heads,
                                         kv_heads, head_dim, dtype, causal, 0, scale, -1, stream);
}
