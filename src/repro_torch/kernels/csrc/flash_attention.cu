// flash_attention: the GQA attention forward with an online softmax, for the
// LM scaffold's prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention_fwd_pallas (_make_kernel).  With q[B][Sq][H][D] and
// k, v[B][Sk][KV][D], query head h reads KV head h / (H / KV) and
//   o[b][i][h] = sum_j p_ij v[b][j][h / (H / KV)] / max(sum_j p_ij, 1e-30),
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = (q_i . k_j) * D^-0.5,
// with s_ij = -1e30 for j > i when causal (positions from 0 on both sides).
// The cast points are the TPU kernel's: the q . k products are exact in
// float32, p is rounded to v's type before PV, every sum is float32 and the
// output is rounded to q's type.
//
// What bounds it on an H100 (published peaks, 700 W), at the serving phase's
// shape B = 4, Sq = Sk = 4,096, H = 32, KV = 8, D = 128, bf16, causal: the
// two products do 2*B*H*S^2*D = 549.8 GFLOP after the causal half, 0.556 ms
// at the dense bf16 tensor rate of 989 TFLOP/s; q, o, k and v are 335.5 MB,
// 0.100 ms at 3.35 TB/s.  Operations bound it, at 0.556 ms a layer.
//
// Design (simple and right first).  One block of 128 threads per (batch,
// query head, 64-row q tile); the q tiles are issued last-first, so the
// long causal rows start early.  The block stages its q tile once and then
// walks 64-row K/V tiles of its KV head through shared memory, keeping each
// row's running max m and sum l in float32 and the output accumulator in
// registers.  When causal the walk stops after the diagonal tile (the TPU
// kernel's lower-triangle schedule), and the kernel masks the diagonal tile
// and the ragged Sq / Sk edges itself, so no length has to divide anything.
// Two instances of that schedule:
//
// * bf16 (the model's compute type): both products on the tensor cores with
//   the warp-level mma.sync.m16n8k16 bf16 -> f32.  Each warp owns 16 query
//   rows; its q fragments stay in registers, S comes back in the
//   accumulator layout, and P is re-packed from those registers into the A
//   fragments of PV (a row's scores lie in the 4 lanes of a quad, so its
//   max and sum are two shuffles).  K fragments are 32-bit shared loads; V
//   fragments come transposed by ldmatrix.trans.  Shared rows are padded by
//   16 bytes, so the 8 rows a fragment load touches fall in 8 bank groups.
// * float32 (the reduced configs): float32 FMAs on the CUDA cores, 4 rows
//   x 8 keys of the score tile and 4 rows x D/8 output columns a thread, P
//   through shared memory; ROADMAP's 2e-5 tolerance rules out bf16 or TF32
//   products there.
//
// What this leaves on the table: wgmma (the only way to the full tensor
// rate), asynchronous copies (cp.async or TMA) overlapping the next tile's
// load with this tile's math, and exp2 with the scale folded in.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kRows = 64;        // q rows per block; keys per K/V tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// Keys a q tile starting at q0 visits: up to its last row when causal.
__device__ __forceinline__ int kv_end(int q0, int sq, int sk, int causal) {
  return causal ? min(sk, min(q0 + kRows, sq)) : sk;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct MmaSmem {
  static constexpr int kPitch = D + 8;                      // bf16 per staged row
  static constexpr int kBytes = 3 * kRows * kPitch * 2;     // q, K, V tiles
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lane i gives the address of row i % 16
// of the 16 x 16 block at column offset 8 * (i / 16).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage 64 rows from row0 of a (S, heads, D) bf16 slice (row r at
// src + r * stride) into rows of pitch D + 8; rows past `valid` are 0.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           size_t stride, int row0, int valid) {
  constexpr int kVecsPerRow = D / 8;                        // 16-byte vectors
#pragma unroll
  for (int idx = threadIdx.x; idx < kRows * kVecsPerRow; idx += kThreads) {
    const int r = idx / kVecsPerRow;
    const int c = (idx - r * kVecsPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c));
    *reinterpret_cast<uint4*>(dst + r * MmaSmem<D>::kPitch + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int sq, int sk, int heads, int kv_heads, float scale, int causal) {
  constexpr int P = MmaSmem<D>::kPitch;
  constexpr int KS = D / 16;                 // k-steps of q . k
  constexpr int ND = D / 8;                  // 8-column tiles of the output
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* qs = smem_bf16;             // [64][P]
  __nv_bfloat16* ks = qs + kRows * P;        // [64][P]
  __nv_bfloat16* vs = ks + kRows * P;        // [64][P]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                   // accumulator rows g and g + 8
  const int t = lane & 3;                    // accumulator columns 2t, 2t + 1
  const int wr = 16 * (threadIdx.x >> 5);    // the warp's first row of the tile
  const size_t kv_stride = (size_t)kv_heads * D;
  const __nv_bfloat16* kb = k + ((size_t)b * sk * kv_heads + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * sk * kv_heads + kvh) * D;
  stage_bf16<D>(qs, q + ((size_t)b * sq * heads + h) * D, (size_t)heads * D, q0,
                min(kRows, sq - q0));
  __syncthreads();

  // The warp's q rows as A fragments: a0 (g, 2t), a1 (g + 8, 2t),
  // a2 (g, 2t + 8), a3 (g + 8, 2t + 8) of each 16-column step.
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* base = qs + (wr + g) * P + 16 * kk + 2 * t;
    qa[kk][0] = lds32(base);
    qa[kk][1] = lds32(base + 8 * P);
    qa[kk][2] = lds32(base + 8);
    qa[kk][3] = lds32(base + 8 * P + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + wr + g;              // row of c0, c1; row0 + 8 holds c2, c3

  const int end = kv_end(q0, sq, sk, causal);
  for (int k0 = 0; k0 < end; k0 += kRows) {
    const int valid = min(kRows, sk - k0);
    __syncthreads();                         // the previous tile's K and V are consumed
    stage_bf16<D>(ks, kb, kv_stride, k0, valid);
    stage_bf16<D>(vs, vb, kv_stride, k0, valid);
    __syncthreads();

    // S = q k^T for the warp's 16 rows x 64 keys: 8 tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kp = ks + (8 * j + g) * P + 16 * kk + 2 * t;
        mma_bf16(s[j], qa[kk], lds32(kp), lds32(kp + 8));
      }

    // Scale, mask, and the online softmax of rows row0 (hr = 0) and row0 + 8.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          const bool keep = col < sk && (!causal || row >= col);
          float& x = s[j][2 * hr + e];
          x = keep ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = expf(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * hr + e];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * hr] *= alpha;
        acc[nd][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: P re-packed from the S accumulators (keys 16 kk .. 16 kk + 15
    // are S tiles 2 kk and 2 kk + 1) into bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (16 * kk + (lane & 15)) * P + 16 * nd2 + 8 * (lane >> 4));
        mma_bf16(acc[2 * nd2], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * nd2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= sq) continue;
    const float denom = fmaxf(l[hr], 1e-30f);
    __nv_bfloat16* out = o + (((size_t)b * sq + row) * heads + h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(out + 8 * nd) =
          pack_bf16(acc[nd][2 * hr] / denom, acc[nd][2 * hr + 1] / denom);
  }
}

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

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
                     int heads, int kv_heads, float scale, int causal) {
  constexpr int P = SimtSmem<D>::kPitch;
  constexpr int PP = SimtSmem<D>::kPPitch;
  constexpr int VW = D >= 32 ? 4 : 2;          // contiguous output columns per group
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

  const int end = kv_end(q0, sq, sk, causal);
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
        const bool keep = col < sk && (!causal || row >= col);
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
    float* out = o + (((size_t)b * sq + row) * heads + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VW; ++e) out[tx * VW + 8 * VW * jj + e] = acc[i][jj][e] / denom;
  }
}

template <typename T, int D, typename Kernel>
int launch(Kernel kernel, int smem_bytes, const void* q, const void* k, const void* v,
           void* o, int batch, int sq, int sk, int heads, int kv_heads, int causal,
           float scale, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, heads, kv_heads, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// q, o: [batch][sq][heads][head_dim]; k, v: [batch][sk][kv_heads][head_dim],
// contiguous and 16-byte aligned, heads % kv_heads == 0, sk >= 1.  dtype 0 is
// float32 (CUDA cores), 1 bfloat16 (tensor cores); head_dim is 16, 32, 64 or
// 128.  Launches on `stream`, allocates nothing and does not synchronise;
// returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a dtype or head_dim it has no instance for.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int batch, int sq, int sk, int heads,
                                      int kv_heads, int head_dim, int dtype, int causal,
                                      float scale, void* stream) {
  using namespace flash;
  if (batch <= 0 || sq <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DIM)                                                                    \
  if (dtype == 0 && head_dim == DIM)                                                       \
    return launch<float, DIM>(flash_fwd_f32_kernel<DIM>, SimtSmem<DIM>::kBytes, q, k, v, o, \
                              batch, sq, sk, heads, kv_heads, causal, scale, s);          \
  if (dtype == 1 && head_dim == DIM)                                                       \
    return launch<__nv_bfloat16, DIM>(flash_fwd_mma_kernel<DIM>, MmaSmem<DIM>::kBytes, q, k, \
                                      v, o, batch, sq, sk, heads, kv_heads, causal, scale, s);
  FLASH_CASE(16)
  FLASH_CASE(32)
  FLASH_CASE(64)
  FLASH_CASE(128)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
