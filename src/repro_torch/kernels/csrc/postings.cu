// The indexed driver's per-entry and per-candidate kernels, 1-D over a flat
// stream of G postings entries or G deduplicated candidate pairs:
//
//   entry_filter        replaces src/repro/kernels/postings.py
//                       entry_filter_pallas (_entry_filter_body)
//   pair_verdict        replaces pair_verdict_pallas (_pairwise_hamming,
//                       a loop over the W words of each candidate)
//   pair_verdict_tiled  replaces pair_verdict_tiled_pallas (candidate-major:
//                       XOR + popcount of a whole (tile, W) block, reduced
//                       along W)
//   pair_verdict_bitplane
//                       replaces pair_verdict_bitplane_pallas (a per-candidate
//                       inner product of {0, 1} int8 bit planes, then the
//                       same verdict)
//
// Booleans are one byte each (torch.bool), read and written as uint8.  No
// float is evaluated on the card: every threshold is the host-built int32
// prune table (repro_torch.core.bounds.prune_table) at key lr+ls, or lr*ls
// for cosine, which must cover every key of the lengths given.
//
// What bounds them on an H100: memory.  entry_filter reads eight int32s and
// a byte and writes a byte per entry (34 bytes) for about 15 integer
// operations; the pairwise verdicts read 8W + 8 bytes and write one per
// candidate for 3W + 10 operations; the bit-plane verdict reads 2b + 16
// bytes (planes, popcounts, lengths) and writes one per candidate, 2,065 at
// b = 1024 against 265 for the packed words at W = 32, for about b/2 + 10
// operations.  All are far below the card's operations-per-byte balance, so the design aim is coalesced, single-pass
// traffic: one thread per entry with consecutive threads on consecutive
// elements; for the candidate words, loads that are contiguous across a
// warp whatever W is.
#include "verdict.cuh"

namespace bitmap_join {

constexpr int kThreads1D = 256;   // entries or candidates per block (staged)
constexpr int kStageMaxW = 8;     // widest rows the staged verdict takes

// Admission of one expanded postings entry: valid, both sets non-empty,
// lo <= |r| <= hi, the positional bound 1 + min(|r| - pos_r - 1,
// |s| - pos_s - 1) at least the prune threshold, and for a self-join the
// strict idx_r < idx_s triangle.
__global__ void __launch_bounds__(kThreads1D)
entry_filter_kernel(const int* __restrict__ len_r, const int* __restrict__ pos_r,
                    const int* __restrict__ len_s, const int* __restrict__ pos_s,
                    const int* __restrict__ lo, const int* __restrict__ hi,
                    const int* __restrict__ idx_r, const int* __restrict__ idx_s,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ table, int g, int key_prod,
                    int self_join, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads1D + threadIdx.x;
  if (i >= g) return;
  const int lr = len_r[i];
  const int ls = len_s[i];
  bool ok = valid[i] != 0 && lr > 0 && ls > 0 && lr >= lo[i] && lr <= hi[i];
  if (ok) {
    const int ub = 1 + min(lr - pos_r[i] - 1, ls - pos_s[i] - 1);
    ok = ub >= __ldg(table + (key_prod ? lr * ls : lr + ls));
  }
  if (ok && self_join) ok = idx_r[i] < idx_s[i];
  out[i] = ok ? 1 : 0;
}

// One thread per candidate, looping over its W words (the `swar` form).
// Consecutive threads read rows W words apart, so a warp's loads are
// contiguous only when W == 1; kept as the reference's word-loop twin.
__global__ void __launch_bounds__(kThreads1D)
pair_verdict_kernel(const uint32_t* __restrict__ wr,
                    const uint32_t* __restrict__ ws,
                    const int* __restrict__ len_r, const int* __restrict__ len_s,
                    const int* __restrict__ table, int g, int w, int key_prod,
                    int cutoff, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads1D + threadIdx.x;
  if (i >= g) return;
  const uint32_t* a = wr + (size_t)i * w;
  const uint32_t* b = ws + (size_t)i * w;
  int ham = 0;
  for (int k = 0; k < w; ++k) ham += __popc(__ldg(a + k) ^ __ldg(b + k));
  out[i] = verdict(ham, len_r[i], len_s[i], table, key_prod, cutoff) ? 1 : 0;
}

// Candidate-major, W <= kStageMaxW: the block's 256 candidates own one
// contiguous (256 x W) span of each word array; the block copies both spans
// into shared memory with consecutive threads on consecutive words, then
// each thread reduces its own row.  Rows are kept at an odd pitch (W | 1)
// so the 32 rows a warp reads fall in 32 different banks.
__global__ void __launch_bounds__(kThreads1D)
pair_verdict_staged_kernel(const uint32_t* __restrict__ wr,
                           const uint32_t* __restrict__ ws,
                           const int* __restrict__ len_r,
                           const int* __restrict__ len_s,
                           const int* __restrict__ table, int g, int w,
                           int key_prod, int cutoff, uint8_t* __restrict__ out) {
  __shared__ uint32_t sr[kThreads1D * (kStageMaxW + 1)];
  __shared__ uint32_t ss[kThreads1D * (kStageMaxW + 1)];
  const int g0 = blockIdx.x * kThreads1D;
  const int rows = min(kThreads1D, g - g0);
  const int pitch = w | 1;
  const size_t base = (size_t)g0 * w;
  for (int idx = threadIdx.x; idx < rows * w; idx += kThreads1D) {
    const int row = idx / w;
    const int at = row * pitch + (idx - row * w);
    sr[at] = __ldg(wr + base + idx);
    ss[at] = __ldg(ws + base + idx);
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  int ham = 0;
  for (int k = 0; k < w; ++k) ham += __popc(sr[t * pitch + k] ^ ss[t * pitch + k]);
  out[g0 + t] = verdict(ham, len_r[g0 + t], len_s[g0 + t], table, key_prod, cutoff) ? 1 : 0;
}

// Candidate-major, W > kStageMaxW: a group of `lanes` (8, 16 or 32)
// consecutive lanes per candidate; lane j sums words j, j + lanes, ...,
// so a group's loads are contiguous, then a butterfly shuffle inside the
// group (groups are aligned within the warp) leaves the sum in every lane.
__global__ void __launch_bounds__(kThreads1D)
pair_verdict_lanes_kernel(const uint32_t* __restrict__ wr,
                          const uint32_t* __restrict__ ws,
                          const int* __restrict__ len_r,
                          const int* __restrict__ len_s,
                          const int* __restrict__ table, int g, int w,
                          int lanes, int key_prod, int cutoff,
                          uint8_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads1D + threadIdx.x;
  const long long i = t / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  int ham = 0;
  if (i < g) {
    const uint32_t* a = wr + (size_t)i * w;
    const uint32_t* b = ws + (size_t)i * w;
    for (int k = lane; k < w; k += lanes) ham += __popc(__ldg(a + k) ^ __ldg(b + k));
  }
  // Every lane of the warp takes part (no early return before the shuffle).
  for (int off = lanes >> 1; off > 0; off >>= 1)
    ham += __shfl_xor_sync(0xffffffffu, ham, off);
  if (i < g && lane == 0)
    out[i] = verdict(ham, len_r[i], len_s[i], table, key_prod, cutoff) ? 1 : 0;
}

// Bit planes, a group of `lanes` (2 to 16) consecutive lanes per candidate:
// lane j reads 16-byte vectors j, j + lanes, ... of both plane rows (so a
// group's loads are contiguous), takes the inner product with __dp4a on
// each 4-byte pack, and a butterfly shuffle inside the group leaves the sum
// in every lane.  A per-candidate dot has no reuse across candidates, so
// tensor cores do not apply: this is a streaming, memory-bound kernel.
// Rows are b bytes, b % 32 == 0, 16-byte aligned.
__global__ void __launch_bounds__(kThreads1D)
pair_verdict_bitplane_kernel(const int8_t* __restrict__ pr,
                             const int8_t* __restrict__ ps,
                             const int* __restrict__ pc_r,
                             const int* __restrict__ pc_s,
                             const int* __restrict__ len_r,
                             const int* __restrict__ len_s,
                             const int* __restrict__ table, int g, int b,
                             int lanes, int key_prod, int cutoff,
                             uint8_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads1D + threadIdx.x;
  const long long i = t / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  int dot = 0;
  if (i < g) {
    const int4* a = reinterpret_cast<const int4*>(pr + (size_t)i * b);
    const int4* q = reinterpret_cast<const int4*>(ps + (size_t)i * b);
    for (int v = lane; v < (b >> 4); v += lanes) {
      const int4 x = __ldg(a + v);
      const int4 y = __ldg(q + v);
      dot = __dp4a(x.x, y.x, dot);
      dot = __dp4a(x.y, y.y, dot);
      dot = __dp4a(x.z, y.z, dot);
      dot = __dp4a(x.w, y.w, dot);
    }
  }
  // Every lane of the warp takes part (no early return before the shuffle).
  for (int off = lanes >> 1; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (i < g && lane == 0) {
    const int ham = pc_r[i] + pc_s[i] - 2 * dot;
    out[i] = verdict(ham, len_r[i], len_s[i], table, key_prod, cutoff) ? 1 : 0;
  }
}

}  // namespace bitmap_join

// Each launches on `stream`, allocates nothing and does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).

extern "C" int entry_filter_launch(const void* len_r, const void* pos_r,
                                   const void* len_s, const void* pos_s,
                                   const void* lo, const void* hi,
                                   const void* idx_r, const void* idx_s,
                                   const void* valid, const void* table, int g,
                                   int key_prod, int self_join, void* out,
                                   void* stream) {
  using namespace bitmap_join;
  if (g <= 0) return 0;
  const unsigned blocks = (unsigned)((g + kThreads1D - 1) / kThreads1D);
  entry_filter_kernel<<<blocks, kThreads1D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(len_r), static_cast<const int*>(pos_r),
      static_cast<const int*>(len_s), static_cast<const int*>(pos_s),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const int*>(idx_r), static_cast<const int*>(idx_s),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(table), g,
      key_prod, self_join, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_verdict_launch(const void* wr, const void* ws,
                                   const void* len_r, const void* len_s,
                                   const void* table, int g, int w, int key_prod,
                                   int cutoff, void* out, void* stream) {
  using namespace bitmap_join;
  if (g <= 0) return 0;
  const unsigned blocks = (unsigned)((g + kThreads1D - 1) / kThreads1D);
  pair_verdict_kernel<<<blocks, kThreads1D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wr), static_cast<const uint32_t*>(ws),
      static_cast<const int*>(len_r), static_cast<const int*>(len_s),
      static_cast<const int*>(table), g, w, key_prod, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_verdict_tiled_launch(const void* wr, const void* ws,
                                         const void* len_r, const void* len_s,
                                         const void* table, int g, int w,
                                         int key_prod, int cutoff, void* out,
                                         void* stream) {
  using namespace bitmap_join;
  if (g <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* r = static_cast<const uint32_t*>(wr);
  const uint32_t* q = static_cast<const uint32_t*>(ws);
  const int* lr = static_cast<const int*>(len_r);
  const int* ls = static_cast<const int*>(len_s);
  const int* tab = static_cast<const int*>(table);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (w <= kStageMaxW) {
    const unsigned blocks = (unsigned)((g + kThreads1D - 1) / kThreads1D);
    pair_verdict_staged_kernel<<<blocks, kThreads1D, 0, s>>>(
        r, q, lr, ls, tab, g, w, key_prod, cutoff, o);
  } else {
    const int lanes = w >= 32 ? 32 : (w >= 16 ? 16 : 8);
    const long long threads = (long long)g * lanes;
    const unsigned blocks = (unsigned)((threads + kThreads1D - 1) / kThreads1D);
    pair_verdict_lanes_kernel<<<blocks, kThreads1D, 0, s>>>(
        r, q, lr, ls, tab, g, w, lanes, key_prod, cutoff, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// pr/ps are int8[g][b] bit planes, b % 32 == 0, 16-byte aligned.
extern "C" int pair_verdict_bitplane_launch(const void* pr, const void* ps,
                                            const void* pc_r, const void* pc_s,
                                            const void* len_r, const void* len_s,
                                            const void* table, int g, int b,
                                            int key_prod, int cutoff, void* out,
                                            void* stream) {
  using namespace bitmap_join;
  if (g <= 0) return 0;
  int lanes = 16;  // the largest power of two <= min(16, b / 16)
  while (lanes > 1 && lanes > (b >> 4)) lanes >>= 1;
  const long long threads = (long long)g * lanes;
  const unsigned blocks = (unsigned)((threads + kThreads1D - 1) / kThreads1D);
  pair_verdict_bitplane_kernel<<<blocks, kThreads1D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pr), static_cast<const int8_t*>(ps),
      static_cast<const int*>(pc_r), static_cast<const int*>(pc_s),
      static_cast<const int*>(len_r), static_cast<const int*>(len_s),
      static_cast<const int*>(table), g, b, lanes, key_prod, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
