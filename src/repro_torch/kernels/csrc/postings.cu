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
// and the two stage kernels that the indexed driver runs in their place on
// the card (impl="auto"), each fusing the gathers that feed it:
//
//   expand_filter       the CSR expansion of a probe chunk and entry_filter's
//                       admission test (the TPU kernel it redesigns:
//                       entry_filter_pallas), writing the sentinel-keyed
//                       entry streams itself
//   verdict_verify      the pairwise verdict over packed words read at the
//                       candidates' own rows (redesigns
//                       pair_verdict_tiled_pallas) and exact verification of
//                       the bitmap survivors only
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
// warp whatever W is.  The stage kernels go further on the same rule: fuse,
// and keep intermediates out of device memory.  expand_filter reads 12
// bytes at each expanded entry and writes 8 a slot, where the PyTorch
// composition it replaces materialised about ten int32 / int64 streams of
// cap slots; verdict_verify reads a candidate's words where they lie (the
// corpus's rows stay in the 50 MB L2) and its token rows only when the
// bitmap lets it through, where the composition gathered (cap, L) token
// blocks for every slot.
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


// ---------------------------------------------------------------------------
// The indexed driver's stage kernels (impl="auto" on the card)
// ---------------------------------------------------------------------------

constexpr int kExpandTile = 1024;   // slots of the entry stream per block
constexpr int kPad = 0x7fffffff;    // PAD_TOKEN, and the streams' sentinel

// The segment of slot g: the number of segment ends <= g
// (torch.searchsorted(seg_end, g, right=True)), searched in [a, b], which
// must hold the answer.
__device__ __forceinline__ int segment_of(const int* __restrict__ seg_end, int g,
                                          int a, int b) {
  while (a < b) {
    const int m = (a + b) >> 1;
    if (__ldg(seg_end + m) <= g) a = m + 1; else b = m;
  }
  return a;
}

// CSR expansion and admission of one probe chunk's entry stream.  The
// chunk's (probe, prefix position) segments k = s_loc * lp + pos hold cnt[k]
// postings from rng[k] on; seg_end is their inclusive prefix sum, so the
// stream has n = seg_end[nseg - 1] entries, read here from device memory.
// Slot g < n is entry g - (seg_end[k] - cnt[k]) of segment k; it keeps
// (post_set[pidx], s_loc) if entry_filter_kernel's test admits it, and every
// other slot, up to cap, holds the sentinel pair.  The block finds the
// segments of its first and last live slot by one binary search each over
// the whole of seg_end (at most C * lp int32s, L2-resident), then each
// thread searches only between them, most often a handful of segments.
// Consecutive threads take consecutive slots, so inside a segment they read
// consecutive postings and every load and store is coalesced.
__global__ void __launch_bounds__(kThreads1D)
expand_filter_kernel(const int* __restrict__ rng, const int* __restrict__ cnt,
                     const int* __restrict__ seg_end, int nseg,
                     const int* __restrict__ post_set, const int* __restrict__ post_pos,
                     const int* __restrict__ post_len, int npost,
                     const int* __restrict__ probe_len, const int* __restrict__ lo,
                     const int* __restrict__ hi, const int* __restrict__ table, int cap,
                     int lp, int s0, int key_prod, int self_join,
                     int* __restrict__ rr, int* __restrict__ ss) {
  __shared__ int bounds[2];
  const int g0 = blockIdx.x * kExpandTile;
  const int g_end = min(cap - g0, kExpandTile) + g0;
  const int live_end = min(g_end, __ldg(seg_end + nseg - 1));
  if (threadIdx.x < 2 && g0 < live_end)
    bounds[threadIdx.x] = segment_of(seg_end, threadIdx.x == 0 ? g0 : live_end - 1,
                                     0, nseg - 1);
  __syncthreads();
  for (int g = g0 + threadIdx.x; g < g_end; g += kThreads1D) {
    int r_out = kPad, s_out = kPad;
    if (g < live_end) {
      const int k = segment_of(seg_end, g, bounds[0], bounds[1]);
      const int within = g - (__ldg(seg_end + k) - __ldg(cnt + k));
      const int pidx = min(max(__ldg(rng + k) + within, 0), npost - 1);
      const int r_idx = __ldg(post_set + pidx);
      const int s_loc = k / lp;
      const int lr = __ldg(post_len + pidx);
      const int ls = __ldg(probe_len + s_loc);
      bool ok = lr > 0 && ls > 0 && lr >= __ldg(lo + s_loc) && lr <= __ldg(hi + s_loc);
      if (ok) {
        const int ub = 1 + min(lr - __ldg(post_pos + pidx) - 1, ls - (k - s_loc * lp) - 1);
        ok = ub >= __ldg(table + (key_prod ? lr * ls : lr + ls));
      }
      if (ok && self_join) ok = r_idx < s0 + s_loc;
      if (ok) {
        r_out = r_idx;
        s_out = s_loc;
      }
    }
    rr[g] = r_out;
    ss[g] = s_out;
  }
}

// The pairwise verdict of one chunk's deduplicated candidates, with exact
// verification of its survivors.  A block owns 256 slots.  First the
// verdict: one thread a candidate (lanes == 1, W <= kStageMaxW) or a group
// of `lanes` consecutive lanes a candidate (lane j sums words j, j + lanes,
// ..., a butterfly inside the group), each reading the two packed-word rows
// and lengths at the candidate's own (r, s).  Slots whose slot_ok is false
// read nothing more and are written false.  A bitmap survivor goes into the
// block's shared-memory queue; then each warp takes survivors from it: its
// lanes stride over r's len_r tokens, each binary-searches s's first len_s
// tokens for its own, and a warp sum gives the overlap, held against the
// min-overlap table.  That is verify.pairwise_overlap's count because token
// rows are strictly increasing on [0, length) with their PAD tail after it
// (tests/test_torch_stage_kernels.py asserts it of every collection the
// join path takes).
__global__ void __launch_bounds__(kThreads1D)
verdict_verify_kernel(const int* __restrict__ cand_r, const int* __restrict__ cand_s,
                      const uint8_t* __restrict__ slot_ok,
                      const uint32_t* __restrict__ words_r,
                      const uint32_t* __restrict__ words_s, int w,
                      const int* __restrict__ len_r, const int* __restrict__ len_s,
                      const int* __restrict__ tok_r, int l_r,
                      const int* __restrict__ tok_s, int l_s,
                      const int* __restrict__ table, const int* __restrict__ need,
                      int cap, int lanes, int key_prod, int cutoff,
                      uint8_t* __restrict__ cand_out, uint8_t* __restrict__ ok_out) {
  __shared__ int queue[kThreads1D];
  __shared__ int n_queue;
  const long long base = (long long)blockIdx.x * kThreads1D;
  if (threadIdx.x == 0) n_queue = 0;
  __syncthreads();

  if (lanes == 1) {
    const long long i = base + threadIdx.x;
    if (i < cap) {
      bool cand = false;
      if (slot_ok[i]) {
        const int r = __ldg(cand_r + i);
        const int s = __ldg(cand_s + i);
        const uint32_t* a = words_r + (size_t)r * w;
        const uint32_t* b = words_s + (size_t)s * w;
        int ham = 0;
        for (int k = 0; k < w; ++k) ham += __popc(__ldg(a + k) ^ __ldg(b + k));
        cand = verdict(ham, __ldg(len_r + r), __ldg(len_s + s), table, key_prod, cutoff);
      }
      cand_out[i] = cand ? 1 : 0;
      if (cand) queue[atomicAdd(&n_queue, 1)] = threadIdx.x;
      else ok_out[i] = 0;
    }
  } else {
    // Every group runs kThreads1D / groups == lanes rounds, so whole warps
    // take part in every shuffle.
    const int groups = kThreads1D / lanes;
    const int lane = threadIdx.x & (lanes - 1);
    for (int t = threadIdx.x / lanes; t < kThreads1D; t += groups) {
      const long long i = base + t;
      const bool live = i < cap && slot_ok[i] != 0;
      int r = 0, s = 0, ham = 0;
      if (live) {
        r = __ldg(cand_r + i);
        s = __ldg(cand_s + i);
        const uint32_t* a = words_r + (size_t)r * w;
        const uint32_t* b = words_s + (size_t)s * w;
        for (int k = lane; k < w; k += lanes) ham += __popc(__ldg(a + k) ^ __ldg(b + k));
      }
      for (int off = lanes >> 1; off > 0; off >>= 1)
        ham += __shfl_xor_sync(0xffffffffu, ham, off);
      if (lane == 0 && i < cap) {
        const bool cand = live && verdict(ham, __ldg(len_r + r), __ldg(len_s + s), table,
                                          key_prod, cutoff);
        cand_out[i] = cand ? 1 : 0;
        if (cand) queue[atomicAdd(&n_queue, 1)] = t;
        else ok_out[i] = 0;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int q = warp; q < n_queue; q += kThreads1D / 32) {
    const long long i = base + queue[q];
    const int r = __ldg(cand_r + i);
    const int s = __ldg(cand_s + i);
    const int lr = __ldg(len_r + r);
    const int ls = __ldg(len_s + s);
    const int nr = min(lr, l_r), ns = min(ls, l_s);
    const int* a = tok_r + (size_t)r * l_r;
    const int* b = tok_s + (size_t)s * l_s;
    int hits = 0;
    for (int j = lane; j < nr; j += 32) {
      const int t = __ldg(a + j);
      int x = 0, y = ns;
      while (x < y) {
        const int m = (x + y) >> 1;
        if (__ldg(b + m) < t) x = m + 1; else y = m;
      }
      hits += x < ns && __ldg(b + x) == t;
    }
    hits = __reduce_add_sync(0xffffffffu, hits);
    if (lane == 0)
      ok_out[i] = hits >= __ldg(need + (key_prod ? lr * ls : lr + ls)) ? 1 : 0;
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

// rng, cnt, seg_end: int32[nseg], nseg >= 1; post_*: int32[npost], npost >= 1;
// probe_len, lo, hi: int32[nseg / lp]; rr, ss: int32[cap].
extern "C" int expand_filter_launch(const void* rng, const void* cnt, const void* seg_end,
                                    int nseg, const void* post_set, const void* post_pos,
                                    const void* post_len, int npost, const void* probe_len,
                                    const void* lo, const void* hi, const void* table,
                                    int cap, int lp, int s0, int key_prod, int self_join,
                                    void* rr, void* ss, void* stream) {
  using namespace bitmap_join;
  if (cap <= 0) return 0;
  const unsigned blocks = (unsigned)((cap + kExpandTile - 1) / kExpandTile);
  expand_filter_kernel<<<blocks, kThreads1D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rng), static_cast<const int*>(cnt),
      static_cast<const int*>(seg_end), nseg, static_cast<const int*>(post_set),
      static_cast<const int*>(post_pos), static_cast<const int*>(post_len), npost,
      static_cast<const int*>(probe_len), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<const int*>(table), cap, lp, s0, key_prod,
      self_join, static_cast<int*>(rr), static_cast<int*>(ss));
  return static_cast<int>(cudaGetLastError());
}

// cand_r, cand_s: int32[cap]; slot_ok, cand_out, ok_out: bool[cap];
// words_r: uint32[NR][w], words_s: uint32[NS][w]; tok_r: int32[NR][l_r],
// tok_s: int32[NS][l_s]; table and need cover every key of the lengths.
extern "C" int verdict_verify_launch(const void* cand_r, const void* cand_s,
                                     const void* slot_ok, const void* words_r,
                                     const void* words_s, int w, const void* len_r,
                                     const void* len_s, const void* tok_r, int l_r,
                                     const void* tok_s, int l_s, const void* table,
                                     const void* need, int cap, int key_prod, int cutoff,
                                     void* cand_out, void* ok_out, void* stream) {
  using namespace bitmap_join;
  if (cap <= 0) return 0;
  const int lanes = w <= kStageMaxW ? 1 : (w >= 32 ? 32 : (w >= 16 ? 16 : 8));
  const unsigned blocks = (unsigned)((cap + kThreads1D - 1) / kThreads1D);
  verdict_verify_kernel<<<blocks, kThreads1D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand_r), static_cast<const int*>(cand_s),
      static_cast<const uint8_t*>(slot_ok), static_cast<const uint32_t*>(words_r),
      static_cast<const uint32_t*>(words_s), w, static_cast<const int*>(len_r),
      static_cast<const int*>(len_s), static_cast<const int*>(tok_r), l_r,
      static_cast<const int*>(tok_s), l_s, static_cast<const int*>(table),
      static_cast<const int*>(need), cap, lanes, key_prod, cutoff,
      static_cast<uint8_t*>(cand_out), static_cast<uint8_t*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}
