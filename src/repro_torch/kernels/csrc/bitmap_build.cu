// bitmap_build: the bitmap build (paper Section 3.2) on the card, one kernel
// for Bitmap-Set, -Xor and -Next (Algorithms 3-5), writing the packed words
// (bit j at word j / 32, bit j % 32, as core/bitmap.py::pack_bits lays them).
//
// Replaces no TPU kernel.  The reference builds bitmaps in jnp:
// src/repro/core/bitmap.py:71 bitmap_set_bits and :77 bitmap_xor_bits
// scatter-add into an int32[N, b] count matrix, and :83 bitmap_next_bits
// runs a lax.scan over the token positions under vmap.  The kernel was added
// because the port's plain version is a long run of launches over [N, b]
// temporaries (Next: about seven launches a token position, each over int64
// [N, b]; Set and Xor: an int32 count matrix, then an int64 copy to pack).
//
// What bounds it on an H100: Set and Xor read each set's valid tokens once
// and write its words once, so bytes bound them.  Next's probes are
// sequential within a set (each depends on the bits the previous ones set),
// so the longest set's chain of probes is a floor of its own.
//
// Design: one warp per set, its b bits in shared memory (W = b / 32 words a
// warp; where one warp's words exceed 48 KB, the set's output row in device
// memory stands in for them).  Set and Xor: the lanes take the row's valid
// tokens 32 at a time and atomicOr / atomicXor their bits, which does not
// depend on order.  Next: the lanes load and hash 32 tokens at a time, then
// the warp probes them one by one in row order.  A probe takes the first
// unset bit at or cyclically after h(t): in h(t)'s word at or above h(t)'s
// bit, else by a ballot over the free masks of the following words (word 0
// follows word W - 1, and h(t)'s word comes last, whole), then __ffs.  A
// full bitmap ends the set: the reference's argmin then picks bit 0, which
// is already set, so its bits do not change either.
#include <cstdint>
#include <cuda_runtime.h>

namespace bitmap_build {

constexpr int kPad = 0x7fffffff;        // PAD_TOKEN (core/constants.py)
constexpr int kMaxWarps = 8;            // sets a block
constexpr int kSmemBytes = 48 * 1024;   // shared memory a block without opt-in
constexpr unsigned kFull = 0xffffffffu;

enum Method : int { kSet = 0, kXor = 1, kNext = 2 };

// h(t), as core/bitmap.py::hash_positions: the token as uint32, optionally
// the Knuth mixer (a multiply that wraps, then t ^ (t >> 16)), modulo b.
__device__ __forceinline__ uint32_t hash_position(int token, uint32_t b, bool mix) {
  uint32_t t = static_cast<uint32_t>(token);
  if (mix) {
    t *= 2654435761u;
    t ^= t >> 16;
  }
  return t % b;
}

// The first unset bit at or cyclically after h among the w words of `bits`,
// which must hold one; called by the whole warp, every lane gets the bit.
__device__ __forceinline__ uint32_t probe(const uint32_t* bits, uint32_t h, int w,
                                          int lane) {
  const int wh = static_cast<int>(h >> 5);
  const uint32_t head = ~bits[wh] & (kFull << (h & 31));
  if (head) return (static_cast<uint32_t>(wh) << 5) + __ffs(head) - 1;
  for (int c = 0; c < w; c += 32) {
    const int k = c + lane;
    int word = wh + 1 + k;
    if (word >= w) word -= w;
    const uint32_t free = k < w ? ~bits[word] : 0u;
    const unsigned hit = __ballot_sync(kFull, free != 0u);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const uint32_t f = __shfl_sync(kFull, free, src);
      const int at = __shfl_sync(kFull, word, src);
      return (static_cast<uint32_t>(at) << 5) + __ffs(f) - 1;
    }
  }
  return 0u;  // not reached: the caller stops at a full bitmap
}

template <int kMethod, bool kGlobal>
__global__ void bitmap_build_kernel(const int* __restrict__ tokens,
                                    const int* __restrict__ lengths, int n_sets, int l,
                                    int b, int mix, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long set = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (set >= n_sets) return;  // the whole warp
  const int w = b >> 5;
  uint32_t* row_out = out + set * w;
  uint32_t* bits = kGlobal ? row_out : smem + warp * w;
  for (int k = lane; k < w; k += 32) bits[k] = 0u;
  __syncwarp();

  const int* row = tokens + set * l;
  // Positions at or past the set's length are not tokens of it.
  const int n = min(max(lengths[set], 0), l);
  const uint32_t ub = static_cast<uint32_t>(b);
  if (kMethod != kNext) {
    for (int p = lane; p < n; p += 32) {
      const int t = row[p];
      if (t == kPad) continue;
      const uint32_t h = hash_position(t, ub, mix);
      if (kMethod == kSet) {
        atomicOr(bits + (h >> 5), 1u << (h & 31));
      } else {
        atomicXor(bits + (h >> 5), 1u << (h & 31));
      }
    }
  } else {
    uint32_t filled = 0;  // bits set so far; the same on every lane
    for (int base = 0; base < n && filled < ub; base += 32) {
      const int p = base + lane;
      const int t = p < n ? row[p] : kPad;
      const bool valid = t != kPad;
      const uint32_t h = valid ? hash_position(t, ub, mix) : 0u;
      unsigned todo = __ballot_sync(kFull, valid);
      while (todo && filled < ub) {  // in row order
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const uint32_t j = probe(bits, __shfl_sync(kFull, h, src), w, lane);
        if (lane == 0) bits[j >> 5] |= 1u << (j & 31);
        __syncwarp();
        ++filled;
      }
    }
  }
  __syncwarp();
  if (!kGlobal) {
    for (int k = lane; k < w; k += 32) row_out[k] = bits[k];
  }
}

template <int kMethod>
cudaError_t launch(const int* tokens, const int* lengths, int n, int l, int b, int mix,
                   uint32_t* out, cudaStream_t stream) {
  const long long row_bytes = 4LL * (b / 32);
  const int warps = static_cast<int>(
      row_bytes * kMaxWarps <= kSmemBytes ? kMaxWarps : kSmemBytes / row_bytes);
  if (warps >= 1) {
    const long long grid = (static_cast<long long>(n) + warps - 1) / warps;
    bitmap_build_kernel<kMethod, false>
        <<<static_cast<unsigned>(grid), 32 * warps, static_cast<size_t>(warps * row_bytes),
           stream>>>(tokens, lengths, n, l, b, mix, out);
  } else {
    const long long grid = (static_cast<long long>(n) + kMaxWarps - 1) / kMaxWarps;
    bitmap_build_kernel<kMethod, true><<<static_cast<unsigned>(grid), 32 * kMaxWarps, 0,
                                         stream>>>(tokens, lengths, n, l, b, mix, out);
  }
  return cudaGetLastError();
}

}  // namespace bitmap_build

// tokens int32[n, l] (PAD_TOKEN-padded rows, read in row order), lengths
// int32[n], b a positive multiple of 32, method 0 / 1 / 2 (Set / Xor /
// Next), mix 0 or 1; out uint32[n, b / 32].
extern "C" int bitmap_build_launch(const void* tokens, const void* lengths, int n, int l,
                                   int b, int method, int mix, void* out, void* stream) {
  using namespace bitmap_build;
  if (n <= 0) return 0;
  if (b <= 0 || b % 32 != 0 || l < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tokens);
  const int* len = static_cast<const int*>(lengths);
  uint32_t* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case kSet: return static_cast<int>(launch<kSet>(t, len, n, l, b, mix, o, s));
    case kXor: return static_cast<int>(launch<kXor>(t, len, n, l, b, mix, o, s));
    case kNext: return static_cast<int>(launch<kNext>(t, len, n, l, b, mix, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
