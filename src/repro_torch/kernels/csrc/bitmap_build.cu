// bitmap_build: the bitmap build (paper Section 3.2) on the card, one source
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
// Two forms, picked by the wrapper (kernels/bitmap_build.py::form, a fixed
// rule on the method, b and N) and passed in as `form`:
//
// The lane form (one lane a set; W = b / 32 words up to kLaneMaxWords): a
// warp builds 32 consecutive rows, each lane its own row in row order, so a
// probe costs one lane a dozen instructions and no lane waits on another.
// A lane's words live in registers up to kRegWords words (an unrolled
// select picks word k; b a compile-time constant, so `% b` is a mask or a
// multiply), else in shared memory laid out [W][33] a warp (word k of lane
// i at k * 33 + i: the bank is the lane, and the write-out's reads across a
// row do not conflict either).  Next keeps a register summary of the words
// that still have a free bit, so a probe that misses h(t)'s word finds the
// next free word cyclically with one __ffs.  A lane reads its tokens
// through L1 in 16-byte vectors, 8 positions ahead of the ones it hashes
// (16 where the words are in shared memory, whose reads and writes lengthen
// a token's work), the first issued together with its length; it reads no vector
// past its length, and the warp stops at its longest row.  Set and Xor
// fold a bit into the word with OR / XOR (in shared memory an atomicOr /
// atomicXor, whose result nothing waits on, where a load, the OR and a
// store would lengthen the lane's chain; no two lanes share a word), Next
// takes the first free bit at or cyclically after h(t).  No warp-wide step:
// the lanes only meet to write the words.  Its limit is the lanes' work a
// token (the probes' instructions for Next), not the bytes: it loses to the
// warp form below a few thousand rows, where too few warps share the card.
//
// The warp form (one warp a set; every width): the lanes take the row's
// valid tokens 32 at a time and atomicOr / atomicXor their bits into
// shared memory, which does not depend on order; Next loads and hashes 32
// tokens at a time, then the warp probes them one by one in row order
// (h(t)'s word at or above h(t)'s bit, else a ballot over the free masks of
// the following words, word 0 after word W - 1, h(t)'s word last).  Where
// one warp's words exceed 48 KB, the set's output row holds them.
//
// In both forms a full bitmap ends the set: the reference's argmin then
// picks bit 0, which is already set, so its bits do not change either.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace bitmap_build {

constexpr int kPad = 0x7fffffff;        // PAD_TOKEN (core/constants.py)
constexpr int kMaxWarps = 8;            // warp form: sets a block
constexpr int kSmemBytes = 48 * 1024;   // shared memory a block without opt-in
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneMaxWords = 32;       // lane form: the widest bitmap, b = 1,024
constexpr int kRegWords = 8;            // lane form: words kept in registers
constexpr bool kSmemAtomics = true;     // lane form: Set / Xor fold shared words by atomics
constexpr int kLaneWarps = 4;           // lane form: warps a block
constexpr int kStride = 33;             // lane form: a warp's shared words a word
constexpr int kAheadReg = 8;            // lane form: positions read ahead (a multiple of
constexpr int kAheadSmem = 16;          // 4), words in registers / in shared memory

enum Method : int { kSet = 0, kXor = 1, kNext = 2 };
enum Form : int { kWarpForm = 0, kLaneForm = 1 };

// h(t), as core/bitmap.py::hash_positions: the token as uint32, optionally
// the Knuth mixer (a multiply that wraps, then t ^ (t >> 16)), modulo b;
// kB > 0 is b known at compile time.
template <int kB = 0>
__device__ __forceinline__ uint32_t hash_position(int token, uint32_t b, bool mix) {
  uint32_t t = static_cast<uint32_t>(token);
  if (mix) {
    t *= 2654435761u;
    t ^= t >> 16;
  }
  return kB > 0 ? t % static_cast<uint32_t>(kB) : t % b;
}

// ---------------------------------------------------------------- warp form

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
__global__ void warp_kernel(const int* __restrict__ tokens, const int* __restrict__ lengths,
                            int n_sets, int l, int b, int mix, uint32_t* __restrict__ out) {
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
cudaError_t launch_warp(const int* tokens, const int* lengths, int n, int l, int b, int mix,
                        uint32_t* out, cudaStream_t stream) {
  const long long row_bytes = 4LL * (b / 32);
  const int warps = static_cast<int>(
      row_bytes * kMaxWarps <= kSmemBytes ? kMaxWarps : kSmemBytes / row_bytes);
  if (warps >= 1) {
    const long long grid = (static_cast<long long>(n) + warps - 1) / warps;
    warp_kernel<kMethod, false>
        <<<static_cast<unsigned>(grid), 32 * warps, static_cast<size_t>(warps * row_bytes),
           stream>>>(tokens, lengths, n, l, b, mix, out);
  } else {
    const long long grid = (static_cast<long long>(n) + kMaxWarps - 1) / kMaxWarps;
    warp_kernel<kMethod, true><<<static_cast<unsigned>(grid), 32 * kMaxWarps, 0, stream>>>(
        tokens, lengths, n, l, b, mix, out);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- lane form

// A lane's kW words in registers; word k picked by an unrolled select.
template <int kW>
struct RegWords {
  uint32_t w[kW];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kW; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ uint32_t get(int k) const {
    uint32_t v = w[0];
#pragma unroll
    for (int i = 1; i < kW; ++i) v = k == i ? w[i] : v;
    return v;
  }
  __device__ __forceinline__ void put(int k, uint32_t v) {
#pragma unroll
    for (int i = 0; i < kW; ++i) w[i] = k == i ? v : w[i];
  }
  template <int kMethod>
  __device__ __forceinline__ void fold(int k, uint32_t m) {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const uint32_t mi = k == i ? m : 0u;
      w[i] = kMethod == kSet ? (w[i] | mi) : (w[i] ^ mi);
    }
  }
  // The lane's row of words, stored whole (16 or 8 bytes at a time where
  // the row's offset allows it: rows start at a multiple of kW words).
  __device__ __forceinline__ void store(uint32_t* row) const {
    if constexpr (kW % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kW; i += 4)
        *reinterpret_cast<uint4*>(row + i) = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    } else if constexpr (kW % 2 == 0) {
#pragma unroll
      for (int i = 0; i < kW; i += 2)
        *reinterpret_cast<uint2*>(row + i) = make_uint2(w[i], w[i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) row[i] = w[i];
    }
  }
};

// A lane's words in its warp's shared block: word k at p[k * kStride].
struct SmemWords {
  uint32_t* p;
  int w;
  __device__ __forceinline__ void zero() {
    for (int k = 0; k < w; ++k) p[k * kStride] = 0u;
  }
  __device__ __forceinline__ uint32_t get(int k) const { return p[k * kStride]; }
  __device__ __forceinline__ void put(int k, uint32_t v) { p[k * kStride] = v; }
  template <int kMethod>
  __device__ __forceinline__ void fold(int k, uint32_t m) {
    uint32_t* at = p + k * kStride;
    if constexpr (!kSmemAtomics) {
      *at = kMethod == kSet ? (*at | m) : (*at ^ m);
    } else if constexpr (kMethod == kSet) {
      atomicOr(at, m);
    } else {
      atomicXor(at, m);
    }
  }
};

// Next's summary of the words with a free bit (W <= 32): one register.
struct RegSummary {
  uint32_t nz;
  __device__ __forceinline__ void fill(int w) { nz = w >= 32 ? kFull : (1u << w) - 1u; }
  // The first word after wh, cyclically, with a free bit (wh itself last).
  __device__ __forceinline__ int next(int wh) const {
    const uint32_t above = wh >= 31 ? 0u : nz & (kFull << (wh + 1));
    return __ffs(above ? above : nz) - 1;
  }
  __device__ __forceinline__ void clear(int k) { nz &= ~(1u << k); }
};

// Next's probe on one lane's words: the first free bit at or cyclically
// after h, which the caller knows exists, is set.
template <class Words>
__device__ __forceinline__ void place(Words& bits, RegSummary& free_words, uint32_t h) {
  int k = static_cast<int>(h >> 5);
  uint32_t word = bits.get(k);
  uint32_t f = ~word & (kFull << (h & 31));
  if (!f) {
    k = free_words.next(k);
    word = bits.get(k);
    f = ~word;
  }
  word |= f & (0u - f);  // the lowest free bit
  bits.put(k, word);
  if (word == kFull) free_words.clear(k);
}

// kW > 0: W known at compile time (kReg: the words in registers); kW = 0:
// W = b / 32 at run time.  Words not in registers take [W][33] shared
// words a warp.
template <int kMethod, int kW, bool kReg>
__global__ void __launch_bounds__(32 * kLaneWarps)
    lane_kernel(const int* __restrict__ tokens, const int* __restrict__ lengths, int n_sets,
                int l, int b, int mix, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * 32;
  if (row0 >= n_sets) return;  // the whole warp
  const long long set = row0 + lane;
  const bool live = set < n_sets;
  const int w = kW > 0 ? kW : b >> 5;
  const uint32_t ub = kW > 0 ? 32u * kW : static_cast<uint32_t>(b);
  constexpr int kAhead = kReg ? kAheadReg : kAheadSmem;
  uint32_t* warp_smem = smem + warp * (kReg ? 0 : w * kStride);
  const int* row = tokens + (live ? set : row0) * l;

  using Words = std::conditional_t<kReg, RegWords<kReg ? kW : 1>, SmemWords>;
  Words bits;
  if constexpr (!kReg) bits = SmemWords{warp_smem + lane, w};
  bits.zero();
  RegSummary free_words;
  if (kMethod == kNext) free_words.fill(w);
  uint32_t filled = 0;  // Next: bits set so far
  int limit = 0;        // positions to read: the length (Next: none once full)
  // One valid token of the lane's row, in row order.
  auto step = [&](int token) {
    const uint32_t h = hash_position<kW * 32>(token, ub, mix);
    if constexpr (kMethod == kNext) {
      if (filled < ub) {  // a full bitmap ends the set
        place(bits, free_words, h);
        if (++filled == ub) limit = 0;
      }
    } else {
      bits.template fold<kMethod>(static_cast<int>(h >> 5), 1u << (h & 31));
    }
  };

  // tokens: a lane reads its row 16 bytes at a time, from the 16-byte
  // boundary at or below the row's start (any 4-byte aligned base: vector
  // j holds positions 4 j - off to 4 j + 3 - off), kAhead positions ahead
  // of the ones it hashes.  It reads a vector only if the vector holds a
  // position of its row below the length, so every byte it reads shares a
  // 16-byte block with a token of the row.  The first vectors (positions
  // below L) go out with the length, and are masked once it arrives.
  constexpr int kV = kAhead / 4;
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const int4* vec = reinterpret_cast<const int4*>(row - off);
  const int4 pad4 = make_int4(kPad, kPad, kPad, kPad);
  int4 t[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) t[v] = live && max(4 * v - off, 0) < l ? vec[v] : pad4;
  const int n = live ? min(max(lengths[set], 0), l) : 0;
  const int n_max =
      static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>((n + off + 3) >> 2)));
  limit = n;
  for (int j0 = 0; j0 < n_max; j0 += kV) {
    int4 ahead[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int j = j0 + kV + v;
      ahead[v] = max(4 * j - off, 0) < limit ? vec[j] : pad4;
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int p = 4 * (j0 + v) - off;
      const int e[4] = {t[v].x, t[v].y, t[v].z, t[v].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p + i >= 0 && p + i < n && e[i] != kPad) step(e[i]);
      t[v] = ahead[v];
    }
  }
  // tokens: end.

  if constexpr (kReg) {
    if (live) bits.store(out + set * kW);
  } else {
    __syncwarp();
    const long long rows = min(32LL, static_cast<long long>(n_sets) - row0);
    uint32_t* dst = out + row0 * w;
    for (int r = 0; r < rows; ++r)
      for (int k = lane; k < w; k += 32) dst[r * w + k] = warp_smem[k * kStride + r];
  }
}

template <int kMethod, int kW, bool kReg>
cudaError_t launch_lane_instance(const int* tokens, const int* lengths, int n, int l, int b,
                                 int mix, uint32_t* out, cudaStream_t stream) {
  // Every width's words fit a block's 48 KB: 4 warps x 32 words x 33 at most.
  static_assert(kLaneWarps * kLaneMaxWords * kStride * 4 <= kSmemBytes);
  const long long warp_bytes = kReg ? 0 : 4LL * (b >> 5) * kStride;
  const long long groups = (static_cast<long long>(n) + 31) / 32;
  const long long grid = (groups + kLaneWarps - 1) / kLaneWarps;
  lane_kernel<kMethod, kW, kReg><<<static_cast<unsigned>(grid), 32 * kLaneWarps,
                                   static_cast<size_t>(kLaneWarps * warp_bytes), stream>>>(
      tokens, lengths, n, l, b, mix, out);
  return cudaGetLastError();
}

template <int kMethod, int kW>
cudaError_t launch_reg(const int* tokens, const int* lengths, int n, int l, int b, int mix,
                       uint32_t* out, cudaStream_t stream) {
  if constexpr (kW > kRegWords) {
    return cudaErrorInvalidValue;
  } else {
    if ((b >> 5) == kW) {
      return launch_lane_instance<kMethod, kW, true>(tokens, lengths, n, l, b, mix, out,
                                                     stream);
    }
    return launch_reg<kMethod, kW + 1>(tokens, lengths, n, l, b, mix, out, stream);
  }
}

template <int kMethod>
cudaError_t launch_lane(const int* tokens, const int* lengths, int n, int l, int b, int mix,
                        uint32_t* out, cudaStream_t stream) {
  const int w = b >> 5;
  if (w > kLaneMaxWords) return cudaErrorInvalidValue;
  if (w <= kRegWords) return launch_reg<kMethod, 1>(tokens, lengths, n, l, b, mix, out, stream);
  if (w == 16)
    return launch_lane_instance<kMethod, 16, false>(tokens, lengths, n, l, b, mix, out, stream);
  if (w == 32)
    return launch_lane_instance<kMethod, 32, false>(tokens, lengths, n, l, b, mix, out, stream);
  return launch_lane_instance<kMethod, 0, false>(tokens, lengths, n, l, b, mix, out, stream);
}

template <int kMethod>
cudaError_t launch(const int* tokens, const int* lengths, int n, int l, int b, int mix,
                   int form, uint32_t* out, cudaStream_t stream) {
  if (form == kLaneForm) return launch_lane<kMethod>(tokens, lengths, n, l, b, mix, out, stream);
  if (form == kWarpForm) return launch_warp<kMethod>(tokens, lengths, n, l, b, mix, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace bitmap_build

// tokens int32[n, l] (PAD_TOKEN-padded rows, read in row order; any 4-byte
// aligned base), lengths int32[n], b a positive multiple of 32, method 0 /
// 1 / 2 (Set / Xor / Next), mix 0 or 1, form 0 (a warp a set, any b) or 1
// (a lane a set, b <= 32 * kLaneMaxWords); out uint32[n, b / 32].
extern "C" int bitmap_build_launch(const void* tokens, const void* lengths, int n, int l,
                                   int b, int method, int mix, int form, void* out,
                                   void* stream) {
  using namespace bitmap_build;
  if (n <= 0) return 0;
  if (b <= 0 || b % 32 != 0 || l < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tokens);
  const int* len = static_cast<const int*>(lengths);
  uint32_t* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case kSet: return static_cast<int>(launch<kSet>(t, len, n, l, b, mix, form, o, s));
    case kXor: return static_cast<int>(launch<kXor>(t, len, n, l, b, mix, form, o, s));
    case kNext: return static_cast<int>(launch<kNext>(t, len, n, l, b, mix, form, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
