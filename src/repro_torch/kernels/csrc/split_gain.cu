// Best split per (node, feature) from a grad/hess histogram, for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/split_gain.py::split_gain_pallas (kernel
// _split_gain_kernel).  For each row (node, feature) of the histogram
// (rows, nbins, 2), with GL/HL the prefix sums over bins up to s and
// G/H the totals:
//
//   gain(s) = 0.5 * (GL^2/(HL+l2) + GR^2/(HR+l2) - G^2/(H+l2)) - gamma,
//   GR = G - GL, HR = H - HL,
//
// legal where HL >= min_child_weight, HR >= min_child_weight and
// s < nbins - 1.  The result is the largest legal gain and its first bin
// (-inf and 0 where none is legal); a NaN gain counts as the largest and
// the first NaN wins, as jnp.max / jnp.argmax have it.
//
// Bit-exactness with the plain version (kernels/ref.py split_gain_ref,
// itself bit-equal to the JAX package's oracle on the CPU) is the
// contract, so the association of every sum is pinned and every
// operation is an explicitly rounded intrinsic (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn), which nvcc never contracts into a fused
// multiply-add.
//
// The prefix sums follow XLA:CPU's association for a cumsum
// (ref.blocked_prefix): level 0 is a sequential sum within each block of
// 16 bins; from the second block on, a bin's prefix is carry + local,
// where carry is the same blocked prefix one level up, over the block
// totals.  That association is what allows parallelism across bins
// without changing a bit: the lane that owns bin s recomputes its local
// sum from the row staged in shared memory, in the same order (at most
// 15 dependent adds); the block totals are the locals of each block's
// last bin, and the level above is built from them the same way; then
// each level, top down, adds its carry.  The adds are redundant, the bits
// those of the sequential scan.  A Kogge-Stone or warp-shuffle scan over
// bins would change the association and is not used.  The row totals G
// and H are the blocked prefix at the last bin, as in the plain version,
// not a tree reduction.
//
// The argmax is a warp reduction of (gain, bin) pairs under a rule that
// is a total order, so the butterfly's order does not matter: a NaN
// beats everything, a larger gain beats a smaller one, and on a tie (and
// between two NaNs) the smaller bin wins.  The chosen gain keeps its own
// bits.
//
// Layout: one warp per (node, feature) row, its nbins (g, h) pairs loaded
// coalesced into shared memory beside the scan levels ((nbins + levels) x
// 8 bytes), and up to 8 rows a block, as many as fit in 48 KB (one row,
// in up to 227 KB, above 3000 bins).  At the training shape (32 nodes x
// 28 features x 33 bins) that is 896 warps in 112 blocks, one wave on the
// 132 SMs.
//
// What bounds it on the H100: bytes, and at the training shape that
// bound is 0.07 us (236 KB read, 7 KB written) against ~0.45 M float
// operations.  No kernel of a few microseconds reaches it: a launch
// costs more than that.  So the design cuts the serial chain a row walks
// (from 2 x 33 bins to at most 15 + 2 adds and a 5-step reduction) and
// puts every row on its own warp, so that the kernel's time is the launch
// and one round of loads.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;       // XLA:CPU's cumsum block
constexpr int kMaxLevels = 4;    // 16^4 bins: more than kMaxBins
constexpr int kMaxBins = 8192;
constexpr int kRowsPerBlock = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// The scan levels of a row of n bins: level 0 has one entry a bin, and a
// level of more than 16 entries is followed by one of its block totals.
// Entries are (g, h) pairs, the levels stored one after the other.
struct Levels {
  int count;
  int len[kMaxLevels];
  int off[kMaxLevels];
  int total;
};

Levels levels_of(int n) {
  Levels lv{};
  int off = 0;
  for (;;) {
    lv.len[lv.count] = n;
    lv.off[lv.count] = off;
    ++lv.count;
    off += n;
    if (n <= kBlock) break;
    n = (n + kBlock - 1) / kBlock;
  }
  lv.total = off;
  return lv;
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float score(float g, float h, float l2) {
  return __fdiv_rn(__fmul_rn(g, g), __fadd_rn(h, l2));
}

// (a, sa) ranks above (b, sb): NaN first, then the larger gain, then the
// smaller bin.  A total order on distinct bins.
__device__ __forceinline__ bool better(float a, int sa, float b, int sb) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || sa < sb);
  return a > b || (a == b && sa < sb);
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
split_gain_kernel(const float2* __restrict__ hist, float* __restrict__ gains,
                  int* __restrict__ idx, int64_t rows, int nbins,
                  Levels lv, int rows_per_block, float l2, float gamma,
                  float min_child_weight) {
  extern __shared__ float2 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * rows_per_block + warp;
  if (r >= rows) return;  // the whole warp: the shuffles below need all 32
  float2* x = smem + static_cast<int64_t>(warp) * (nbins + lv.total);
  float2* scan = x + nbins;
  const float2* row = hist + r * nbins;
  for (int s = lane; s < nbins; s += 32) x[s] = row[s];
  __syncwarp();

  // bottom up: each level's local prefix within blocks of 16, each entry
  // summed by its own lane in the sequential order
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= lv.count) break;
    float2* dst = scan + lv.off[l];
    const float2* below = l == 0 ? x : scan + lv.off[l > 0 ? l - 1 : 0];
    const int below_len = l == 0 ? 0 : lv.len[l > 0 ? l - 1 : 0];
    for (int i = lane; i < lv.len[l]; i += 32) {
      // entry k of this level's input: bin k, or block k's total (the
      // local prefix at its last entry) one level down
      auto in = [&](int k) {
        return l == 0 ? below[k] : below[min(k * kBlock + kBlock - 1,
                                             below_len - 1)];
      };
      const int b0 = i & ~(kBlock - 1);
      float2 v = in(b0);
      for (int k = b0 + 1; k <= i; ++k) v = add2(v, in(k));
      dst[i] = v;
    }
    __syncwarp();
  }
  // top down: from the second block on, carry (the prefix one level up
  // at the previous block) + local; the top level is its own prefix
#pragma unroll
  for (int l = kMaxLevels - 2; l >= 1; --l) {
    if (l + 1 >= lv.count) continue;
    float2* dst = scan + lv.off[l];
    const float2* up = scan + lv.off[l + 1];
    for (int i = lane + kBlock; i < lv.len[l]; i += 32) {
      dst[i] = add2(up[i / kBlock - 1], dst[i]);
    }
    __syncwarp();
  }
  const float2* up = scan + lv.off[lv.count > 1 ? 1 : 0];
  auto prefix = [&](int s) {
    return s < kBlock ? scan[s] : add2(up[s / kBlock - 1], scan[s]);
  };

  const float2 total = prefix(nbins - 1);
  const float st = score(total.x, total.y, l2);
  float best = -INFINITY;
  int best_s = INT_MAX;
  for (int s = lane; s < nbins; s += 32) {
    float gain = -INFINITY;
    if (s < nbins - 1) {
      const float2 left = prefix(s);
      const float gr = __fsub_rn(total.x, left.x);
      const float hr = __fsub_rn(total.y, left.y);
      if (left.y >= min_child_weight && hr >= min_child_weight) {
        const float inner = __fsub_rn(
            __fadd_rn(score(left.x, left.y, l2), score(gr, hr, l2)), st);
        gain = __fsub_rn(__fmul_rn(0.5f, inner), gamma);
      }
    }
    if (better(gain, s, best, best_s)) {
      best = gain;
      best_s = s;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, best, o);
    const int other_s = __shfl_xor_sync(0xffffffffu, best_s, o);
    if (better(other, other_s, best, best_s)) {
      best = other;
      best_s = other_s;
    }
  }
  if (lane == 0) {
    gains[r] = best;
    idx[r] = best_s;
  }
}

}  // namespace

// hist (rows, nbins, 2) float32 (8-byte aligned), gains (rows,) float32,
// idx (rows,) int32; all contiguous on the current device; 1 <= nbins <=
// kMaxBins.  Returns the cudaError_t of the launch (0 on success).
extern "C" int split_gain(const void* hist, void* gains, void* idx,
                          int64_t rows, int nbins, float l2, float gamma,
                          float min_child_weight, void* stream) {
  if (rows <= 0 || nbins <= 0 || nbins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels lv = levels_of(nbins);
  const size_t row_bytes = sizeof(float2) * (nbins + lv.total);
  int per_block = static_cast<int>(kDefaultSmem / row_bytes);
  per_block = per_block < 1 ? 1 : per_block > kRowsPerBlock ? kRowsPerBlock
                                                             : per_block;
  const size_t smem = row_bytes * per_block;
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_gain_kernel<<<static_cast<unsigned>(blocks), 32 * per_block, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(hist), static_cast<float*>(gains),
      static_cast<int*>(idx), rows, nbins, lv, per_block, l2, gamma,
      min_child_weight);
  return static_cast<int>(cudaGetLastError());
}
