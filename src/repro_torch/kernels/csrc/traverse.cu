// Forest traversal for Hopper (sm_90a), in two forms.
//
// Both replace src/repro/kernels/traverse.py::traverse_chunk_pallas
// (kernel _traverse_kernel).  The TPU kernel turns every gather into a
// masked-select sum because its vector unit has no gathers; the GPU
// gathers directly, so nothing of the masked select is carried over.
//
// The descent rule, shared by both forms.  A (row, tree) pair walks
// max_depth levels of its tree:
//     h    = 2^depth - 1 + node               (heap index)
//     fi   = max(feature[t, h], 0)            (-1 passthrough reads feature 0)
//     v    = fi < f ? values[row, fi] : NaN / INT_MIN
//     node = 2 * node + !(v <= cmp[t, h])
// and lands on leaf[t, node].  An id past the last feature reads nothing
// outside the row: it gets the value a JAX gather fills out of bounds
// (NaN for floats, the most negative int for ints), so even a malformed
// forest routes as in the reference.  The split rule is `value <= cmp`,
// so a NaN value compares false and routes RIGHT, exactly as the
// reference does; the build must not use --use_fast_math, which may
// rewrite that comparison.
//
// 1. traverse_{f32,i32}: the per-tree form, the counterpart of
//    ops.traverse_chunk.  One thread per (row, tree) of a chunk of C
//    trees writes leaf[t, node] to out[row, t] (n, C); the caller sums.
//    The flat thread index runs tree fastest, so a warp covers one or two
//    rows, its value gathers fall in the same few cache lines, and the
//    output store is contiguous.  Node records are read from global
//    memory (L1/L2), so no depth or chunk size is refused.  At the
//    serving chunk (4096 rows x 32 features, C = 25 trees of depth 6) it
//    moves ~0.95 MB (0.28 us at 3.35 TB/s) and is launch-bound.
//
// 2. forest_sum_{f32,i32}: the forest-sum form, the serving path.  It
//    takes the whole stacked forest and returns, per row,
//        base + scale * (((0 + leaf_0) + leaf_1) + ... + leaf_{T-1})
//    as __fmul_rn then __fadd_rn: the same float32 adds in the same tree
//    order as the JAX engine (src/repro/core/predict.py, the chunk scan),
//    so margins are bit-identical, raw and binned, NaN rows included.
//    The accumulator starts at +0.0 and the first leaf is added onto it:
//    0 + (-0) is +0, as the JAX sum has it, and the sum is never -0.
//    So the JAX engine's padding trees (exact zeros) change no bit, and
//    this kernel loops over the forest's own T trees.  With base 0 and
//    scale 1 it is the plain sum (1 * s = s, 0 + s = s for s != -0).
//
//    Design.  A block owns a tile of 32 rows, one a lane, and stages
//    their values in shared memory feature-major ([feature][row]: a
//    warp's gathers hit 32 distinct banks whatever features its rows
//    read), with one more "feature" holding the fill that an id past the
//    last feature reads, so the gather needs no branch.  The forest
//    (~380 KB at 500 trees of depth 6: node records 8 bytes, leaves 4)
//    does not fit there, so it streams through in groups of up to 128
//    trees, double-buffered: the next group's feature, cmp and leaf
//    arrays land by bulk copy (the TMA's linear mode, completing on an
//    mbarrier; the few words before and after the 16-byte aligned body
//    by cp.async) while the current group is walked.  Eight warps walk:
//    each takes 16 trees of the group for its 32 rows, the 16 descents
//    interleaved with no branch between them, so that shared-memory
//    latency hides behind independent loads (a warp's lanes read one
//    tree, whose nodes at a level of depth <= 5 lie in distinct banks),
//    and writes the leaf values into a shared (trees x rows) buffer.  A
//    ninth warp issues the copies and, after the barrier that closes a
//    group, adds that group's buffer in tree order onto the rows' running
//    sums (16 loads in flight, then the adds) while the others walk the
//    next group.  The output is written once: 4 bytes a row, where the
//    per-tree form wrote 4 x C a row per chunk.  Groups shrink (128, 64,
//    ..., 1 trees) where a deep tree's stage would not fit twice in the
//    block's shared memory; values wider than 511 features are read from
//    global memory instead of staged.  Depths above 13 do not fit and
//    are refused.
//
//    What bounds it on the H100: bytes.  At the serving shape (4096 rows
//    x 32 features, 500 trees of depth 6) it reads 512 KiB of values and
//    ~380 KB of forest and writes 16 KiB: ~0.92 MB, 0.27 us at 3.35 TB/s,
//    against 12.3 M compares (0.18 us at 67 TFLOP/s).  Neither is within
//    reach.  A block walks its groups one after the other, and each
//    level of each descent is two dependent shared-memory loads (node,
//    then value) and ~15 instructions: ~3000 warp-levels a block, ~45 K
//    warp instructions, ~6 us at one instruction a cycle on each of the
//    SM's four schedulers.  Every block also reads the whole forest from
//    L2 (128 blocks, ~49 MB a launch).  The gain over the per-tree form
//    is the request: one launch in place of 20 launches and 500 adds.
//    Row and tree offsets are computed in 64 bits.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T out_of_range();
template <>
__device__ __forceinline__ float out_of_range<float>() {
  return __int_as_float(0x7fc00000);  // NaN
}
template <>
__device__ __forceinline__ int out_of_range<int>() {
  return INT_MIN;
}

template <typename T>
__global__ void traverse_kernel(const T* __restrict__ values,
                                const int* __restrict__ feature,
                                const T* __restrict__ cmp,
                                const float* __restrict__ leaf,
                                float* __restrict__ out,
                                int64_t n, int f, int C, int max_depth) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * C) return;
  const int64_t row = i / C;
  const int t = static_cast<int>(i - row * C);
  const int64_t n_inner = (int64_t{1} << max_depth) - 1;
  const T* x = values + row * f;
  const int* fe = feature + t * n_inner;
  const T* cm = cmp + t * n_inner;
  int node = 0;
  for (int depth = 0; depth < max_depth; ++depth) {
    const int h = (1 << depth) - 1 + node;
    const int fi = max(fe[h], 0);
    const T v = fi < f ? x[fi] : out_of_range<T>();
    node = 2 * node + (v <= cm[h] ? 0 : 1);
  }
  out[i] = leaf[t * (n_inner + 1) + node];
}

template <typename T>
int launch(const void* values, const void* feature, const void* cmp,
           const void* leaf, void* out, int n, int f, int C, int max_depth,
           void* stream) {
  const int64_t total = static_cast<int64_t>(n) * C;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  traverse_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int*>(feature),
      static_cast<const T*>(cmp), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, f, C, max_depth);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The forest-sum form.

constexpr int kRows = 32;             // rows of a block: one a lane
constexpr int kWalkWarps = 8;         // warps that walk trees
constexpr int kThreadsSum = (kWalkWarps + 1) * 32;  // and one that sums
constexpr int kMaxGroup = 128;        // trees staged at a time
constexpr int kInterleave = 16;       // descents a warp interleaves
constexpr int kSumBatch = 16;         // leaf values a sum loads at once
constexpr int kMaxSumDepth = 13;      // two stages of one tree still fit
constexpr size_t kStagedValueBytes = 64 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // a block's shared memory on the H100

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) & ~size_t{15};
}

// A block's shared memory, as byte offsets: two forest stages, each the
// feature | cmp | leaf arrays of `group` trees (16 bytes of slack a region,
// so that a copy starts at its source's offset within 16 bytes); then two
// (group x 32) leaf-value buffers, the 32 running sums, the two stages'
// mbarriers and, when staged, the values ((f + 1) x 32, feature-major,
// feature f the fill that an id past the last feature reads).
struct SumLayout {
  size_t cmp, leaf, stage, lbuf, acc, bar, xs, total;
};

__host__ __device__ inline SumLayout sum_layout(int f, int n_inner, int group,
                                                bool staged, size_t elem) {
  SumLayout lay;
  const size_t nodes = static_cast<size_t>(group) * n_inner;
  lay.cmp = round16(4 * nodes + 16);
  lay.leaf = lay.cmp + round16(4 * nodes + 16);
  lay.stage = lay.leaf + round16(4 * (nodes + group) + 16);
  lay.lbuf = 2 * lay.stage;
  lay.acc = lay.lbuf + 2 * 4 * static_cast<size_t>(group) * kRows;
  lay.bar = lay.acc + 4 * kRows;
  lay.xs = lay.bar + 16;
  lay.total = lay.xs + (staged ? round16(elem * (f + 1) * kRows) : 0);
  return lay;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
}

// The one arrival of a stage's phase, announcing the bytes its bulk
// copies will complete.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(phase) : "memory");
}

// A bulk copy (the TMA's linear mode): 16-byte aligned, a multiple of 16
// bytes, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// Where the copy of `src` starts in a 16-byte aligned shared region: at
// src's own offset within 16 bytes, so that its body is one bulk copy.
template <typename W>
__device__ __forceinline__ W* staged_at(unsigned char* region, const W* src) {
  return reinterpret_cast<W*>(region +
                              (reinterpret_cast<uintptr_t>(src) & 15));
}

// Of `count` 4-byte words at `src`: those before its first 16-byte line.
template <typename W>
__device__ __forceinline__ int64_t head_words(const W* src, int64_t count) {
  const int64_t to_line = (4 - (reinterpret_cast<uintptr_t>(src) & 15) / 4) & 3;
  return count < to_line ? count : to_line;
}

// The bytes of their 16-byte aligned body.
template <typename W>
__device__ __forceinline__ unsigned body_bytes(const W* src, int64_t count) {
  return static_cast<unsigned>(16 * ((count - head_words(src, count)) / 4));
}

// `count` 4-byte words from global `src` to staged_at(region, src), issued
// by one warp: the 16-byte aligned body as one bulk copy on `bar` (by lane
// 0), the words before and after it by cp.async.
template <typename W>
__device__ void stage_words(unsigned char* region, const W* src,
                            int64_t count, uint64_t* bar, int lane) {
  W* dst = staged_at(region, src);
  const int64_t head = head_words(src, count);
  const int64_t body = (count - head) / 4;  // 16-byte lines
  const int64_t edges = count - 4 * body;   // head and tail words
  if (lane < edges) {
    const int64_t k = lane < head ? lane : 4 * body + lane;
    cp_async4(dst + k, src + k);
  }
  if (lane == 0 && body > 0) {
    bulk_copy(dst + head, src + head, static_cast<unsigned>(16 * body), bar);
  }
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreadsSum)
forest_sum_kernel(const T* __restrict__ values,
                  const int* __restrict__ feature,
                  const T* __restrict__ cmp, const float* __restrict__ leaf,
                  float* __restrict__ out, int64_t n, int f, int n_trees,
                  int max_depth, int group, float base, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_inner = (1 << max_depth) - 1;
  const SumLayout lay = sum_layout(f, n_inner, group, kStaged, sizeof(T));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int groups = (n_trees + group - 1) / group;
  float* lbuf = reinterpret_cast<float*>(smem + lay.lbuf);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  T* xs = reinterpret_cast<T*>(smem + lay.xs);

  // the trees of group g: their first index and how many
  auto first = [&](int g) { return static_cast<int64_t>(g) * group; };
  auto size = [&](int g) {
    const int64_t left = n_trees - first(g);
    return static_cast<int>(left < group ? left : group);
  };
  // group g's arrays into its stage: by the summing warp, so that no
  // walking warp waits on the issue
  auto stage = [&](int g) {
    unsigned char* s = smem + (g & 1) * lay.stage;
    uint64_t* b = &bar[g & 1];
    const int64_t t0 = first(g);
    const int64_t nodes = static_cast<int64_t>(size(g)) * n_inner;
    const int* fe = feature + t0 * n_inner;
    const T* cm = cmp + t0 * n_inner;
    const float* lf = leaf + t0 * (n_inner + 1);
    if (lane == 0) {  // the phase's one arrival, before any byte lands
      bar_expect(b, body_bytes(fe, nodes) + body_bytes(cm, nodes) +
                        body_bytes(lf, nodes + size(g)));
    }
    stage_words(s, fe, nodes, b, lane);
    stage_words(s + lay.cmp, cm, nodes, b, lane);
    stage_words(s + lay.leaf, lf, nodes + size(g), b, lane);
  };

  if (threadIdx.x == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (groups > 0 && warp == kWalkWarps) stage(0);
  if (kStaged) {  // and the fill of a feature past the last, as feature f
    for (int i = threadIdx.x; i < (f + 1) * kRows; i += blockDim.x) {
      const int64_t row = row0 + i % kRows;
      xs[i] = i >= f * kRows ? out_of_range<T>()
              : row < n    ? values[row * f + i / kRows]
                           : T(0);
    }
  }
  if (threadIdx.x < kRows) acc[threadIdx.x] = 0.0f;
  const int64_t my_row = row0 + lane < n ? row0 + lane : n - 1;

  for (int g = 0; g <= groups; ++g) {
    cp_async_wait_all();
    if (g < groups) bar_wait(&bar[g & 1], (g >> 1) & 1);
    __syncthreads();  // group g staged; group g - 1 walked; stage g + 1 free
    if (warp == kWalkWarps) {
      // the summing warp: stages group g + 1, then adds group g - 1's
      // leaf values onto the running sums, in tree order, while the
      // others walk group g
      if (g + 1 < groups) stage(g + 1);
      if (g == 0) continue;
      const float* vals = lbuf + ((g - 1) & 1) * group * kRows;
      float a = acc[lane];
      const int gs = size(g - 1);
      int t = 0;
      for (; t + kSumBatch <= gs; t += kSumBatch) {  // loads in flight together
        float v[kSumBatch];
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j) v[j] = vals[(t + j) * kRows + lane];
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j) a = __fadd_rn(a, v[j]);
      }
      for (; t < gs; ++t) a = __fadd_rn(a, vals[t * kRows + lane]);
      acc[lane] = a;
      if (g == groups && row0 + lane < n) {
        out[row0 + lane] = __fadd_rn(base, __fmul_rn(scale, a));
      }
      continue;
    }
    if (g == groups) continue;
    unsigned char* s = smem + (g & 1) * lay.stage;
    const int64_t t0 = first(g);
    const int* fe = staged_at(s, feature + t0 * n_inner);
    const T* cm = staged_at(s + lay.cmp, cmp + t0 * n_inner);
    const float* lf = staged_at(s + lay.leaf, leaf + t0 * (n_inner + 1));
    float* dst = lbuf + (g & 1) * group * kRows;
    const int gs = size(g);
    for (int tb = warp; tb < gs; tb += kInterleave * kWalkWarps) {
      // kInterleave independent descents with no branch between them: a
      // tree past the group's end repeats its last tree, unwritten
      int h[kInterleave], base_k[kInterleave];
#pragma unroll
      for (int j = 0; j < kInterleave; ++j) {
        const int t = tb + j * kWalkWarps;
        base_k[j] = (t < gs ? t : gs - 1) * n_inner;
        h[j] = 0;
      }
      for (int d = 0; d < max_depth; ++d) {
#pragma unroll
        for (int j = 0; j < kInterleave; ++j) {
          const int k = base_k[j] + h[j];
          const int fi = max(fe[k], 0);
          T v;
          if constexpr (kStaged) {
            v = xs[(fi < f ? fi : f) * kRows + lane];
          } else {
            v = values[my_row * f + (fi < f ? fi : f - 1)];
            v = fi < f ? v : out_of_range<T>();
          }
          h[j] = 2 * h[j] + (v <= cm[k] ? 1 : 2);
        }
      }
#pragma unroll
      for (int j = 0; j < kInterleave; ++j) {
        const int t = tb + j * kWalkWarps;
        if (t < gs) {
          dst[t * kRows + lane] = lf[t * (n_inner + 1) + h[j] - n_inner];
        }
      }
    }
  }
  if (groups == 0 && warp == 0 && row0 + lane < n) {
    out[row0 + lane] = __fadd_rn(base, __fmul_rn(scale, 0.0f));
  }
}

template <typename T, bool kStaged>
int launch_sum_with(const void* values, const void* feature, const void* cmp,
                    const void* leaf, void* out, int64_t n, int f,
                    int n_trees, int max_depth, int group, size_t smem,
                    float base, float scale, void* stream) {
  auto kernel = forest_sum_kernel<T, kStaged>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(blocks), kThreadsSum, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int*>(feature),
      static_cast<const T*>(cmp), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, f, n_trees, max_depth, group, base, scale);
  return static_cast<int>(cudaGetLastError());
}

// The largest group of trees whose two stages fit beside the rest, values
// staged where they fit in 64 KB.
template <typename T>
int launch_sum(const void* values, const void* feature, const void* cmp,
               const void* leaf, void* out, int64_t n, int f, int n_trees,
               int max_depth, float base, float scale, void* stream) {
  if (n <= 0 || f < 0 || n_trees < 0 || max_depth < 0 ||
      max_depth > kMaxSumDepth || (n + kRows - 1) / kRows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_inner = (1 << max_depth) - 1;
  const bool can_stage = sizeof(T) * (f + 1) * kRows <= kStagedValueBytes;
  for (int staged = can_stage ? 1 : 0; staged >= 0; --staged) {
    for (int group = kMaxGroup; group >= 1; group /= 2) {
      const size_t smem =
          sum_layout(f, n_inner, group, staged, sizeof(T)).total;
      if (smem > kMaxSmem) continue;
      auto launch_one = staged ? launch_sum_with<T, true>
                               : launch_sum_with<T, false>;
      return launch_one(values, feature, cmp, leaf, out, n, f, n_trees,
                        max_depth, group, smem, base, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// values (n, f), feature (C, 2^d - 1) int32, cmp (C, 2^d - 1) of the
// values' type, leaf (C, 2^d) float32, out (n, C) float32; all contiguous
// on one device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int traverse_f32(const void* values, const void* feature,
                            const void* cmp, const void* leaf, void* out,
                            int n, int f, int C, int max_depth, void* stream) {
  return launch<float>(values, feature, cmp, leaf, out, n, f, C, max_depth,
                       stream);
}

extern "C" int traverse_i32(const void* values, const void* feature,
                            const void* cmp, const void* leaf, void* out,
                            int n, int f, int C, int max_depth, void* stream) {
  return launch<int>(values, feature, cmp, leaf, out, n, f, C, max_depth,
                     stream);
}

// values (n, f), feature (T, 2^d - 1) int32, cmp (T, 2^d - 1) of the
// values' type, leaf (T, 2^d) float32, out (n,) float32; all contiguous on
// one device; n >= 1, 0 <= d <= 13.  out = base + scale * (tree-order sum
// of each row's leaf values).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int forest_sum_f32(const void* values, const void* feature,
                              const void* cmp, const void* leaf, void* out,
                              int64_t n, int f, int n_trees, int max_depth,
                              float base, float scale, void* stream) {
  return launch_sum<float>(values, feature, cmp, leaf, out, n, f, n_trees,
                           max_depth, base, scale, stream);
}

extern "C" int forest_sum_i32(const void* values, const void* feature,
                              const void* cmp, const void* leaf, void* out,
                              int64_t n, int f, int n_trees, int max_depth,
                              float base, float scale, void* stream) {
  return launch_sum<int>(values, feature, cmp, leaf, out, n, f, n_trees,
                         max_depth, base, scale, stream);
}
