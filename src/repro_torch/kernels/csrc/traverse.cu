// Level-synchronous descent of a chunk of stacked trees, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/traverse.py::traverse_chunk_pallas (kernel
// _traverse_kernel).  The TPU kernel turns every gather into a
// masked-select sum because its vector unit has no gathers; the GPU
// gathers directly, so nothing of the masked select is carried over.
//
// One thread per (row, tree).  The thread walks max_depth levels of its
// tree:
//     h    = 2^depth - 1 + node
//     fi   = max(feature[t, h], 0)          (-1 passthrough reads feature 0)
//     v    = fi < f ? values[row, fi] : NaN / INT_MIN
//     node = 2 * node + !(v <= cmp[t, h])
// and writes leaf[t, node] to out[row, t].  An id past the last feature
// reads nothing outside the row: it gets the value a JAX gather fills out
// of bounds (NaN for floats, the most negative int for ints), so even a
// malformed forest routes as in the reference.  The split rule is
// `value <= cmp`, so a NaN value compares false and routes RIGHT, exactly
// as the reference does; the build must not use --use_fast_math, which
// may rewrite that comparison.
//
// What bounds it on the H100: bytes.  At the serving shape (4096 rows x 32
// features, C = 25 trees of depth 6) one launch reads 512 KiB of values
// and ~19 KB of node records and writes 400 KiB: ~0.95 MB, ~0.28 us at
// 3.35 TB/s, while the compares are ~0.6 M operations.  At that size the
// launch overhead dominates.  The design: the flat thread index runs tree
// fastest, so a warp covers one or two rows, its value gathers fall in
// the same few cache lines, and the output store is contiguous.  The node
// records of a chunk (~19 KB) are read from global memory and stay in
// L1/L2; staging them in shared memory is later work.  Reading from global
// memory also means no depth or chunk size is refused for want of shared
// memory.  Row and tree offsets are computed in 64 bits.

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
