// Level-batched gradient/hessian histogram, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/hist.py::hist_levels_pallas (kernel
// _hist_levels_kernel) and its subtraction child mode
// hist_levels_left_pallas.  The TPU kernel builds a one-hot matrix per
// row tile and contracts it with the (rows, 2) grad/hess panel on the
// matrix unit, because the TPU has no atomics.  Nothing of that is
// carried over: the GPU scatters with atomics into shared memory.
//
//   out[level, node, feature, bin, :] += gh[row, :]
//       for every row with node_per_level[level, row] == node
//       and bins[row, feature] == bin.
//
// Child mode (child != 0): node_per_level holds CHILD frontier ids; a row
// with an odd (routed right) or negative id is skipped before any atomic,
// an even id adds into parent bucket id >> 1.  Direct mode skips negative
// (masked) ids.  A node id >= n_nodes or a bin id outside [0, nbins) is
// dropped, never written out of bounds.  Child mode also counts the rows
// of each bucket (integer atomics: exact in any order); subtraction growth
// uses the counts to keep an empty bucket exactly zero, where parent - left
// of the same rows added in two different orders would leave a rounding
// residue.
//
// What bounds it on the H100: bytes.  At the training shape (n = 1M rows,
// f = 28 features, one level) the kernel must read 112 MB of bin ids,
// 4 MB of node ids and 8 MB of grad/hess and write a 236 KB panel: ~37 us
// at 3.35 TB/s, against 56 M float adds (~0.8 us at 67 TFLOP/s).
//
// The design.  The panel at that shape (32 nodes x 28 features x 33 bins x
// 2 x 4 B = 236 KB) does not fit one block's 227 KB of shared memory, so a
// block owns a tile of features (and, where one feature's n_nodes x nbins
// panel is still too large, a chunk of nodes, as the Pallas node_chunk
// does) for one level, zeroes that panel in shared memory, walks a range
// of rows, and flushes the panel into the output with global atomicAdd
// (the wrapper zeroes the output).  Within a block the flat index runs
// (row, feature-in-tile) with the feature fastest, so a warp reads
// contiguous bin ids of a few rows and its shared-memory atomics mostly
// land on distinct features, which keeps bank and address conflicts low
// even at the root, where every row is in node 0.  Zero panel entries are
// not flushed (adding 0 leaves the output as it is).  The order of the
// float adds changes from run to run; sums of integer-valued g/h below
// 2^24 are exact in any order.  TMA, warp-level pre-aggregation and
// tuning are later work.

#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPanelBytes = 96 * 1024;  // shared-memory panel of one block
constexpr int kBlocksPerSm = 2;          // two 96 KB panels fit an SM
constexpr int kMinRowsPerBlock = 1024;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ bins, const int* __restrict__ node,
            const float2* __restrict__ gh, float* __restrict__ out,
            int* __restrict__ counts, int64_t n, int f, int n_nodes,
            int nbins, int f_tile, int node_chunk, int n_chunks, int child,
            int rows_per_block) {
  // [nc][ft][nbins][2] sums, then (child mode) [nc][ft][nbins] row counts
  extern __shared__ float panel[];
  const int f0 = blockIdx.y * f_tile;
  const int ft = f - f0 < f_tile ? f - f0 : f_tile;
  const int level = blockIdx.z / n_chunks;
  const int base = (blockIdx.z % n_chunks) * node_chunk;
  const int nc = n_nodes - base < node_chunk ? n_nodes - base : node_chunk;
  const int panel_len = nc * ft * nbins * 2;
  int* cpanel = reinterpret_cast<int*>(panel + panel_len);
  const int cpanel_len = child ? nc * ft * nbins : 0;
  for (int i = threadIdx.x; i < panel_len; i += blockDim.x) panel[i] = 0.f;
  for (int i = threadIdx.x; i < cpanel_len; i += blockDim.x) cpanel[i] = 0;
  __syncthreads();

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = n - r0 < rows_per_block ? static_cast<int>(n - r0)
                                            : rows_per_block;
  const int* lvl_node = node + level * n;
  const int count = rows * ft;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e / ft;
    const int j = e - r * ft;
    const int64_t row = r0 + r;
    int id = lvl_node[row];
    if (id < 0) continue;
    if (child) {
      if (id & 1) continue;  // routed right: its sibling is parent - left
      id >>= 1;
    }
    const int local = id - base;
    if (local < 0 || local >= nc) continue;  // another chunk, or >= n_nodes
    const int b = bins[row * f + f0 + j];
    if (b < 0 || b >= nbins) continue;
    const float2 v = gh[row];
    const int bucket = (local * ft + j) * nbins + b;
    atomicAdd(panel + 2 * bucket, v.x);
    atomicAdd(panel + 2 * bucket + 1, v.y);
    if (child) atomicAdd(cpanel + bucket, 1);
  }
  __syncthreads();

  // local bucket (node, feature-in-tile, bin) -> its index in the output
  auto out_bucket = [&](int bucket) {
    const int b = bucket % nbins;
    const int lj = bucket / nbins;
    const int j = lj % ft;
    const int local = lj / ft;
    return ((static_cast<int64_t>(level) * n_nodes + base + local) * f + f0 +
            j) * nbins + b;
  };
  for (int i = threadIdx.x; i < panel_len; i += blockDim.x) {
    const float v = panel[i];
    if (v != 0.f) atomicAdd(out + 2 * out_bucket(i >> 1) + (i & 1), v);
  }
  for (int i = threadIdx.x; i < cpanel_len; i += blockDim.x) {
    const int c = cpanel[i];
    if (c != 0) atomicAdd(counts + out_bucket(i), c);
  }
}

}  // namespace

// Bytes of the shared-memory panel of one block: one feature of one node
// (nbins x 2 floats, and in child mode nbins ints of counts) must fit, so
// nbins <= hist_panel_bytes() / 12 in child mode, / 8 in direct mode.
extern "C" int hist_panel_bytes() { return kPanelBytes; }

// bins (n, f) int32, node_per_level (n_levels, n) int32, gh (n, 2) float32
// (8-byte aligned), out (n_levels, n_nodes, f, nbins, 2) float32 and, in
// child mode, counts (n_levels, n_nodes, f, nbins) int32 (ignored in
// direct mode), both ZEROED by the caller; all contiguous on the current
// device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int hist_levels(const void* bins, const void* node_per_level,
                           const void* gh, void* out, void* counts, int64_t n,
                           int f, int n_levels, int n_nodes, int nbins,
                           int child, void* stream) {
  const int per_node_feature =
      nbins * static_cast<int>(2 * sizeof(float) + (child ? sizeof(int) : 0));
  if (n <= 0 || f <= 0 || n_levels <= 0 || n_nodes <= 0 || nbins <= 0 ||
      per_node_feature > kPanelBytes || (child && counts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // tile features (whole frontier per block) or, where one feature's
  // frontier panel is too large, chunk nodes one feature at a time
  int f_tile = 1, node_chunk = n_nodes;
  if (static_cast<int64_t>(n_nodes) * per_node_feature <= kPanelBytes) {
    f_tile = std::min(f, kPanelBytes / (n_nodes * per_node_feature));
  } else {
    node_chunk = kPanelBytes / per_node_feature;
  }
  const int f_tiles = (f + f_tile - 1) / f_tile;
  f_tile = (f + f_tiles - 1) / f_tiles;                 // balance the tiles
  const int n_chunks = (n_nodes + node_chunk - 1) / node_chunk;
  node_chunk = (n_nodes + n_chunks - 1) / n_chunks;
  const int64_t z = static_cast<int64_t>(n_levels) * n_chunks;
  if (f_tiles > 65535 || z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t per_row_block = static_cast<int64_t>(f_tiles) * z;
  int64_t gx = (int64_t{kBlocksPerSm} * sms + per_row_block - 1) /
               per_row_block;
  gx = std::max(int64_t{1},
                std::min(gx, (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock));
  // the in-block flat index (row, feature) is 32-bit
  const int64_t rows_per_block =
      std::min((n + gx - 1) / gx, (int64_t{1} << 30) / f_tile);
  gx = (n + rows_per_block - 1) / rows_per_block;
  if (gx > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const int smem = node_chunk * f_tile * per_node_feature;
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPanelBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(f_tiles),
                  static_cast<unsigned>(z));
  hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bins), static_cast<const int*>(node_per_level),
      static_cast<const float2*>(gh), static_cast<float*>(out),
      static_cast<int*>(counts), n, f, n_nodes, nbins, f_tile, node_chunk,
      n_chunks, child, static_cast<int>(rows_per_block));
  return static_cast<int>(cudaGetLastError());
}
