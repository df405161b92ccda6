// Level-batched gradient/hessian histogram, for Hopper (sm_90a), summed in
// fixed point so that every launch on the same inputs gives the same bits.
//
// Replaces src/repro/kernels/hist.py::hist_levels_pallas (kernel
// _hist_levels_kernel) and its subtraction child mode
// hist_levels_left_pallas.  The TPU kernel builds a one-hot matrix per
// row tile and contracts it with the (rows, 2) grad/hess panel on the
// matrix unit, because the TPU has no atomics.  Nothing of that is
// carried over: the GPU scatters with integer atomics.
//
//   out[level, node, feature, bin, :] += gh[row, :]
//       for every row with node_per_level[level, row] == node
//       and bins[row, feature] == bin.
//
// Child mode (child != 0): node_per_level holds CHILD frontier ids; a row
// with an odd (routed right) or negative id is skipped before any bin is
// read, an even id adds into parent bucket id >> 1.  Direct mode skips
// negative (masked) ids.  A node id >= n_nodes or a bin id outside
// [0, nbins) is dropped, never written out of bounds.  Child mode also
// counts the rows of each bucket; subtraction growth uses the counts to
// keep an empty bucket exactly zero.
//
// The arithmetic (kernels/ref.py hist_levels_fixed is the same on the
// CPU, and the kernel equals it bit for bit).  For each launch and each
// of g and h, a power-of-two scale 2^s is chosen from the launch's row
// count n and the largest |x| of its rows: with 2^N >= n and
// max|x| < 2^E (E from max|x|'s exponent), s = min(62 - N - E, 100).  Each
// x becomes the integer rint(x * 2^s); a bucket sums at most n of them,
// so its int64 sum stays within n * 2^(E+s) <= 2^62.  Integer adds give
// the same sum in any order, so the atomics below cannot change the
// result.  The output is float32(sum) * 2^-s: one rounding.  A
// non-finite g (or h) in any row of the launch makes every g (or h) sum
// of the launch NaN.  Integer-valued g/h are exact as long as their sums
// are (below 2^24), as before.
//
// A sum shared by several processes (the distributed trainer: each holds
// some of the rows) passes the maxima over all of them (max_bits) and N of
// all their rows (log2n) in place of the launch's own, and asks for the raw
// int64 sums (raw): every process then quantises on one grid, the int64
// sums of all processes add exactly, and the caller rounds the total once
// (ref.from_fixed).  A non-finite g or h quantises to 0, so the raw sums of
// a finite column do not depend on the other column.
//
// What bounds it on the H100: bytes.  At the training shape (n = 1M rows,
// f = 28 features, one level) the kernel must read 112 MB of bin ids,
// 4 MB of node ids and 8 MB of grad/hess and write a 236 KB panel: ~37 us
// at 3.35 TB/s, against 56 M integer adds.  What holds it back in
// practice (launch/hist_breakdown.py times it with parts taken out): the
// four shared-memory atomics an element, whose random bins conflict on
// the banks, and the loop's instructions, each as much as the bin loads.
//
// The design.  Three launches on the caller's stream (two when raw), no
// host sync:
//  1. hist_prologue: per-block maxima of |g| and |h| (as float bits, whose
//     unsigned order is the float order), and the int64 scratch and the
//     counts zeroed;
//  2. hist_kernel: each block reduces those maxima to the launch's scales,
//     owns a tile of features (or a chunk of nodes, as the Pallas
//     node_chunk does, where one feature's panel is too large) for one
//     level, and walks a range of rows.  A warp takes 32 rows at a time:
//     it reads each row's node id and g/h once, quantises g/h, and keeps
//     only the rows that add (ballot + prefix count: in child mode the
//     right-routed half never reaches the bin loads) in a slot of shared
//     memory.  The warp then walks (row, feature group) pairs of those
//     rows with the group fastest, reading V = 4, 2 or 1 bin ids with one
//     16-, 8- or 4-byte load, and adds into the block's int64 panel in
//     shared memory.  No division per element: the pair advances by
//     fixed steps.  Shared-memory atomicAdd on float or on 64-bit
//     integers is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN), so
//     each int64 bucket is two 32-bit words updated by native ATOMS.ADD:
//     the low word's returned old value gives the carry into the high
//     word.  The number of carries is the number of times the low word
//     wraps, whatever the order, so the pair is an exact int64 sum.  The
//     panel is then flushed with native 64-bit global atomics (REDG.ADD.64)
//     into the int64 scratch; zero entries are skipped;
//  3. hist_finalize: scratch -> float32 output, which the caller need not
//     zero.

#include <algorithm>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;                  // one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 232448;              // a block's most on sm_90
constexpr int kSlotBytes = 32;                  // one staged row
constexpr int kStageBytes = kWarps * 32 * kSlotBytes;
// the panel: what is left after the row slots, less 1 KB of static
// shared memory for the reductions
constexpr int kPanelBytes = kSmemBytes - kStageBytes - 1024;
constexpr int kLoadInts = 16;                   // bin ids in flight a lane
constexpr int kMaxParts = 1024;                 // prologue blocks (<= kThreads)
constexpr int kPrologueThreads = 256;
constexpr int kFinalizeThreads = 256;
constexpr int kMaxShift = 100;                  // 2^-s stays a normal float
constexpr int kMinRowsPerBlock = 4096;

// A row that adds, staged by its warp.
struct __align__(16) Slot {
  long long bin_off;   // row * f + f0: its first bin id of the tile
  int bucket_off;      // local node * ft * nbins: its panel offset
  int pad;
  long long qg, qh;    // quantised g and h
};
static_assert(sizeof(Slot) == kSlotBytes, "slot layout");

// The launch's shift s for one component, from the largest |x| (as float
// bits) and N = ceil(log2 n).  max|x| < 2^E with E = exponent field - 126
// (a zero or subnormal maximum counts as exponent field 1).
__device__ __forceinline__ int shift_of(unsigned max_bits, int log2n) {
  const int e = max(static_cast<int>((max_bits >> 23) & 0xff), 1) - 126;
  return min(62 - log2n - e, kMaxShift);
}

// 2^k as a float, for k in [-126, 127].
__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);
}

// The launch's largest |g| and |h| bits, from the prologue's per-block
// maxima, reduced by the whole block (every thread gets them).
__device__ uint2 launch_max(const unsigned* parts, int n_parts) {
  __shared__ unsigned red[2 * 32];
  unsigned mg = 0, mh = 0;
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x) {
    mg = max(mg, parts[2 * i]);
    mh = max(mh, parts[2 * i + 1]);
  }
  mg = __reduce_max_sync(0xffffffffu, mg);
  mh = __reduce_max_sync(0xffffffffu, mh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[2 * warp] = mg;
    red[2 * warp + 1] = mh;
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  mg = lane < warps ? red[2 * lane] : 0u;
  mh = lane < warps ? red[2 * lane + 1] : 0u;
  mg = __reduce_max_sync(0xffffffffu, mg);
  mh = __reduce_max_sync(0xffffffffu, mh);
  __syncthreads();   // red is reused by the next call
  return make_uint2(mg, mh);
}

__global__ void __launch_bounds__(kPrologueThreads)
hist_prologue(const float2* __restrict__ gh, int64_t n,  // 0: no maxima
              unsigned* __restrict__ parts,
              unsigned long long* __restrict__ acc, int64_t acc_len,
              int* __restrict__ counts, int64_t counts_len) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t i = tid; i < acc_len; i += stride) acc[i] = 0ull;
  for (int64_t i = tid; i < counts_len; i += stride) counts[i] = 0;
  unsigned mg = 0, mh = 0;
  for (int64_t row = tid; row < n; row += stride) {
    const float2 v = gh[row];
    mg = max(mg, __float_as_uint(fabsf(v.x)));  // NaN, inf: >= 0x7f800000
    mh = max(mh, __float_as_uint(fabsf(v.y)));
  }
  __shared__ unsigned red[2 * (kPrologueThreads / 32)];
  mg = __reduce_max_sync(0xffffffffu, mg);
  mh = __reduce_max_sync(0xffffffffu, mh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[2 * warp] = mg;
    red[2 * warp + 1] = mh;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPrologueThreads / 32; ++w) {
      mg = max(mg, red[2 * w]);
      mh = max(mh, red[2 * w + 1]);
    }
    parts[2 * blockIdx.x] = mg;
    parts[2 * blockIdx.x + 1] = mh;
  }
}

// x += v on an int64 kept as two 32-bit words of shared memory.
__device__ __forceinline__ void add_i64(unsigned* lo, unsigned* hi,
                                        long long v) {
  const unsigned vl = static_cast<unsigned>(v);
  const unsigned vh =
      static_cast<unsigned>(static_cast<unsigned long long>(v) >> 32);
  const unsigned old = atomicAdd(lo, vl);
  const unsigned carry = old + vl < old ? 1u : 0u;
  if (vh + carry) atomicAdd(hi, vh + carry);
}

// V consecutive bin ids from one aligned load.
template <int V>
__device__ __forceinline__ void load_bins(const int* p, int (&b)[V]) {
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    b[0] = t.x; b[1] = t.y; b[2] = t.z; b[3] = t.w;
  } else if constexpr (V == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    b[0] = t.x; b[1] = t.y;
  } else {
    b[0] = __ldg(p);
  }
}

template <bool kChild, int V>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const int* __restrict__ bins, const int* __restrict__ node,
            const float2* __restrict__ gh, const unsigned* __restrict__ parts,
            int n_parts, unsigned long long* __restrict__ acc,
            int* __restrict__ counts, int64_t n, int f, int n_nodes,
            int nbins, int f_tile, int f_tiles, int node_chunk, int n_chunks,
            int log2n, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  Slot* const slots = reinterpret_cast<Slot*>(smem);
  unsigned* const panel = reinterpret_cast<unsigned*>(smem + kStageBytes);

  const int tile = blockIdx.x % f_tiles;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / f_tiles) *
                       rows_per_block;
  const int64_t row_end = min(n, row0 + rows_per_block);
  const int f0 = tile * f_tile;
  const int ft = min(f - f0, f_tile);
  const int level = blockIdx.y / n_chunks;
  const int base = (blockIdx.y % n_chunks) * node_chunk;
  const int nc = min(n_nodes - base, node_chunk);
  // planes of panel_len words: g low, g high, h low, h high[, count]
  const int panel_len = nc * ft * nbins;
  unsigned* const g_lo = panel;
  unsigned* const g_hi = panel + panel_len;
  unsigned* const h_lo = panel + 2 * panel_len;
  unsigned* const h_hi = panel + 3 * panel_len;
  unsigned* const cnt = panel + 4 * panel_len;
  const int words = (kChild ? 5 : 4) * panel_len;
  for (int i = threadIdx.x; i < words; i += kThreads) panel[i] = 0u;

  const uint2 mx = launch_max(parts, n_parts);   // syncs the block
  const float scale_g = pow2(shift_of(mx.x, log2n));
  const float scale_h = pow2(shift_of(mx.y, log2n));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Slot* const ws = slots + warp * 32;
  // (row, group) pairs of the warp's staged rows, group fastest: a lane
  // starts at pair `lane` and steps by 32 pairs
  const int groups = ft / V;
  const int r_start = lane / groups, g_start = lane % groups;
  const int dr = 32 / groups, dg = 32 % groups;
  const int* const lvl_node = node + static_cast<int64_t>(level) * n;
  constexpr int kUnroll = V == 1 ? kLoadInts / 2 : kLoadInts / V;

  // the warp's next group of rows: node ids and g/h are loaded one group
  // ahead, so their latency hides behind the current group's bins
  int64_t row = row0 + warp * 32 + lane;
  int id_next = row < row_end ? __ldg(lvl_node + row) : -1;
  float2 v_next = row < row_end ? __ldg(gh + row) : make_float2(0.f, 0.f);
  for (int64_t g0 = row0 + warp * 32; g0 < row_end; g0 += kThreads) {
    row = g0 + lane;
    int id = id_next;
    const float2 v = v_next;
    const int64_t next = row + kThreads;
    id_next = next < row_end ? __ldg(lvl_node + next) : -1;
    if (next < row_end) v_next = __ldg(gh + next);
    bool adds = id >= 0;
    if (kChild) {
      adds = adds && !(id & 1);   // routed right: its sibling is parent - left
      id >>= 1;
    }
    const int local = id - base;
    adds = adds && local >= 0 && local < nc;   // another chunk, or >= n_nodes
    const unsigned ballot = __ballot_sync(0xffffffffu, adds);
    if (adds) {
      Slot s;
      s.bin_off = row * f + f0;
      s.bucket_off = local * ft * nbins;
      s.pad = 0;
      s.qg = isfinite(v.x) ? __float2ll_rn(v.x * scale_g) : 0ll;
      s.qh = isfinite(v.y) ? __float2ll_rn(v.y * scale_h) : 0ll;
      ws[__popc(ballot & ((1u << lane) - 1u))] = s;
    }
    __syncwarp();
    const int pairs = __popc(ballot) * groups;
    int r = r_start, g = g_start;
    for (int e = lane; e < pairs; e += 32 * kUnroll) {
      int b[kUnroll][V];
      int at[kUnroll];          // (staged row, group) of each load
      // every load of the round first, then the adds
      int loaded = kUnroll;     // loads of this round (the last may be short)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e + 32 * u >= pairs) {
          loaded = u;
          break;
        }
        at[u] = r * 65536 + g;  // groups < 65536: the panel bounds ft
        load_bins<V>(bins + ws[r].bin_off + g * V, b[u]);
        g += dg;
        r += dr;
        if (g >= groups) {
          g -= groups;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u >= loaded) break;             // past the staged rows
        const Slot& s = ws[at[u] >> 16];
        const int first = s.bucket_off + (at[u] & 0xffff) * V * nbins;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (static_cast<unsigned>(b[u][v]) >= static_cast<unsigned>(nbins))
            continue;
          const int bucket = first + v * nbins + b[u][v];
          add_i64(g_lo + bucket, g_hi + bucket, s.qg);
          add_i64(h_lo + bucket, h_hi + bucket, s.qh);
          if (kChild) atomicAdd(cnt + bucket, 1u);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // flush: local bucket (node, feature-in-tile, bin) -> output bucket
  for (int i = threadIdx.x; i < panel_len; i += kThreads) {
    const long long sg = static_cast<long long>(
        (static_cast<unsigned long long>(g_hi[i]) << 32) | g_lo[i]);
    const long long sh = static_cast<long long>(
        (static_cast<unsigned long long>(h_hi[i]) << 32) | h_lo[i]);
    const unsigned c = kChild ? cnt[i] : 0u;
    if (!(sg | sh | c)) continue;
    const int b = i % nbins;
    const int lj = i / nbins;
    const int64_t ob =
        ((static_cast<int64_t>(level) * n_nodes + base + lj / ft) * f + f0 +
         lj % ft) * nbins + b;
    if (sg) atomicAdd(acc + 2 * ob, static_cast<unsigned long long>(sg));
    if (sh) atomicAdd(acc + 2 * ob + 1, static_cast<unsigned long long>(sh));
    if (c) atomicAdd(counts + ob, static_cast<int>(c));
  }
}

__global__ void __launch_bounds__(kFinalizeThreads)
hist_finalize(const long long* __restrict__ acc,
              const unsigned* __restrict__ parts, int n_parts,
              float2* __restrict__ out, int64_t buckets, int log2n) {
  const uint2 mx = launch_max(parts, n_parts);
  const bool bad_g = mx.x >= 0x7f800000u, bad_h = mx.y >= 0x7f800000u;
  const float q_g = pow2(-shift_of(mx.x, log2n));
  const float q_h = pow2(-shift_of(mx.y, log2n));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x; i < buckets; i += stride) {
    float2 o;
    o.x = bad_g ? __int_as_float(0x7fc00000) : __ll2float_rn(acc[2 * i]) * q_g;
    o.y = bad_h ? __int_as_float(0x7fc00000)
                : __ll2float_rn(acc[2 * i + 1]) * q_h;
    out[i] = o;
  }
}

template <bool kChild, int V>
cudaError_t launch_main(dim3 grid, int smem, cudaStream_t stream,
                        const int* bins, const int* node, const float2* gh,
                        const unsigned* parts, int n_parts,
                        unsigned long long* acc, int* counts, int64_t n,
                        int f, int n_nodes, int nbins, int f_tile,
                        int f_tiles, int node_chunk, int n_chunks, int log2n,
                        int64_t rows_per_block) {
  auto kernel = hist_kernel<kChild, V>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes + kPanelBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      bins, node, gh, parts, n_parts, acc, counts, n, f, n_nodes, nbins,
      f_tile, f_tiles, node_chunk, n_chunks, log2n, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the shared-memory panel of one block: one feature of one node
// (nbins buckets of 16 bytes, 20 in child mode, which also counts) must
// fit, so nbins <= hist_panel_bytes() / 20 in child mode, / 16 in direct
// mode.
extern "C" int hist_panel_bytes() { return kPanelBytes; }

// Entries of the `parts` scratch the caller passes: 2 * hist_max_parts()
// uint32.
extern "C" int hist_max_parts() { return kMaxParts; }

// bins (n, f) int32, node_per_level (n_levels, n) int32, gh (n, 2) float32
// (8-byte aligned), out (n_levels, n_nodes, f, nbins, 2) float32, acc the
// same number of int64 (scratch), parts 2 * hist_max_parts() uint32
// (scratch) and, in child mode, counts (n_levels, n_nodes, f, nbins) int32
// (ignored in direct mode); all contiguous on the current device, none
// zeroed by the caller.  max_bits: null, or 2 uint32 on the device, the
// float bits of the largest |g| and |h| to take in place of the launch's
// own; log2n: -1, or the N to take in place of ceil(log2 n) (2^log2n >= n);
// raw != 0: stop before the finalize and leave the int64 sums in acc (out
// may then be null).  Three launches on `stream` (two when raw).  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int hist_levels(const void* bins, const void* node_per_level,
                           const void* gh, void* out, void* acc, void* parts,
                           void* counts, int64_t n, int f, int n_levels,
                           int n_nodes, int nbins, int child,
                           const void* max_bits, int log2n, int raw,
                           void* stream) {
  const int per_node_feature = nbins * (child ? 20 : 16);
  if (n <= 0 || n > 0x7fffffffLL || f <= 0 || n_levels <= 0 ||
      n_nodes <= 0 || nbins <= 0 ||
      per_node_feature > kPanelBytes || (child && counts == nullptr) ||
      (!raw && out == nullptr) || log2n < -1 || log2n > 62 ||
      (log2n >= 0 && (int64_t{1} << log2n) < n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Features a block can hold with the whole frontier; where not even one
  // fits, chunk nodes one feature at a time.  Otherwise pick the width V
  // of the bin loads and the tile: fewest tiles, then the narrowest tile
  // (balance), then the widest loads.  V must divide f, and the bins
  // pointer must be aligned to V ints.
  const int64_t frontier_bytes = static_cast<int64_t>(n_nodes) *
                                 per_node_feature;
  const int max_ft = static_cast<int>(
      std::min<int64_t>(f, kPanelBytes / frontier_bytes));
  int vec = 1, f_tile = 1, f_tiles = f, node_chunk = n_nodes;
  if (max_ft >= 1) {
    int best_tiles = 0;
    for (int v : {4, 2, 1}) {
      if (f % v || reinterpret_cast<uintptr_t>(bins) % (4 * v) ||
          max_ft < v) {
        continue;
      }
      const int width = max_ft / v * v;
      const int tiles = (f + width - 1) / width;
      const int balanced = ((f + tiles - 1) / tiles + v - 1) / v * v;
      if (best_tiles == 0 || tiles < best_tiles ||
          (tiles == best_tiles && balanced < f_tile)) {
        best_tiles = tiles;
        vec = v;
        f_tile = balanced;
      }
    }
    f_tiles = (f + f_tile - 1) / f_tile;
  } else {
    node_chunk = kPanelBytes / per_node_feature;
  }
  const int n_chunks = (n_nodes + node_chunk - 1) / node_chunk;
  node_chunk = (n_nodes + n_chunks - 1) / n_chunks;
  const int64_t z = static_cast<int64_t>(n_levels) * n_chunks;
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one wave of one block per SM, unless that leaves a block fewer rows
  // than kMinRowsPerBlock
  const int64_t per_row_block = static_cast<int64_t>(f_tiles) * z;
  int64_t gx = std::max<int64_t>(1, sms / per_row_block);
  gx = std::min(gx, (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock);
  gx = std::max<int64_t>(gx, 1);
  const int64_t rows_per_block = (n + gx - 1) / gx;
  gx = (n + rows_per_block - 1) / rows_per_block;
  if (gx * f_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (log2n < 0) {
    log2n = 0;
    while ((int64_t{1} << log2n) < n) ++log2n;
  }

  const int64_t buckets = static_cast<int64_t>(n_levels) * n_nodes * f *
                          nbins;
  const int n_parts = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(
      std::min<int64_t>(kMaxParts, 4 * sms),
      (n + kPrologueThreads - 1) / kPrologueThreads)));
  auto strm = static_cast<cudaStream_t>(stream);
  auto* acc64 = static_cast<unsigned long long*>(acc);
  auto* parts32 = static_cast<unsigned*>(parts);
  auto* counts32 = static_cast<int*>(counts);
  // the maxima the scales come from: the prologue's per-block ones, or the
  // caller's shared pair (then the prologue only zeroes)
  const auto* max_src = max_bits ? static_cast<const unsigned*>(max_bits)
                                 : parts32;
  const int n_src = max_bits ? 1 : n_parts;
  hist_prologue<<<n_parts, kPrologueThreads, 0, strm>>>(
      static_cast<const float2*>(gh), max_bits ? 0 : n, parts32, acc64,
      2 * buckets, counts32, child ? buckets : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem = kStageBytes + node_chunk * f_tile * per_node_feature;
  const dim3 grid(static_cast<unsigned>(gx * f_tiles),
                  static_cast<unsigned>(z));
  const auto* b = static_cast<const int*>(bins);
  const auto* nd = static_cast<const int*>(node_per_level);
  const auto* g = static_cast<const float2*>(gh);
#define HIST_LAUNCH(CHILD, V)                                                \
  launch_main<CHILD, V>(grid, smem, strm, b, nd, g, max_src, n_src, acc64,  \
                        counts32, n, f, n_nodes, nbins, f_tile, f_tiles,     \
                        node_chunk, n_chunks, log2n, rows_per_block)
  if (child) {
    err = vec == 4 ? HIST_LAUNCH(true, 4)
        : vec == 2 ? HIST_LAUNCH(true, 2) : HIST_LAUNCH(true, 1);
  } else {
    err = vec == 4 ? HIST_LAUNCH(false, 4)
        : vec == 2 ? HIST_LAUNCH(false, 2) : HIST_LAUNCH(false, 1);
  }
#undef HIST_LAUNCH
  if (err != cudaSuccess || raw) return static_cast<int>(err);

  const int64_t fin_blocks = std::min<int64_t>(
      (buckets + kFinalizeThreads - 1) / kFinalizeThreads, 8 * sms);
  hist_finalize<<<static_cast<unsigned>(fin_blocks), kFinalizeThreads, 0,
                  strm>>>(static_cast<const long long*>(acc), max_src,
                          n_src, static_cast<float2*>(out), buckets, log2n);
  return static_cast<int>(cudaGetLastError());
}
