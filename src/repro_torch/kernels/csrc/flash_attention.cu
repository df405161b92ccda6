// Blockwise (flash) attention with GQA and causal / sliding-window masks,
// for Hopper (sm_90a): two kernels behind two C entries.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (kernel _flash_kernel).  For query row i of head h and key j of KV head
// h / g (g = q_heads / kv_heads), positions counted from 0 on both sides:
//
//   s_ij = (q_i . k_j) * scale,   scale = 1/sqrt(d) rounded to float32,
//   kept where j < kv_len and (j <= i if causal) and (j > i - window if
//   window > 0),
//
// and o_i = sum_j softmax_j(s_i) v_j, by the online softmax over tiles of
// keys with float32 m (running max, NEG_INF = -1e30 at the start), l (sum
// of exponentials) and acc (sum of p v).  A row that keeps no key has
// l == 0 and gets 0.  kv_len (at most sk) bounds the real keys of K/V
// padded to a multiple of 128: whisper's 1500 frames run as 1536, the
// counterpart of the JAX package's _flash_xla, which takes any length.
// Both kernels skip KV tiles that lie wholly outside the causal / window
// band or past kv_len.  That is exact: such a tile has s = NEG_INF
// everywhere, so m_new = m_prev, alpha = exp(0) = 1 and p = 0, and m, l
// and acc are unchanged in the JAX kernel too.  Both take query tiles
// heaviest first (the longest causal bands; the Hopper kernel within a
// group of heads), so the long tiles start early and the short ones fill
// the end.
//
// What bounds it on the H100: operations.  At the prefill shape of
// glm4-9b (q 2 x 32 x 4096 x 128, k/v 2 x 2 x 4096 x 128, causal) the
// unmasked (query, key) pairs need 4d = 512 operations each, 275 GFLOP,
// against 0.14 GB of q, k, v and o: 0.28 ms at the tensor cores' 989
// TFLOP/s in bf16, 4.1 ms at the 67 TFLOP/s of float32 on the CUDA cores.
//
// flash_attention_wgmma -- every bf16 call, at head dims 32, 64, 80 and
// 128 (the prefill path).  Design, for the tensor cores:
// - Persistent: one block of 384 threads an SM takes work items, each a
//   (batch * q-head, 128-row query tile), one at a time from a global
//   count (atomicAdd), until none is left.  Items run a group of heads
//   at a time, heaviest first within a group, a group about as many
//   items as there are blocks: the blocks in flight read the K/V of a
//   group or two of heads, which stay in L2 (zamba2's 84 MB of K/V do
//   not fit its 50 MB), and every group ends with its lightest items, so
//   the blocks finish together.  Two consumer warpgroups take 64 query
//   rows each; one thread of a producer warpgroup takes the items and
//   issues every copy.  setmaxnreg moves registers from the producer (24
//   a thread) to the consumers (240).
//   The K/V ring runs on from one item to the next, and the next item's
//   Q loads (once an mbarrier says every S of this item has landed) while
//   this item's last P V and its output are under way.
// - Q, and K and V in tiles of 128 keys, reach shared memory by TMA
//   (cp.async.bulk.tensor, tensor maps built on the host) in the swizzled
//   layout that wgmma's descriptors read, in column chunks of one swizzle
//   span each, one TMA box a chunk: 64 columns (128-byte swizzle) where d
//   is a multiple of 64, else 32 (64-byte swizzle).  d = 80 takes three
//   chunks of 32, the last box half past the row's end: TMA fills its
//   columns 80 .. 95 with zeros (and counts them in the transaction
//   bytes), so a tile is kDPad = 96 columns wide in shared memory.
// - K/V go through a ring of three stages (225 KB of shared memory at
//   d = 128 with Q, 169 KB at d = 80; a fourth at d = 80 timed no
//   faster), each with a full mbarrier (the copy's bytes arrived) and an
//   empty one (all 256 consumer threads are done with it), so the next
//   tiles load while this one is computed.
// - S = Q K^T by wgmma m64n128k16, bf16 x bf16 -> f32, Q and K from
//   shared memory (both K-major), in d / 16 steps: at d = 80 five, which
//   never read the zero columns.  O += P V by wgmma m64nNk16, N = kDPad
//   (96 at d = 80: its last 16 accumulator columns are 0 and never
//   written out), with P as the A operand from registers: the f32
//   accumulator of S holds, per thread, exactly the elements of the A
//   fragment of the next product, so P is packed to bf16 in place and
//   never goes through shared memory.  V is the B operand as stored,
//   [keys][d], read MN-major (the transpose bit).
// - Overlap, two ways.  Within a warpgroup: S_t = Q K_t^T and
//   P_{t-1} V_{t-1} are issued together, the softmax of S_t runs while
//   P V is in flight, and O is rescaled once P V has landed (S, P and O
//   in flight at once: 160 of the 240 registers at d = 128, 144 at
//   d = 80).  Between the two warpgroups: they take turns to issue
//   (named barriers), so that one's softmax runs while the other's
//   products hold the tensor cores; left alone, the two wait on the same
//   tile and reach their softmax together, leaving the tensor cores
//   idle.  The wgmma descriptors are built inside each wgmma's asm from
//   a tile's descriptor and an immediate offset, so the compiler keeps no
//   descriptor a k16 step live: with them hoisted, ptxas ran out of
//   registers and serialised the wgmmas.
// - Only tiles that straddle the diagonal, the window's lower edge or
//   kv_len for a warpgroup's 64 rows compute the mask; interior tiles run
//   unmasked.  The key-length bound is folded into the row's upper bound
//   outside the loop over the tile's 64 elements, so the loop is the same.
// - GQA reads KV head h / g through its row coordinate in the K/V tensor
//   maps; no K/V is repeated.  A block takes one query head: two heads of
//   one group do not share a K/V tile (each K/V tile is read from L2 by
//   the g blocks of its group).
// - Numerics: scores, m, l and acc are float32.  log2(e) is folded into
//   the scale and the exponentials are the SFU's ex2 (ex2.approx.ftz; no
//   fast-math flag): p = 2^(s * scale * log2(e) - m), m kept in that
//   base-2 domain, masked scores at -inf so that p = 0 exactly, a p below
//   2^-126 flushed to 0.  l sums the float32 p; only the A operand of P V
//   is p rounded to bf16 (to nearest even).  That adds at most
//   2^-9 sum_j p_j |v_j| / l to an output element, the term that
//   ref.attention_rounding_bound doubles.  o = acc * (1 / l), within an
//   ulp of acc / l, is rounded to bf16 at the end.  A row with one kept
//   key gets p = 1 and o = v exactly.
// - lse for the backward: the instance flash_kernel_wgmma<D, true> also
//   writes each row's log-sum-exp of its kept scaled scores, natural log,
//   from the final m (base 2) and l: lse = (m + log2 l) ln 2, +inf where
//   l == 0; flash_attention_bwd.cu turns it back into base 2 as it reads
//   it.  The template flag keeps it out of the no-grad instances.
// - The mbarrier, TMA, descriptor and wgmma helpers and the tensor-map
//   encoding are in hopper.cuh, shared with the backward.
// - A wait on an mbarrier that lasts 4 s traps, so a broken pipeline
//   fails the launch instead of holding the card (the consumers' wait for
//   Q has no timeout; the producer's next wait then traps).
//
// flash_attention -- the CUDA-core kernel: every float32 call.  It keeps
// the JAX kernel's float32 arithmetic, p included, so it meets the 2e-4
// contract with the JAX package; a TF32 wgmma keeps 10 bits of mantissa
// and would not.  One block of 256 threads owns one (batch * q-head,
// 64-row query tile); the TPU grid's sequential KV axis becomes a loop
// inside the block over 64-key tiles, staged through shared memory.  Per
// KV tile: S = Q K^T as a 4 x 4 register tile per thread (float4 reads
// along d, rows padded by 4 floats so a quarter-warp's reads hit distinct
// banks), the online-softmax update with the row max and row sum reduced
// across the 16 threads that share a row by warp shuffles (a butterfly,
// so every thread holds the same value), P written to shared memory, then
// acc += P V into a 4 x (4 * NC) register tile.  K and then V reuse one
// shared buffer, so two blocks fit on an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the JAX kernel's NEG_INF

template <int D>
struct Tile {
  static constexpr int kLd = D + 4;            // padded row, floats
  static constexpr int kLdP = kBlockK + 16;    // P rows: no write conflicts
  static constexpr int kNC = (D / 4 + 15) / 16;  // float4 columns a thread
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((kBlockQ + kBlockK) * kLd + kBlockQ * kLdP);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows x D contiguous floats of global memory -> rows of shared memory
// with stride Tile<D>::kLd.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* dst, int rows) {
  constexpr int kGroups = D / 4;
  for (int idx = threadIdx.x; idx < rows * kGroups; idx += kThreads) {
    const int r = idx / kGroups;
    const int c = idx - r * kGroups;
    store4(dst + r * Tile<D>::kLd + 4 * c, load4(src + 4 * idx));
  }
}

// Reduce over the 16 lanes of a half-warp that share a query row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int q_heads,
             int kv_heads, int sq, int sk, int kv_len, float scale,
             int causal, int window) {
  using Tl = Tile<D>;
  constexpr int kLd = Tl::kLd;
  constexpr int kLdP = Tl::kLdP;
  constexpr int kNC = Tl::kNC;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBlockQ * kLd;
  float* sP = sKV + kBlockK * kLd;

  const int bh = blockIdx.x;                       // batch * q_heads + head
  const int qt = gridDim.y - 1 - blockIdx.y;       // heaviest tile first
  const int b = bh / q_heads;
  const int kvh = b * kv_heads + (bh - b * q_heads) / (q_heads / kv_heads);
  const int q0 = qt * kBlockQ;
  const float* qb = q + (static_cast<size_t>(bh) * sq + q0) * D;
  const float* kb = k + static_cast<size_t>(kvh) * sk * D;
  const float* vb = v + static_cast<size_t>(kvh) * sk * D;

  const int tx = threadIdx.x & 15;   // key column / output column group
  const int ty = threadIdx.x >> 4;   // query rows ty + 16 i

  stage<D>(qb, sQ, kBlockQ);

  float m[4], l[4], acc[4][kNC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // The band of KV tiles that hold a kept key for some row of this tile:
  // none at or past kv_len.
  int k_begin = 0;
  int k_end = kv_len;
  if (causal) k_end = min(kv_len, q0 + kBlockQ);
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBlockK * kBlockK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's P V is done with sKV and sP
    stage<D>(kb + static_cast<size_t>(k0) * D, sKV, kBlockK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(sQ + (ty + 16 * i) * kLd + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = load4(sKV + (tx + 16 * j) * kLd + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, bk[j].x, t);
          t = fmaf(a[i].y, bk[j].y, t);
          t = fmaf(a[i].z, bk[j].z, t);
          t = fmaf(a[i].w, bk[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        keep[j] = kpos < kv_len && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }

    __syncthreads();  // every thread is done reading K; P is written
    stage<D>(vb + static_cast<size_t>(k0) * D, sKV, kBlockK);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = load4(sP + (ty + 16 * i) * kLdP + kk);
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int col = 4 * (tx + 16 * c);
        if (col >= D) break;
        const float4 v0 = load4(sKV + (kk + 0) * kLd + col);
        const float4 v1 = load4(sKV + (kk + 1) * kLd + col);
        const float4 v2 = load4(sKV + (kk + 2) * kLd + col);
        const float4 v3 = load4(sKV + (kk + 3) * kLd + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[i][c];
          a[0] = fmaf(p[i].w, v3.x, fmaf(p[i].z, v2.x,
                 fmaf(p[i].y, v1.x, fmaf(p[i].x, v0.x, a[0]))));
          a[1] = fmaf(p[i].w, v3.y, fmaf(p[i].z, v2.y,
                 fmaf(p[i].y, v1.y, fmaf(p[i].x, v0.y, a[1]))));
          a[2] = fmaf(p[i].w, v3.z, fmaf(p[i].z, v2.z,
                 fmaf(p[i].y, v1.z, fmaf(p[i].x, v0.z, a[2]))));
          a[3] = fmaf(p[i].w, v3.w, fmaf(p[i].z, v2.w,
                 fmaf(p[i].y, v1.w, fmaf(p[i].x, v0.w, a[3]))));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (static_cast<size_t>(bh) * sq + q0 + ty + 16 * i) * D;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 4 * (tx + 16 * c);
      if (col >= D) break;
      store4(orow + col, make_float4(acc[i][c][0] / safe, acc[i][c][1] / safe,
                                     acc[i][c][2] / safe, acc[i][c][3] / safe));
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int q_heads, int kv_heads, int sq, int sk,
                   int kv_len, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmemBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(batch * q_heads, sq / kBlockQ);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), q_heads, kv_heads,
      sq, sk, kv_len, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The Hopper kernel: wgmma on the tensor cores, a TMA ring, warp-specialised.
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kBlockM = 128;             // query rows: 2 warpgroups x 64
constexpr int kBlockN = 128;             // keys a K/V tile; divides 128
constexpr int kStages = 3;               // the K/V ring
constexpr int kConsumers = 256;          // 2 consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup

// The forward's shared memory: Q, the K/V ring, the barriers.
template <int D>
struct Smem {
  using L = Layout<D>;
  static constexpr int kQBytes = L::bytes(kBlockM);
  static constexpr int kTileBytes = L::bytes(kBlockN);  // K or V a stage
  // full and empty a stage, Q's full and empty, the current work item
  static constexpr int kBarrierBytes = 8 * (2 * kStages + 3);
  // 1024 bytes of slack to align the tiles to the swizzle's period.
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + kBarrierBytes;
};

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Where a thread's accumulator elements lie in the tile.
struct Rows {
  int q_lo;   // the warpgroup's first query row
  int r0;     // the thread's rows: r0 and r0 + 8
  int c0;     // the thread's first column in each group of 8
};

// The online softmax of two rows (r0 and r0 + 8) of a thread: running
// max m in the base-2 domain (scores times scale * log2(e)), this
// thread's share of l, and the factor alpha by which the accumulator
// still has to be rescaled for the latest tile.
struct Softmax {
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;
  float alpha0 = 1.f, alpha1 = 1.f;

  // Scores of the tile at key k0 -> float32 p, in place.
  __device__ __forceinline__ void update(float (&s)[64], const Rows& rows,
                                         int k0, float scale_log2,
                                         int causal, int window,
                                         int kv_len) {
    // The mask, only on tiles that straddle the diagonal, the window's
    // lower edge or kv_len for some row of this warpgroup: row r keeps
    // the keys in [r - window + 1, min(r, kv_len - 1)] (causal, window),
    // as offsets from the thread's first column in the tile: up to hi0 in
    // row r0, hi8 in row r0 + 8.
    if ((causal && k0 + kBlockN - 1 > rows.q_lo)
        || (window > 0 && k0 <= rows.q_lo + 63 - window)
        || k0 + kBlockN > kv_len) {
      const int base = k0 + rows.c0;
      const int last = kv_len - 1 - base;
      const int hi0 = causal ? min(rows.r0 - base, last) : last;
      const int hi8 = causal ? min(rows.r0 + 8 - base, last) : last;
      const int lo0 = window > 0 ? rows.r0 - window + 1 - base : -kBlockN;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = 8 * (i >> 2) + (i & 1);
        const int row8 = 8 * ((i >> 1) & 1);
        if (col > (row8 ? hi8 : hi0) || col < lo0 + row8) s[i] = -INFINITY;
      }
    }
    // Row max and row sum over four independent partials a row, so that
    // the chains of dependent operations are 4 long and not 16.
    float mx0[4], mx1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
      mx1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int j = 4; j < 16; ++j) {
      mx0[j & 3] = fmaxf(mx0[j & 3], fmaxf(s[4 * j], s[4 * j + 1]));
      mx1[j & 3] = fmaxf(mx1[j & 3], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float row_max0 = fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]));
    float row_max1 = fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      row_max0 = fmaxf(row_max0, __shfl_xor_sync(0xffffffffu, row_max0, off));
      row_max1 = fmaxf(row_max1, __shfl_xor_sync(0xffffffffu, row_max1, off));
    }
    // scale > 0, so the scaled max is the max of the scaled scores
    const float mn0 = fmaxf(m0, row_max0 * scale_log2);
    const float mn1 = fmaxf(m1, row_max1 * scale_log2);
    alpha0 = exp2_ftz(m0 - mn0);
    alpha1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0[4] = {0.f, 0.f, 0.f, 0.f}, sum1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = exp2_ftz(fmaf(s[4 * j], scale_log2, -mn0));
      s[4 * j + 1] = exp2_ftz(fmaf(s[4 * j + 1], scale_log2, -mn0));
      s[4 * j + 2] = exp2_ftz(fmaf(s[4 * j + 2], scale_log2, -mn1));
      s[4 * j + 3] = exp2_ftz(fmaf(s[4 * j + 3], scale_log2, -mn1));
      sum0[j & 3] += s[4 * j] + s[4 * j + 1];
      sum1[j & 3] += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + ((sum0[0] + sum0[1]) + (sum0[2] + sum0[3]));
    l1 = l1 * alpha1 + ((sum1[0] + sum1[1]) + (sum1[2] + sum1[3]));
  }

  template <int N>
  __device__ __forceinline__ void rescale(float (&acc)[N]) const {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
  }
};

// One work item: a (batch * q-head, 128-row query tile) and its band of
// K/V tiles.  Items are numbered group of heads by group of heads
// (``group`` heads each, the last group maybe fewer), and within a group
// heaviest first: every head's last query tile (the longest causal band),
// then every head's tile before it, ...
struct Work {
  int bh;        // batch * q_heads + head
  int q0;        // first query row
  int kv_row;    // row of the band's first K/V tile in the K/V maps
  int k_begin;   // its first key
  int n_tiles;   // K/V tiles in the band
};

__device__ __forceinline__ Work work_item(int item, int heads, int group,
                                          int q_heads, int kv_heads, int sq,
                                          int sk, int kv_len, int causal,
                                          int window) {
  Work w;
  const int n_q = sq / kBlockM;
  const int first = item / (group * n_q) * group;   // the group's first head
  const int rest = item - first * n_q;              // item within the group
  const int in_group = min(group, heads - first);
  w.bh = first + rest % in_group;
  w.q0 = (n_q - 1 - rest / in_group) * kBlockM;
  const int b = w.bh / q_heads;
  const int kvh = b * kv_heads + (w.bh - b * q_heads) / (q_heads / kv_heads);
  // The band of K/V tiles that hold a kept key for some row of the tile:
  // none at or past kv_len.  A band that keeps no key (a window that
  // starts past kv_len) still runs its first tile, all of it masked, so
  // that its rows get 0.
  int k_end = kv_len;
  w.k_begin = 0;
  if (causal) k_end = min(kv_len, w.q0 + kBlockM);
  if (window > 0) w.k_begin = max(0, w.q0 - window + 1) / kBlockN * kBlockN;
  w.n_tiles = max(1, (k_end - w.k_begin + kBlockN - 1) / kBlockN);
  w.kv_row = kvh * sk + w.k_begin;
  return w;
}

// Persistent: each block takes the next work item from ``next_item`` (a
// global count from 0, one atomicAdd an item) until none is left, so the
// blocks in flight work on the items of a group or two of heads at a time
// (their K/V stay in L2) and finish together.  The K/V ring runs on
// across items, and the next item's Q loads while this item's last
// products and its output are still under way.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int* __restrict__ next_item,
                   int heads, int group, int q_heads, int kv_heads, int sq,
                   int sk, int kv_len, float scale_log2, int causal,
                   int window) {
  using L = Layout<D>;
  using S = Smem<D>;
  constexpr int kSw = L::kSwizzle;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u)
      & ~1023u;
  const uint32_t s_q = base;                          // [chunk][128 rows]
  const uint32_t s_k = s_q + S::kQBytes;              // [stage][chunk][rows]
  const uint32_t s_v = s_k + kStages * S::kTileBytes;
  const uint32_t bars = s_v + kStages * S::kTileBytes;
  // full[stage] at bars + 8 stage, empty[stage] after them, then Q's
  // full and empty, then the block's current work item: the producer
  // writes it once Q is free (q_empty), the consumers read it once Q has
  // landed (q_full); an item past the last ends the block
  const uint32_t q_full = bars + 16 * kStages;
  const uint32_t q_empty = q_full + 8;
  const uint32_t s_item = q_empty + 8;
  const int n_items = heads * (sq / kBlockM);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(bars + 8 * st, 1);                          // full
      bar_init(bars + 8 * (kStages + st), kConsumers);     // empty
    }
    bar_init(q_full, 1);
    bar_init(q_empty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int g = 0;                                   // K/V tiles so far
      for (int j = 0;; ++j) {                      // items so far
        const int item = atomicAdd(next_item, 1);
        // Q is free once every S of the block's previous item has landed.
        bar_wait(q_empty, (j & 1) ^ 1);
        st_shared(s_item, item);
        if (item >= n_items) {
          bar_arrive(q_full);                      // the end, no copy
          break;
        }
        const Work w = work_item(item, heads, group, q_heads, kv_heads, sq,
                                 sk, kv_len, causal, window);
        bar_expect_tx(q_full, S::kQBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(s_q + c * kBlockM * kSw, &tq, q_full, c * L::kChunkCols,
                   w.bh * sq + w.q0);
        for (int t = 0; t < w.n_tiles; ++t, ++g) {
          const int st = g % kStages;
          const uint32_t full = bars + 8 * st;
          // the first pass over the ring finds every stage empty
          bar_wait(bars + 8 * (kStages + st), ((g / kStages) & 1) ^ 1);
          bar_expect_tx(full, 2 * S::kTileBytes);
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c) {
            const uint32_t off = st * S::kTileBytes + c * kBlockN * kSw;
            tma_load(s_k + off, &tk, full, c * L::kChunkCols,
                     w.kv_row + t * kBlockN);
            tma_load(s_v + off, &tv, full, c * L::kChunkCols,
                     w.kv_row + t * kBlockN);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so that one's softmax runs while the other's
    // products hold the tensor cores.  Warpgroup 0 goes first.
    const int my_turn = 1 + wg;
    const int other_turn = 2 - wg;
    if (wg == 1) named_arrive(1);

    // Descriptors: K-major Q and K (the leading offset unused), MN-major V
    // (column chunks kBlockN rows apart); 8-row groups 8 rows apart.
    const uint64_t dq = descriptor<kSw>(s_q + wg * 64 * kSw, 16, 8 * kSw);
    const uint64_t dk = descriptor<kSw>(s_k, 16, 8 * kSw);
    const uint64_t dv = descriptor<kSw>(s_v, kBlockN * kSw, 8 * kSw);
    constexpr int kTileDesc = S::kTileBytes >> 4;   // a stage, in the
                                                    // descriptor's units
    int g = 0;                                      // K/V tiles so far
    for (int j = 0;; ++j) {                         // items so far
      // Accumulator layout of a 64 x N wgmma, per thread: element 4j + e
      // is (row r0 + 8 (e >> 1), column 8j + c0 + (e & 1)).
      float acc[L::kDPad / 2];
#pragma unroll
      for (int i = 0; i < L::kDPad / 2; ++i) acc[i] = 0.f;
      float s[64];          // scores of a tile, then its float32 p
      uint32_t p[32];       // p in bf16: the A fragments of P V
      Softmax sm;

      // Q and the item (a wait without bar_wait's timeout: ptxas makes
      // room for one here by spilling P and acc at d = 80 and 128; a
      // pipeline broken here still traps in the producer's next wait)
      bar_spin(q_full, j & 1);
      const int item = ld_shared(s_item);
      if (item >= n_items) break;
      const Work w = work_item(item, heads, group, q_heads, kv_heads, sq, sk,
                               kv_len, causal, window);
      Rows rows;
      rows.q_lo = w.q0 + 64 * wg;                      // this warpgroup's
      rows.r0 = rows.q_lo + 16 * warp + (lane >> 2);   // rows r0, r0 + 8
      rows.c0 = 2 * (lane & 3);                        // columns c0, c0 + 1

      // Tile 0: S alone.
      int st = g % kStages;
      bar_wait(bars + 8 * st, (g / kStages) & 1);
      named_sync(my_turn);
      wgmma_fence();
      issue_ss<D, 128, kBlockM, kBlockN>(s, dq, dk + st * kTileDesc);
      wgmma_commit();
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(s);
      sm.update(s, rows, w.k_begin, scale_log2, causal, window, kv_len);
      pack_a(s, p);

      // Tile t: S_t = Q K_t^T and P_{t-1} V_{t-1} in one turn; the
      // softmax of S_t runs under this warpgroup's P V and the other
      // warpgroup's turn, and O is rescaled once P V has landed.
      for (int t = 1; t < w.n_tiles; ++t) {
        const int prev = st;
        st = (g + t) % kStages;
        bar_wait(bars + 8 * st, ((g + t) / kStages) & 1);
        named_sync(my_turn);
        wgmma_fence();
        issue_ss<D, 128, kBlockM, kBlockN>(s, dq, dk + st * kTileDesc);
        wgmma_commit();
        issue_rs<D, kBlockN>(acc, p, dv + prev * kTileDesc);
        wgmma_commit();
        named_arrive(other_turn);
        wgmma_wait<1>();                   // S_t has landed
        fence_regs(s);
        sm.update(s, rows, w.k_begin + t * kBlockN, scale_log2, causal,
                  window, kv_len);
        wgmma_wait<0>();                   // P_{t-1} V_{t-1} has landed
        fence_regs(acc);
        bar_arrive(bars + 8 * (kStages + prev));   // tile t-1 may refill
        sm.rescale(acc);
        pack_a(s, p);
      }
      bar_arrive(q_empty);               // every S of this item has landed
      g += w.n_tiles;

      // The last tile's P V.
      named_sync(my_turn);
      wgmma_fence();
      issue_rs<D, kBlockN>(acc, p, dv + st * kTileDesc);
      wgmma_commit();
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(acc);
      bar_arrive(bars + 8 * (kStages + st));

      // l over the 4 threads of a row, then o = acc * (1 / l) (0 where
      // l == 0): within an ulp of acc / l in float32, far below the bf16
      // rounding of o.  Only the first D columns of acc are written.
      float l0 = sm.l0, l1 = sm.l1;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      if constexpr (kLse) {
        // lse = ln(sum_j e^(s_ij scale)) = (m + log2 l) ln 2, m being the
        // row max in the base-2 domain (p = 2^(s scale log2(e) - m));
        // +inf where the row keeps no key (l == 0)
        if ((lane & 3) == 0) {
          float* lrow = lse + static_cast<size_t>(w.bh) * sq + rows.r0;
          lrow[0] = l0 == 0.f ? INFINITY
                              : (sm.m0 + log2f(l0)) * 0.6931471805599453f;
          lrow[8] = l1 == 0.f ? INFINITY
                              : (sm.m1 + log2f(l1)) * 0.6931471805599453f;
        }
      }
      const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
      const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
      __nv_bfloat16* o0 =
          o + (static_cast<size_t>(w.bh) * sq + rows.r0) * D + rows.c0;
      __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        *reinterpret_cast<uint32_t*>(o0 + 8 * c) =
            pack_bf16(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
        *reinterpret_cast<uint32_t*>(o1 + 8 * c) =
            pack_bf16(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
      }
    }
    // Warpgroup 1 arrives on warpgroup 0's turn once more than warpgroup
    // 0 takes a turn (the first arrival, before any item): the last one.
    if (wg == 0) named_sync(my_turn);
  }
}

// Returns a cudaError_t, or -CUresult if a tensor map could not be built.
// With ``lse`` (not null) the instance that also writes each row's
// log-sum-exp runs; without it, the one that does not.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int* next_item, int batch, int q_heads, int kv_heads, int sq,
           int sk, int kv_len, float scale, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const uint64_t kv_rows = static_cast<uint64_t>(batch) * kv_heads * sk;
  CUresult r = make_map<D>(&tq, q, static_cast<uint64_t>(batch) * q_heads * sq,
                           kBlockM);
  if (r == CUDA_SUCCESS) r = make_map<D>(&tk, k, kv_rows, kBlockN);
  if (r == CUDA_SUCCESS) r = make_map<D>(&tv, v, kv_rows, kBlockN);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  constexpr int smem = Smem<D>::kSmemBytes;
  const auto kernel = lse != nullptr ? flash_kernel_wgmma<D, true>
                                     : flash_kernel_wgmma<D, false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // One block an SM (a block takes 225 KB of shared memory at d = 128),
  // each taking work items until none is left.  A
  // group of heads has about as many items as there are blocks: the
  // blocks in flight read the K/V of a group or two of heads (zamba2's 64
  // heads hold 84 MB of K/V, more than the 50 MB of L2), and each group
  // ends with its lightest items.
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const int heads = batch * q_heads;
  const int n_q = sq / kBlockM;
  const int blocks = min(heads * n_q, sms);
  const int group = max(1, blocks / n_q);
  kernel<<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, next_item, heads,
      group, q_heads, kv_heads, sq, sk, kv_len, scale * 1.4426950408889634f,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

}  // namespace

// q (batch, q_heads, sq, d), k and v (batch, kv_heads, sk, d), o like q:
// contiguous and 16-byte aligned.  q_heads % kv_heads == 0; sq and sk
// multiples of 128 (the JAX kernel's block); a causal or window mask only
// with sq == sk.  Only the first kv_len keys (1 <= kv_len <= sk) are
// attended to: the rest is padding, never loaded where a whole tile of it
// lies past kv_len, masked where a tile straddles it.  Each returns
// cudaGetLastError() after its launch, and cudaErrorInvalidValue, without
// a launch, for a head dim it was not built for; the wrapper
// (kernels/flash_attention.py) picks the entry by dtype.

// The CUDA-core kernel: float32 at d in {32, 64, 80, 128}.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int batch, int q_heads, int kv_heads,
                               int sq, int sk, int kv_len, int d, float scale,
                               int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, batch, q_heads, kv_heads, sq, sk, kv_len,
                        scale, causal, window, s);
    case 64:
      return launch<64>(q, k, v, o, batch, q_heads, kv_heads, sq, sk, kv_len,
                        scale, causal, window, s);
    case 80:
      return launch<80>(q, k, v, o, batch, q_heads, kv_heads, sq, sk, kv_len,
                        scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, o, batch, q_heads, kv_heads, sq, sk, kv_len,
                         scale, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The Hopper kernel: bf16 at d in {32, 64, 80, 128}.  ``lse``: null, or
// (batch, q_heads, sq) float32 that receives each row's log-sum-exp of
// its kept scaled scores (+inf where it keeps none), for the backward.
// ``next_item``: one int32 of device memory, 0 at the launch (the count
// of work items taken).  A negative result is -CUresult of
// cuTensorMapEncodeTiled (no launch).
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int* next_item, int batch, int q_heads,
                                     int kv_heads, int sq, int sk, int kv_len,
                                     int d, float scale, int causal,
                                     int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define REPRO_FWD_CASE(DIM)                                                \
  case DIM:                                                                \
    return hopper::launch<DIM>(q, k, v, o, lse, next_item, batch, q_heads, \
                               kv_heads, sq, sk, kv_len, scale, causal,    \
                               window, s);
    REPRO_FWD_CASE(32)
    REPRO_FWD_CASE(64)
    REPRO_FWD_CASE(80)
    REPRO_FWD_CASE(128)
#undef REPRO_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
