// The backward of blockwise (flash) attention with GQA and causal /
// sliding-window masks and a key-length bound, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: src/repro/kernels/flash_attention.py::
// flash_attention_pallas has no VJP, and the JAX package trains through
// _flash_xla (src/repro/models/attention.py:98), whose kv_body is under
// jax.checkpoint so that its VJP recomputes each block and never stacks
// the S x S probabilities.  This is that VJP as kernels: the gradients of
// exactly what flash_attention.cu computes.  For query row i of head h and
// key j of KV head h / g (g = q_heads / kv_heads), with scale = 1/sqrt(d)
// rounded to float32 and the keys kept as the forward keeps them (j <
// kv_len, j <= i if causal, j > i - window if window > 0):
//
//   p_ij  = exp(s_ij - lse_i),  s_ij = (q_i . k_j) * scale,
//   lse_i = log sum_j exp(s_ij) over the kept keys (+inf for a row that
//           keeps none, so that its p is 0),
//   delta_i = sum_c do_ic o_ic,
//   ds_ij = p_ij ((do_i . v_j) - delta_i),
//   dv_j = sum_{h in group} sum_i p_ij do_i,
//   dk_j = scale sum_{h in group} sum_i ds_ij q_i,
//   dq_i = scale sum_j ds_ij k_j.
//
// The FlashAttention-2 split, with no float atomics: every sum is taken in
// a fixed order, so the same inputs give the same bits.  Both forms skip
// tiles that lie wholly outside the causal / window band or past kv_len
// (their p is 0).  Two forms, by dtype:
//
// bf16 (every training call): the tensor cores by wgmma, operands by TMA,
// in namespace hopper below, built from the forward's blocks (hopper.cuh).
// lse comes from the forward (flash_attention_wgmma writes it where the
// caller asks), so no product is spent on it: seven products, S and dP in
// both kernels and one each of dQ, dK, dV.  Every product takes its B
// operand from shared memory and the third one of each kernel its A from
// registers, as the forward's P V does; no P or dS goes through shared
// memory.
// - bwd_dq_wgmma: a block a (batch * q-head, 64-row query tile).  delta
//   of its rows from o and do in global memory (written out for the next
//   kernel), then over a ring of K/V tiles (128 keys at d <= 64, else
//   64): S = Q K^T and dP = dO V^T (SS), dS = p (dP - delta) in the
//   accumulators' registers, packed to bf16 in place as the A of dQ += dS
//   K (K read MN-major).
// - bwd_dkdv_wgmma: a block a work item (batch, kv head, 64-key tile,
//   chunk of the group's query heads); K and V stay in shared memory, Q,
//   dO, lse and delta of 64 query rows stream through the ring: S^T = K
//   Q^T and dP^T = V dO^T (SS), P^T and dS^T packed in place as the A of
//   dV += P^T dO and dK += dS^T Q (Q and dO read MN-major).  The wrapper
//   picks the chunk so that there are at least 4 x 132 items
//   (flash_attention.dkdv_heads_per_chunk): at internvl2-1b's training
//   shape 2 chunks (4 + 3 heads) of a 7-head group, 544 items; at
//   glm4-9b's 6 chunks of 3 heads (the last 1) of 16, 768; a whole group
//   where the items suffice (MHA).  A chunk's sum is in float32
//   registers; where the group is split, the chunks' sums go to float32
//   scratch and bwd_dkdv_sum adds them in chunk order, so dK and dV are
//   still rounded once.
// - A block is one warpgroup of 128 threads, two blocks an SM (up to 112
//   KB of shared memory each, a ring of 2 to 4 stages); its thread 0 takes
//   the block's item from a global count (the wrapper zeroes it), heaviest
//   first a group of heads at a time as the forward's items, and issues
//   every copy: the first stages at the start, each stage again once all
//   128 threads have arrived on its empty barrier.  No warp
//   specialisation: ptxas held the threads of a block of three
//   warpgroups (or two and a producer warp) to 168 registers even after
//   setmaxnreg, and a dK/dV block at d = 128 needs 235 (dK and dV 128, S^T
//   and dP^T 64); 128 threads may take 255.
// - Numerics as the forward's: p = 2^(s scale log2(e) - lse log2(e)) by
//   the SFU's ex2 (masked scores at -inf, lse +inf for a row that keeps no
//   key: p = 0 exactly); P (for dV) and dS (for dK, dQ) are rounded to
//   bf16 as operands, which ref.attention_bwd_rounding_bound bounds.
// Left for later: a single pass with dQ summed in order across the dK/dV
// blocks (ordered semaphores, FlashAttention-3's split without its
// atomics), the next stage's S^T issued under this stage's dK / dV
// products, a producer warp once ptxas lets consumers hold more than 168
// registers, and a persistent form whose next item's loads run under
// this item's epilogue.
//
// float32 (check paths only): the CUDA cores, in two kernels of the same
// split, three products each way, and lse computed again unless the
// caller gives it.
// - bwd_dq: one block a (batch * q-head, 64-row query tile).  It first
//   computes delta and, unless the caller gave it, lse (a pass over the
//   key tiles with S = Q K^T and the online max and sum), writes both to
//   global memory, then takes each 64-key tile again: S = Q K^T, dP = dO
//   V^T, dS into shared memory, dQ += dS K.
// - bwd_dkdv: one block a (batch * kv-head, 64-key tile).  K and V stay in
//   shared memory; the block loops over the g query heads of the group
//   and, in each, over the 32-row query tiles that the mask lets reach its
//   keys: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T into shared memory,
//   dV += P^T dO, dK += dS^T Q.  The group's sum is in the block's float32
//   registers, so dK and dV are rounded once.
// Every product reads both operands from shared memory through one
// helper, Tile<float, N>::mma, given the element strides of A and B, so
// the transposes are strides and nothing is transposed in memory: fmaf in
// k order; thread t holds rows t / 8 + 16 i and columns t % 8 + 8 j of the
// result.  P and dS stay float32.  Rows in shared memory are padded by 16
// bytes, so the 8 rows that a fragment load touches fall on distinct
// banks.
//
// What bounds it on the H100: operations.  The unmasked (query, key) pairs
// need five products of 2d operations each (the forward's two and
// S = Q K^T, dP = dO V^T, and one of dQ, dK, dV each beyond them): 2.5
// times the forward, 0.35 ms at glm4-9b's training shape (q 1 x 32 x 4096
// x 128, k/v 1 x 2 x 4096 x 128, causal) and 0.17 ms at internvl2-1b's (q
// 2 x 14 x 4352 x 64, k/v 2 x 2 x 4352 x 64) at the tensor cores' 989
// TFLOP/s.  The bf16 form does seven (S and dP twice); PERF.md has its
// times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a block owns: queries (dq), keys (dkdv)
constexpr int kKTile = 64;     // keys a step of bwd_dq
constexpr int kQTile = 32;     // queries a step of bwd_dkdv

// A 64 x N float32 tile of a product, C += A B, A (64 x K) and B (K x N)
// in shared memory: A(m, k) = a[m * SAM + k * SAK], B(k, n) = b[k * SBK +
// n * SBN].  v[i] is the element (row(i), col(i)) held by this thread.
template <typename T, int N>
struct Tile;

template <int N>
struct Tile<float, N> {
  static constexpr int kCols = N / 8;
  static constexpr int kSize = 4 * kCols;
  float v[kSize];

  __device__ __forceinline__ int row(int i) const {
    return threadIdx.x / 8 + 16 * (i / kCols);
  }
  __device__ __forceinline__ int col(int i) const {
    return threadIdx.x % 8 + 8 * (i % kCols);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kSize; ++i) v[i] = 0.f;
  }
  template <int K, int SAM, int SAK, int SBK, int SBN>
  __device__ __forceinline__ void mma(const float* a, const float* b) {
    const float* ar = a + (threadIdx.x / 8) * SAM;
    const float* bc = b + (threadIdx.x % 8) * SBN;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[4], bv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = ar[16 * i * SAM + k * SAK];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bv[j] = bc[8 * j * SBN + k * SBK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          v[i * kCols + j] = fmaf(av[i], bv[j], v[i * kCols + j]);
    }
  }
};

// rows x D contiguous elements of global memory -> rows of shared memory
// with stride LD, 16 bytes a thread a step.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
  }
}

__device__ __forceinline__ bool kept(int i, int j, int kv_len, int causal,
                                     int window) {
  return j < kv_len && (!causal || j <= i) && (window <= 0 || j > i - window);
}

template <typename T, int D>
struct DqSmem {
  // rows padded by 16 bytes
  static constexpr int kLd = D + 4;        // Q, dO, K, V rows
  static constexpr int kLdS = kKTile + 4;  // dS rows
  static constexpr int kLdF = kKTile + 4;              // float score rows
  static constexpr size_t kBytes =
      sizeof(T) * (2 * kRows * kLd + 2 * kKTile * kLd + kRows * kLdS) +
      sizeof(float) * (kRows * kLdF + 2 * kRows);
};

template <typename T, int D>
struct DkdvSmem {
  // rows padded by 16 bytes
  static constexpr int kLd = D + 4;        // K, V, Q, dO rows
  static constexpr int kLdP = kQTile + 4;  // P^T, dS^T rows
  static constexpr size_t kBytes =
      sizeof(T) * (2 * kRows * kLd + 2 * kQTile * kLd + 2 * kRows * kLdP) +
      sizeof(float) * 2 * kQTile;
};

// lse and delta: (batch * q_heads, sq) float32 each.  With have_lse the
// caller's lse is read and the pass that computes it is skipped.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ o,
       const T* __restrict__ dout, float* __restrict__ lse_g,
       float* __restrict__ delta_g, T* __restrict__ dq, int q_heads,
       int kv_heads, int sq, int sk, int kv_len, float scale, int causal,
       int window, int have_lse) {
  using S = DqSmem<T, D>;
  constexpr int LD = S::kLd, LDS = S::kLdS, LDF = S::kLdF;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kRows * LD;
  T* ks = dos + kRows * LD;
  T* vs = ks + kKTile * LD;
  T* dss = vs + kKTile * LD;
  float* sf = reinterpret_cast<float*>(dss + kRows * LDS);
  float* lse = sf + kRows * LDF;
  float* delta = lse + kRows;

  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;  // batch * q_heads + head
  const int b = bh / q_heads, h = bh % q_heads;
  const int hk = h / (q_heads / kv_heads);
  const size_t row0 = static_cast<size_t>(bh) * sq + q0;
  const T* kb = k + (static_cast<size_t>(b) * kv_heads + hk) * sk * D;
  const T* vb = v + (static_cast<size_t>(b) * kv_heads + hk) * sk * D;

  int k_lo = 0, k_hi = min(sk, kv_len);
  if (causal) k_hi = min(k_hi, q0 + kRows);
  if (window > 0) k_lo = max(0, q0 - window + 1) / kKTile * kKTile;

  stage<T, D, LD>(qs, q + row0 * D, kRows);
  stage<T, D, LD>(dos, dout + row0 * D, kRows);
  __syncthreads();

  // two adjacent threads a row, each half of its columns
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  {
    const T* orow = o + (row0 + r) * D;
    float acc = 0.f;
    for (int c = half; c < D; c += 2)
      acc = fmaf(dos[r * LD + c], orow[c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta[r] = acc;
      delta_g[row0 + r] = acc;
    }
  }

  if (have_lse) {
    if (half == 0) lse[r] = lse_g[row0 + r];
  } else {
    // lse by the online max and sum over the key tiles
    float m = -INFINITY, l = 0.f;
    for (int j0 = k_lo; j0 < k_hi; j0 += kKTile) {
      stage<T, D, LD>(ks, kb + static_cast<size_t>(j0) * D, kKTile);
      __syncthreads();
      Tile<T, kKTile> s;
      s.zero();
      s.template mma<D, LD, 1, 1, LD>(qs, ks);
#pragma unroll
      for (int i = 0; i < Tile<T, kKTile>::kSize; ++i) {
        const int qi = q0 + s.row(i), kj = j0 + s.col(i);
        sf[s.row(i) * LDF + s.col(i)] =
            kept(qi, kj, kv_len, causal, window) ? s.v[i] * scale : -INFINITY;
      }
      __syncthreads();
      float mx = -INFINITY;
      for (int c = half; c < kKTile; c += 2) mx = fmaxf(mx, sf[r * LDF + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = half; c < kKTile; c += 2) sum += __expf(sf[r * LDF + c] - base);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * __expf(m - base) + sum;
      m = m_new;
      __syncthreads();  // ks and sf are written again
    }
    if (half == 0) {
      lse[r] = l > 0.f ? m + logf(l) : INFINITY;
      lse_g[row0 + r] = lse[r];
    }
  }
  __syncthreads();

  Tile<T, D> dqa;
  dqa.zero();
  for (int j0 = k_lo; j0 < k_hi; j0 += kKTile) {
    stage<T, D, LD>(ks, kb + static_cast<size_t>(j0) * D, kKTile);
    stage<T, D, LD>(vs, vb + static_cast<size_t>(j0) * D, kKTile);
    __syncthreads();
    Tile<T, kKTile> s, dp;
    s.zero();
    dp.zero();
    s.template mma<D, LD, 1, 1, LD>(qs, ks);    // S = Q K^T
    dp.template mma<D, LD, 1, 1, LD>(dos, vs);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < Tile<T, kKTile>::kSize; ++i) {
      const int row = s.row(i), col = s.col(i);
      const float p = kept(q0 + row, j0 + col, kv_len, causal, window)
                          ? __expf(s.v[i] * scale - lse[row])
                          : 0.f;
      dss[row * LDS + col] = p * (dp.v[i] - delta[row]);
    }
    __syncthreads();
    dqa.template mma<kKTile, LDS, 1, LD, 1>(dss, ks);  // dQ += dS K
    __syncthreads();  // ks, vs and dss are written again
  }
  T* out = dq + row0 * D;
#pragma unroll
  for (int i = 0; i < Tile<T, D>::kSize; ++i)
    out[dqa.row(i) * D + dqa.col(i)] = dqa.v[i] * scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse_g, const float* __restrict__ delta_g,
         T* __restrict__ dk, T* __restrict__ dv, int q_heads, int kv_heads,
         int sq, int sk, int kv_len, float scale, int causal, int window) {
  using S = DkdvSmem<T, D>;
  constexpr int LD = S::kLd, LDP = S::kLdP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kRows * LD;
  T* qs = vs + kRows * LD;
  T* dos = qs + kQTile * LD;
  T* ps = dos + kQTile * LD;
  T* dss = ps + kRows * LDP;
  float* lse = reinterpret_cast<float*>(dss + kRows * LDP);
  float* delta = lse + kQTile;

  const int j0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;  // batch * kv_heads + kv head
  const int b = bh / kv_heads, hk = bh % kv_heads;
  const int g = q_heads / kv_heads;
  const size_t key0 = static_cast<size_t>(bh) * sk + j0;

  Tile<T, D> dka, dva;
  dka.zero();
  dva.zero();
  if (j0 < kv_len) {
    stage<T, D, LD>(ks, k + key0 * D, kRows);
    stage<T, D, LD>(vs, v + key0 * D, kRows);
    int q_lo = causal ? j0 : 0, q_hi = sq;
    if (window > 0) q_hi = min(sq, j0 + kRows - 1 + window);
    q_lo = q_lo / kQTile * kQTile;
    for (int hh = 0; hh < g; ++hh) {
      const size_t qrow = (static_cast<size_t>(b) * q_heads + hk * g + hh) * sq;
      for (int i0 = q_lo; i0 < q_hi; i0 += kQTile) {
        __syncthreads();  // the last step's reads of qs, dos, ps, dss are done
        stage<T, D, LD>(qs, q + (qrow + i0) * D, kQTile);
        stage<T, D, LD>(dos, dout + (qrow + i0) * D, kQTile);
        if (threadIdx.x < kQTile) {
          lse[threadIdx.x] = lse_g[qrow + i0 + threadIdx.x];
          delta[threadIdx.x] = delta_g[qrow + i0 + threadIdx.x];
        }
        __syncthreads();
        Tile<T, kQTile> st, dpt;
        st.zero();
        dpt.zero();
        st.template mma<D, LD, 1, 1, LD>(ks, qs);    // S^T = K Q^T
        dpt.template mma<D, LD, 1, 1, LD>(vs, dos);  // dP^T = V dO^T
#pragma unroll
        for (int i = 0; i < Tile<T, kQTile>::kSize; ++i) {
          const int key = st.row(i), qq = st.col(i);
          const float p = kept(i0 + qq, j0 + key, kv_len, causal, window)
                              ? __expf(st.v[i] * scale - lse[qq])
                              : 0.f;
          ps[key * LDP + qq] = p;
          dss[key * LDP + qq] = p * (dpt.v[i] - delta[qq]);
        }
        __syncthreads();
        dva.template mma<kQTile, LDP, 1, LD, 1>(ps, dos);  // dV += P^T dO
        dka.template mma<kQTile, LDP, 1, LD, 1>(dss, qs);  // dK += dS^T Q
      }
    }
  }
  T* dko = dk + key0 * D;
  T* dvo = dv + key0 * D;
#pragma unroll
  for (int i = 0; i < Tile<T, D>::kSize; ++i) {
    dko[dka.row(i) * D + dka.col(i)] = dka.v[i] * scale;
    dvo[dva.row(i) * D + dva.col(i)] = dva.v[i];
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, float* lse, float* delta, void* dq, void* dk,
           void* dv, int batch, int q_heads, int kv_heads, int sq, int sk,
           int kv_len, float scale, int causal, int window, int have_lse,
           cudaStream_t stream) {
  const size_t dq_bytes = DqSmem<T, D>::kBytes;
  const size_t dkdv_bytes = DkdvSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, D><<<dim3(sq / kRows, batch * q_heads), kThreads, dq_bytes,
                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), q_heads,
      kv_heads, sq, sk, kv_len, scale, causal, window, have_lse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<T, D><<<dim3(sk / kRows, batch * kv_heads), kThreads, dkdv_bytes,
                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), q_heads, kv_heads, sq, sk,
      kv_len, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, float* lse, float* delta, void* dq, void* dk,
             void* dv, int batch, int q_heads, int kv_heads, int sq, int sk,
             int kv_len, int d, float scale, int causal, int window,
             int have_lse, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_CASE(DIM)                                                \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, \
                          q_heads, kv_heads, sq, sk, kv_len, scale, causal, \
                          window, have_lse, s);
  switch (d) {
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(80)
    REPRO_BWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD_CASE
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// bf16 on Hopper: wgmma on the tensor cores, TMA rings, warp-specialised.
// ---------------------------------------------------------------------------
namespace hopper {

// A block is one consumer warpgroup, whose thread 0 also issues the
// copies, and two blocks share an SM.  ptxas held every thread of a block
// of two consumer warpgroups and a producer (384 threads, or 288 with a
// producer warp) to 168 registers, setmaxnreg or not: too few for dK and
// dV at d = 128 beside S^T and dP^T, which take 235 (PERF.md).  A block
// of 128 threads, two an SM, gets up to 255.
constexpr int kThreads = 128;
constexpr int kRows = 64;          // rows a block: queries (dQ), keys (dK/dV)
constexpr int kSmemBudget = 112 * 1024;   // shared memory a block: two fit
constexpr float kLog2e = 1.4426950408889634f;

// Stages of a ring whose stage is ``stage`` bytes beside ``fixed`` bytes,
// two to four as the budget allows.
constexpr int stages(int fixed, int stage) {
  return (kSmemBudget - fixed) / stage < 2   ? 2
         : (kSmemBudget - fixed) / stage > 4 ? 4
                                             : (kSmemBudget - fixed) / stage;
}

// bwd_dq_wgmma's shared memory: Q and dO of the block's 64 rows, a ring
// of K/V tiles of kKeys keys: 128 where S and dP fit the registers beside
// dQ (d <= 64), else 64.  Then full and empty a stage, Q and dO's full,
// the item; 1024 bytes of slack to align the tiles to the swizzle.
template <int D>
struct DqSmem {
  using L = Layout<D>;
  static constexpr int kKeys = D <= 64 ? 128 : 64;
  static constexpr int kQBytes = L::bytes(kRows);     // Q or dO
  static constexpr int kTileBytes = L::bytes(kKeys);  // K or V a stage
  static constexpr int kStages = stages(1024 + 2 * kQBytes, 2 * kTileBytes);
  static constexpr int kBytes =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 8 * (2 * kStages + 2);
};

// bwd_dkdv_wgmma's: K and V of the block's 64 keys, a ring of Q, dO, lse
// and delta of 64 query rows, the barriers and the item.
template <int D>
struct DkdvSmem {
  using L = Layout<D>;
  static constexpr int kKBytes = L::bytes(kRows);   // K or V
  static constexpr int kQBytes = L::bytes(kRows);   // Q or dO a stage
  static constexpr int kStatBytes = 4 * kRows;      // lse or delta a stage
  static constexpr int kStages =
      stages(1024 + 2 * kKBytes, 2 * kQBytes + 2 * kStatBytes);
  static constexpr int kBytes = 1024 + 2 * kKBytes + 2 * kStages * kQBytes
                                + 2 * kStages * kStatBytes
                                + 8 * (2 * kStages + 2);
};

// sum_c a_c b_c over 8 bf16 pairs, in order, into acc.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

// Thread 0 takes the block's work item from the global count (heaviest
// first: the blocks start in any order, the items are taken in order) and
// sets up the barriers: a full (one arrival and the copies' bytes) and an
// empty one (every thread) a stage, then one more full one.
template <int kStages>
__device__ __forceinline__ void start_block(uint32_t bars, uint32_t s_item,
                                            int* next_item) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(bars + 8 * st, 1);
      bar_init(bars + 8 * (kStages + st), kThreads);
    }
    bar_init(bars + 16 * kStages, 1);
    st_shared(s_item, atomicAdd(next_item, 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Thread 0, once every thread has arrived on the stage's empty barrier
// (its use ``use`` of the ring), may load it again: the generic reads of
// the stage before the async proxy's writes.
__device__ __forceinline__ void wait_empty(uint32_t empty, int use) {
  bar_wait(empty, use & 1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A dQ work item: a (batch * q-head, 64-row query tile), and the band of
// K/V tiles that hold a kept key for some row of it (none at or past
// kv_len; none at all where a window starts past kv_len).  Items are
// numbered as the forward's: a group of heads at a time, heaviest first
// within a group (every head's last query tile, then the tile before).
struct DqWork {
  int bh;        // batch * q_heads + head
  int q0;        // first query row
  int kv_row;    // row of the band's first K/V tile in the K/V maps
  int k_begin;   // its first key
  int n_tiles;   // K/V tiles in the band
};

template <int kKeys>
__device__ __forceinline__ DqWork dq_work(int item, int heads, int group,
                                          int q_heads, int kv_heads, int sq,
                                          int sk, int kv_len, int causal,
                                          int window) {
  DqWork w;
  const int n_q = sq / kRows;
  const int first = item / (group * n_q) * group;
  const int rest = item - first * n_q;
  const int in_group = min(group, heads - first);
  w.bh = first + rest % in_group;
  w.q0 = (n_q - 1 - rest / in_group) * kRows;
  const int b = w.bh / q_heads;
  const int kvh = b * kv_heads + (w.bh - b * q_heads) / (q_heads / kv_heads);
  int k_end = kv_len;
  w.k_begin = 0;
  if (causal) k_end = min(kv_len, w.q0 + kRows);
  if (window > 0) w.k_begin = max(0, w.q0 - window + 1) / kKeys * kKeys;
  w.n_tiles = max(0, (k_end - w.k_begin + kKeys - 1) / kKeys);
  w.kv_row = kvh * sk + w.k_begin;
  return w;
}

// dQ = scale sum_j dS_ij k_j for a 64-row query tile, and delta_i =
// sum_c do_ic o_ic of its rows (written for bwd_dkdv_wgmma).  Thread 0
// loads Q and dO once and keeps the ring of K/V tiles full.  A tile: S =
// Q K^T and dP = dO V^T (SS, both K-major), p = 2^(S scale log2(e) - lse
// log2(e)) and dS = p (dP - delta) in the accumulators' registers, dS
// rounded to bf16 in place as the A operand of dQ += dS K (RS, K read
// MN-major).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             bf16* __restrict__ dq, int* __restrict__ next_item, int heads,
             int group, int q_heads, int kv_heads, int sq, int sk, int kv_len,
             float scale, float scale_log2, int causal, int window) {
  using L = Layout<D>;
  using S = DqSmem<D>;
  constexpr int kSw = L::kSwizzle;
  constexpr int kKeys = S::kKeys;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t s_q =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u)
      & ~1023u;                                        // [chunk][64 rows]
  const uint32_t s_do = s_q + S::kQBytes;
  const uint32_t s_k = s_do + S::kQBytes;              // [stage][chunk][rows]
  const uint32_t s_v = s_k + kStages * S::kTileBytes;
  const uint32_t bars = s_v + kStages * S::kTileBytes;
  const uint32_t qd_full = bars + 16 * kStages;        // Q and dO landed
  const uint32_t s_item = qd_full + 8;
  start_block<kStages>(bars, s_item, next_item);
  const DqWork w = dq_work<kKeys>(ld_shared(s_item), heads, group, q_heads,
                                  kv_heads, sq, sk, kv_len, causal, window);
  // K/V tile t of the band into its stage
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    const uint32_t full = bars + 8 * st;
    bar_expect_tx(full, 2 * S::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      const uint32_t off = st * S::kTileBytes + c * kKeys * kSw;
      tma_load(s_k + off, &tk, full, c * L::kChunkCols, w.kv_row + t * kKeys);
      tma_load(s_v + off, &tv, full, c * L::kChunkCols, w.kv_row + t * kKeys);
    }
  };
  if (threadIdx.x == 0 && w.n_tiles > 0) {
    bar_expect_tx(qd_full, 2 * S::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(s_q + c * kRows * kSw, &tq, qd_full, c * L::kChunkCols,
               w.bh * sq + w.q0);
      tma_load(s_do + c * kRows * kSw, &tdo, qd_full, c * L::kChunkCols,
               w.bh * sq + w.q0);
    }
    for (int t = 0; t < min(kStages, w.n_tiles); ++t) load_kv(t);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = w.q0 + 16 * warp + (lane >> 2);   // the thread's rows: r0,
                                                   // r0 + 8
  const int c0 = 2 * (lane & 3);                   // columns c0, c0 + 1
  const size_t row0 = static_cast<size_t>(w.bh) * sq + r0;

  // delta of rows r0 and r0 + 8: the 4 threads of a row take 16-byte
  // pieces c, c + 4, ... of it, then add their sums in a fixed order.
  float dl0 = 0.f, dl1 = 0.f;
  {
    const uint4* o0 = reinterpret_cast<const uint4*>(o + row0 * D);
    const uint4* g0 = reinterpret_cast<const uint4*>(dout + row0 * D);
    const uint4* o1 = o0 + D;   // 8 rows on: 8 D bf16 are D pieces
    const uint4* g1 = g0 + D;
    for (int c = lane & 3; c < D / 8; c += 4) {
      dl0 = dot8(g0[c], o0[c], dl0);
      dl1 = dot8(g1[c], o1[c], dl1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
    }
    if ((lane & 3) == 0) {
      delta[row0] = dl0;
      delta[row0 + 8] = dl1;
    }
  }
  // lse in the base-2 domain of the exponent: p = 2^(s scale log2(e) -
  // lse log2(e)) = e^(s scale - lse); +inf for a row that keeps no key
  const float ls0 = lse[row0] * kLog2e;
  const float ls1 = lse[row0 + 8] * kLog2e;

  float acc[L::kDPad / 2];
#pragma unroll
  for (int i = 0; i < L::kDPad / 2; ++i) acc[i] = 0.f;
  if (w.n_tiles > 0) {
    // Q and stage 0's K, K-major; dO and V lie a fixed distance from
    // them (descriptor units)
    const uint64_t dq_a = kmajor<kSw>(s_q);
    const uint64_t dk_b = kmajor<kSw>(s_k);
    constexpr int kTileDesc = S::kTileBytes >> 4;   // a stage
    constexpr int kToDo = S::kQBytes >> 4;          // Q -> dO
    constexpr int kToV = kStages * kTileDesc;       // K -> V
    bar_wait(qd_full, 0);
    for (int t = 0; t < w.n_tiles; ++t) {
      const int st = t % kStages;
      const int k0 = w.k_begin + t * kKeys;
      bar_wait(bars + 8 * st, (t / kStages) & 1);
      const uint64_t k_b = dk_b + st * kTileDesc;
      float s[kKeys / 2], dp[kKeys / 2];
      wgmma_fence();
      issue_ss<D, kKeys, kRows, kKeys>(s, dq_a, k_b);
      wgmma_commit();
      issue_ss<D, kKeys, kRows, kKeys>(dp, dq_a + kToDo, k_b + kToV);
      wgmma_commit();
      wgmma_wait<1>();                  // S has landed
      fence_regs(s);
      // the mask, only where the tile straddles the diagonal, the
      // window's lower edge or kv_len for some row of the block
      if ((causal && k0 + kKeys - 1 > w.q0)
          || (window > 0 && k0 <= w.q0 + kRows - 1 - window)
          || k0 + kKeys > kv_len) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + c0 + (i & 1);
          if (!kept(r0 + 8 * ((i >> 1) & 1), key, kv_len, causal, window))
            s[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i)
        s[i] = exp2_ftz(fmaf(s[i], scale_log2, (i & 2) ? -ls1 : -ls0));
      wgmma_wait<0>();                  // dP has landed
      fence_regs(dp);
      uint32_t ds[kKeys / 4];
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) {
        const float dl = (i & 1) ? dl1 : dl0;
        ds[i] = pack_bf16(s[2 * i] * (dp[2 * i] - dl),
                          s[2 * i + 1] * (dp[2 * i + 1] - dl));
      }
      wgmma_fence();
      issue_rs<D, kKeys>(acc, ds, as_mnmajor<kSw, kKeys>(k_b));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      bar_arrive(bars + 8 * (kStages + st));
      if (threadIdx.x == 0 && t + kStages < w.n_tiles) {
        wait_empty(bars + 8 * (kStages + st), t / kStages);
        load_kv(t + kStages);
      }
    }
  }
  // dq = scale acc in bf16, the first D columns
  bf16* q0p = dq + row0 * D + c0;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<uint32_t*>(q0p + 8 * c) =
        pack_bf16(acc[4 * c] * scale, acc[4 * c + 1] * scale);
    *reinterpret_cast<uint32_t*>(q0p + 8 * D + 8 * c) =
        pack_bf16(acc[4 * c + 2] * scale, acc[4 * c + 3] * scale);
  }
}

// A dK/dV work item: (batch, kv head, 64-key tile, chunk of the group's
// query heads) and the band of 64-row query tiles, in each head of the
// chunk, that the mask lets reach its keys (none where the key tile lies
// at or past kv_len).  Items are numbered a group of ``group`` (batch, kv
// head, chunk)s at a time, heaviest first within a group: every first key
// tile (under a causal mask the longest band), then every second, ...
struct DkdvWork {
  int bk;        // batch * kv_heads + kv head
  int j0;        // first key
  int chunk;     // the chunk of the group's heads
  int bh_first;  // batch * q_heads + the chunk's first head
  int h_count;   // heads in the chunk
  int q_lo;      // first query row of the band
  int n_qt;      // query tiles of the band, a head
};

__device__ __forceinline__ DkdvWork dkdv_work(int item, int combos, int group,
                                              int n_chunks, int hpc,
                                              int q_heads, int kv_heads,
                                              int sq, int sk, int kv_len,
                                              int causal, int window) {
  DkdvWork w;
  const int n_kt = sk / kRows;
  const int first = item / (group * n_kt) * group;
  const int rest = item - first * n_kt;
  const int in_group = min(group, combos - first);
  const int combo = first + rest % in_group;
  w.j0 = rest / in_group * kRows;
  w.bk = combo / n_chunks;
  w.chunk = combo - w.bk * n_chunks;
  const int b = w.bk / kv_heads;
  const int g = q_heads / kv_heads;
  w.bh_first = b * q_heads + (w.bk - b * kv_heads) * g + w.chunk * hpc;
  w.h_count = min(hpc, g - w.chunk * hpc);
  const int q_hi = window > 0 ? min(sq, w.j0 + kRows - 1 + window) : sq;
  w.q_lo = causal ? w.j0 : 0;
  w.n_qt = w.j0 < kv_len ? max(0, (q_hi - w.q_lo + kRows - 1) / kRows) : 0;
  return w;
}

// dK and dV of a 64-key tile over a chunk of its group's query heads.  K
// and V stay in shared memory; thread 0 streams Q, dO, lse and delta of
// 64 query rows a stage through the ring.  A stage: S^T = K Q^T and dP^T
// = V dO^T (SS, both K-major), P^T = 2^(S^T scale log2(e) - lse log2(e))
// and dS^T = P^T (dP^T - delta) rounded to bf16 in place as the A
// operands of dV += P^T dO and dK += dS^T Q (RS, dO and Q read MN-major).
// The chunk's sum is in float32 registers: rounded once to bf16 (dK times
// scale) where the chunk is the whole group, else written in float32 to
// the chunk's scratch for bwd_dkdv_sum (chunk_rows = batch * kv_heads *
// sk rows a chunk).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, float* __restrict__ dk_part,
               float* __restrict__ dv_part, int* __restrict__ next_item,
               int combos, int group, int n_chunks, int hpc, int chunk_rows,
               int q_heads, int kv_heads, int sq, int sk, int kv_len,
               float scale, float scale_log2, int causal, int window) {
  using L = Layout<D>;
  using S = DkdvSmem<D>;
  constexpr int kSw = L::kSwizzle;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t s_k =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u)
      & ~1023u;                                        // [chunk][64 keys]
  const uint32_t s_v = s_k + S::kKBytes;
  const uint32_t s_q = s_v + S::kKBytes;               // [stage][chunk][rows]
  const uint32_t s_do = s_q + kStages * S::kQBytes;
  const uint32_t s_lse = s_do + kStages * S::kQBytes;  // [stage][64]
  const uint32_t s_delta = s_lse + kStages * S::kStatBytes;
  const uint32_t bars = s_delta + kStages * S::kStatBytes;
  const uint32_t kv_full = bars + 16 * kStages;        // K and V landed
  const uint32_t s_item = kv_full + 8;
  start_block<kStages>(bars, s_item, next_item);
  const DkdvWork w = dkdv_work(ld_shared(s_item), combos, group, n_chunks,
                               hpc, q_heads, kv_heads, sq, sk, kv_len,
                               causal, window);
  const int n_tiles = w.h_count * w.n_qt;
  // Q, dO, lse and delta of stage t (query tile t % n_qt of the chunk's
  // head t / n_qt) into its stage
  auto load_q = [&](int t) {
    const int st = t % kStages;
    const uint32_t full = bars + 8 * st;
    const int hh = t / w.n_qt;
    const int row =
        (w.bh_first + hh) * sq + w.q_lo + (t - hh * w.n_qt) * kRows;
    bar_expect_tx(full, 2 * S::kQBytes + 2 * S::kStatBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      const uint32_t off = st * S::kQBytes + c * kRows * kSw;
      tma_load(s_q + off, &tq, full, c * L::kChunkCols, row);
      tma_load(s_do + off, &tdo, full, c * L::kChunkCols, row);
    }
    bulk_load(s_lse + st * S::kStatBytes, lse + row, S::kStatBytes, full);
    bulk_load(s_delta + st * S::kStatBytes, delta + row, S::kStatBytes,
              full);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    bar_expect_tx(kv_full, 2 * S::kKBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      tma_load(s_k + c * kRows * kSw, &tk, kv_full, c * L::kChunkCols,
               w.bk * sk + w.j0);
      tma_load(s_v + c * kRows * kSw, &tv, kv_full, c * L::kChunkCols,
               w.bk * sk + w.j0);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_q(t);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kr0 = w.j0 + 16 * warp + (lane >> 2);   // the thread's keys:
                                                    // kr0, kr0 + 8
  const int c0 = 2 * (lane & 3);                    // its queries: c0 and
                                                    // c0 + 1 of each 8
  float dka[L::kDPad / 2], dva[L::kDPad / 2];
#pragma unroll
  for (int i = 0; i < L::kDPad / 2; ++i) dka[i] = dva[i] = 0.f;
  if (n_tiles > 0) {
    // K and stage 0's Q, K-major; V and dO lie a fixed distance from
    // them (descriptor units)
    const uint64_t dk_a = kmajor<kSw>(s_k);
    const uint64_t dq_b = kmajor<kSw>(s_q);
    constexpr int kQDesc = S::kQBytes >> 4;      // a stage
    constexpr int kToV = S::kKBytes >> 4;        // K -> V
    constexpr int kToDo = kStages * kQDesc;      // Q -> dO
    bar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int q0 = w.q_lo + (t % w.n_qt) * kRows;
      bar_wait(bars + 8 * st, (t / kStages) & 1);
      const uint64_t q_b = dq_b + st * kQDesc;
      float s[kRows / 2], dp[kRows / 2];
      wgmma_fence();
      issue_ss<D, kRows, kRows, kRows>(s, dk_a, q_b);
      wgmma_commit();
      issue_ss<D, kRows, kRows, kRows>(dp, dk_a + kToV, q_b + kToDo);
      wgmma_commit();
      wgmma_wait<1>();                  // S^T has landed
      fence_regs(s);
      // the mask, only where the stage straddles the diagonal, the
      // window's upper edge or kv_len for some key of the block
      if ((causal && q0 < w.j0 + kRows - 1)
          || (window > 0 && q0 + kRows - 1 >= w.j0 + window)
          || w.j0 + kRows > kv_len) {
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          const int query = q0 + 8 * (i >> 2) + c0 + (i & 1);
          if (!kept(query, kr0 + 8 * ((i >> 1) & 1), kv_len, causal, window))
            s[i] = -INFINITY;
        }
      }
      // p of the thread's queries 8j + c0 and 8j + c0 + 1
      const uint32_t lse_st = s_lse + st * S::kStatBytes + 4 * c0;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 l = ld_shared_f2(lse_st + 32 * j);
        const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
        s[4 * j] = exp2_ftz(fmaf(s[4 * j], scale_log2, -l0));
        s[4 * j + 1] = exp2_ftz(fmaf(s[4 * j + 1], scale_log2, -l1));
        s[4 * j + 2] = exp2_ftz(fmaf(s[4 * j + 2], scale_log2, -l0));
        s[4 * j + 3] = exp2_ftz(fmaf(s[4 * j + 3], scale_log2, -l1));
      }
      wgmma_wait<0>();                  // dP^T has landed
      fence_regs(dp);
      // P^T and dS^T = P^T (dP^T - delta) in bf16, in one pass, so that
      // each pair of s and dp dies as its two operands are made
      const uint32_t delta_st = s_delta + st * S::kStatBytes + 4 * c0;
      uint32_t pt[kRows / 4], dst[kRows / 4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 dl = ld_shared_f2(delta_st + 32 * j);
        pt[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pt[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        dst[2 * j] = pack_bf16(s[4 * j] * (dp[4 * j] - dl.x),
                               s[4 * j + 1] * (dp[4 * j + 1] - dl.y));
        dst[2 * j + 1] = pack_bf16(s[4 * j + 2] * (dp[4 * j + 2] - dl.x),
                                   s[4 * j + 3] * (dp[4 * j + 3] - dl.y));
      }
      wgmma_fence();
      issue_rs<D, kRows>(dva, pt, as_mnmajor<kSw, kRows>(q_b + kToDo));
      issue_rs<D, kRows>(dka, dst, as_mnmajor<kSw, kRows>(q_b));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      bar_arrive(bars + 8 * (kStages + st));
      if (threadIdx.x == 0 && t + kStages < n_tiles) {
        wait_empty(bars + 8 * (kStages + st), t / kStages);
        load_q(t + kStages);
      }
    }
  }
  // The first D columns of keys kr0 and kr0 + 8.
  const size_t key_row = static_cast<size_t>(w.bk) * sk + kr0;
  if (n_chunks == 1) {
    bf16* k0p = dk + key_row * D + c0;
    bf16* v0p = dv + key_row * D + c0;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(k0p + 8 * c) =
          pack_bf16(dka[4 * c] * scale, dka[4 * c + 1] * scale);
      *reinterpret_cast<uint32_t*>(k0p + 8 * D + 8 * c) =
          pack_bf16(dka[4 * c + 2] * scale, dka[4 * c + 3] * scale);
      *reinterpret_cast<uint32_t*>(v0p + 8 * c) =
          pack_bf16(dva[4 * c], dva[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(v0p + 8 * D + 8 * c) =
          pack_bf16(dva[4 * c + 2], dva[4 * c + 3]);
    }
  } else {
    // the chunk's float32 sums: [chunk][batch * kv_heads * sk][D]
    const size_t at =
        (static_cast<size_t>(w.chunk) * chunk_rows + key_row) * D + c0;
    float* k0p = dk_part + at;
    float* v0p = dv_part + at;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<float2*>(k0p + 8 * c) =
          make_float2(dka[4 * c], dka[4 * c + 1]);
      *reinterpret_cast<float2*>(k0p + 8 * D + 8 * c) =
          make_float2(dka[4 * c + 2], dka[4 * c + 3]);
      *reinterpret_cast<float2*>(v0p + 8 * c) =
          make_float2(dva[4 * c], dva[4 * c + 1]);
      *reinterpret_cast<float2*>(v0p + 8 * D + 8 * c) =
          make_float2(dva[4 * c + 2], dva[4 * c + 3]);
    }
  }
}

// dk = bf16(scale sum_c dk_part[c]), dv = bf16(sum_c dv_part[c]): the
// chunks' sums added in chunk order, each element rounded once.  n4: the
// elements of dk over 4.
__global__ void __launch_bounds__(256)
bwd_dkdv_sum(const float4* __restrict__ dk_part,
             const float4* __restrict__ dv_part, uint2* __restrict__ dk,
             uint2* __restrict__ dv, int n4, int chunks, float scale) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 a = dk_part[i], b = dv_part[i];
    for (int c = 1; c < chunks; ++c) {
      const float4 x = dk_part[static_cast<size_t>(c) * n4 + i];
      const float4 y = dv_part[static_cast<size_t>(c) * n4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
      b.x += y.x;
      b.y += y.y;
      b.z += y.z;
      b.w += y.w;
    }
    dk[i] = make_uint2(pack_bf16(a.x * scale, a.y * scale),
                       pack_bf16(a.z * scale, a.w * scale));
    dv[i] = make_uint2(pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
}

// Returns a cudaError_t, or -CUresult if a tensor map could not be built.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* dk_part, float* dv_part,
           int* next_items, int batch, int q_heads, int kv_heads, int sq,
           int sk, int kv_len, float scale, int causal, int window, int hpc,
           cudaStream_t stream) {
  const uint64_t q_rows = static_cast<uint64_t>(batch) * q_heads * sq;
  const uint64_t kv_rows = static_cast<uint64_t>(batch) * kv_heads * sk;
  // Q and dO by 64 rows (both kernels); K and V by the dQ kernel's tile
  // and by 64 rows (the dK/dV kernel's)
  CUtensorMap m[6];
  CUresult r = make_map<D>(&m[0], q, q_rows, kRows);
  if (r == CUDA_SUCCESS) r = make_map<D>(&m[1], dout, q_rows, kRows);
  if (r == CUDA_SUCCESS) r = make_map<D>(&m[2], k, kv_rows, DqSmem<D>::kKeys);
  if (r == CUDA_SUCCESS) r = make_map<D>(&m[3], v, kv_rows, DqSmem<D>::kKeys);
  if (r == CUDA_SUCCESS) r = make_map<D>(&m[4], k, kv_rows, kRows);
  if (r == CUDA_SUCCESS) r = make_map<D>(&m[5], v, kv_rows, kRows);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem<D>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvSmem<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms < 0) return -sms;
  // A block an item, the items taken in order from a count: a group of
  // about as many items as there fit blocks on the card at a time (two an
  // SM), whose blocks share the K/V, or the Q and dO, of a few heads in L2.
  const int heads = batch * q_heads;
  const int n_q = sq / kRows;
  const int dq_items = heads * n_q;
  bwd_dq_wgmma<D><<<dq_items, kThreads, DqSmem<D>::kBytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
      next_items, heads, max(1, min(dq_items, 2 * sms) / n_q), q_heads,
      kv_heads, sq, sk, kv_len, scale, scale * kLog2e, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = q_heads / kv_heads;
  const int n_chunks = (g + hpc - 1) / hpc;
  const int combos = batch * kv_heads * n_chunks;
  const int n_kt = sk / kRows;
  const int dkdv_items = combos * n_kt;
  bwd_dkdv_wgmma<D><<<dkdv_items, kThreads, DkdvSmem<D>::kBytes, stream>>>(
      m[0], m[1], m[4], m[5], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dk_part, dv_part, next_items + 1, combos,
      max(1, min(dkdv_items, 2 * sms) / n_kt), n_chunks, hpc,
      static_cast<int>(kv_rows), q_heads, kv_heads, sq, sk, kv_len, scale,
      scale * kLog2e, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const int n4 = static_cast<int>(kv_rows * D / 4);
  bwd_dkdv_sum<<<min((n4 + 255) / 256, 8 * sms), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dk_part),
      reinterpret_cast<const float4*>(dv_part), static_cast<uint2*>(dk),
      static_cast<uint2*>(dv), n4, n_chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

}  // namespace

// q, o, dout and dq (batch, q_heads, sq, d); k, v, dk and dv (batch,
// kv_heads, sk, d): contiguous and 16-byte aligned, all of one dtype.
// q_heads % kv_heads == 0; sq and sk multiples of 128; a causal or window
// mask only with sq == sk; 1 <= kv_len <= sk.  Each entry launches on
// ``stream`` and returns the first non-zero cudaGetLastError(), or
// cudaErrorInvalidValue, without a launch, for a head dim it was not
// built for.

// The float32 kernels (bwd_dq, then bwd_dkdv).  lse and delta: (batch,
// q_heads, sq) float32 scratch, written by the first kernel and read by
// the second; with have_lse, lse holds the forward's row log-sum-exp on
// entry.

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, float* lse, float* delta, void* dq, void* dk, void* dv,
    int batch, int q_heads, int kv_heads, int sq, int sk, int kv_len, int d,
    float scale, int causal, int window, int have_lse, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                         q_heads, kv_heads, sq, sk, kv_len, d, scale, causal,
                         window, have_lse, stream);
}

// The bf16 kernels (bwd_dq_wgmma, bwd_dkdv_wgmma and, where the group's
// heads are split, bwd_dkdv_sum).  lse: (batch, q_heads, sq) float32, the
// forward's rows' log-sum-exp; delta: the same shape, scratch written by
// the first kernel.  heads_per_chunk divides a group's query heads among
// the dK/dV work items; below the group, dk_part and dv_part are float32
// scratch of (ceil(group / heads_per_chunk), batch, kv_heads, sk, d),
// else unused.  next_items: two int32 of device memory, 0 at the call.
// A negative result is -CUresult of cuTensorMapEncodeTiled (no launch).
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* dk_part, float* dv_part, int* next_items, int batch,
    int q_heads, int kv_heads, int sq, int sk, int kv_len, int d,
    float scale, int causal, int window, int heads_per_chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define REPRO_BWD_CASE(DIM)                                                 \
  case DIM:                                                                 \
    return hopper::launch<DIM>(q, k, v, o, dout, lse, delta, dq, dk, dv,    \
                               dk_part, dv_part, next_items, batch, q_heads, \
                               kv_heads, sq, sk, kv_len, scale, causal,     \
                               window, heads_per_chunk, s);
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(80)
    REPRO_BWD_CASE(128)
#undef REPRO_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
