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
// The FlashAttention-2 split in two kernels, three products each way:
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
// Both skip tiles that lie wholly outside the causal / window band or
// past kv_len (their p is 0).  No float atomics: every sum is taken in a
// fixed order inside one block, so the same inputs give the same bits.
//
// Products.  Every product reads both operands from shared memory through
// one helper, Tile<T, N>::mma, given the element strides of A and B, so
// the transposes above are strides and nothing is transposed in memory.
// - bf16: mma.sync m16n8k16 (bf16 x bf16 -> float32) on the tensor cores;
//   each of the 4 warps owns 16 rows of the 64-row result.  A pair of
//   operand elements that lie next to each other along k is one 32-bit
//   shared load, else two 16-bit loads.  P (for dV) and dS (for dK, dQ) are
//   rounded to bf16 on their way into shared memory, as the forward rounds
//   P before its product with V; ref.attention_bwd_rounding_bound bounds
//   what that moves.
// - float32: the CUDA cores, fmaf in k order; thread t holds rows t / 8 +
//   16 i and columns t % 8 + 8 j of the result.  P and dS stay float32.
// Rows in shared memory are padded by 16 bytes, so the 8 rows that a
// fragment load touches fall on distinct banks.
//
// What bounds it on the H100: operations.  The unmasked (query, key) pairs
// need five products of 2d operations each (the forward's two and
// S = Q K^T, dP = dO V^T, and one of dQ, dK, dV each beyond them): 2.5
// times the forward, 0.35 ms at glm4-9b's training shape (q 1 x 32 x 4096
// x 128, k/v 1 x 2 x 4096 x 128, causal) at the tensor cores' 989 TFLOP/s.
// This design does eight (S and dP in both kernels, S again for lse) with
// mma.sync from shared memory and no pipelining of loads: a first kernel
// that is right, far from that bound (PERF.md has its times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a block owns: queries (dq), keys (dkdv)
constexpr int kKTile = 64;     // keys a step of bwd_dq
constexpr int kQTile = 32;     // queries a step of bwd_dkdv

template <typename T>
struct Pad;  // 16 bytes of padding a row, in elements
template <>
struct Pad<float> {
  static constexpr int value = 4;
};
template <>
struct Pad<bf16> {
  static constexpr int value = 8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// Two bf16 elements, p[0] and p[STRIDE], as the low and high halves of
// one operand register.
template <int STRIDE>
__device__ __forceinline__ uint32_t pair(const bf16* p) {
  if (STRIDE == 1) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + STRIDE);
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The tensor cores' fragment layout: warp w holds rows 16 w .. 16 w + 15;
// in n-tile t (8 columns) lane l holds rows l / 4 and l / 4 + 8 of them,
// columns 2 (l % 4) and 2 (l % 4) + 1.
template <int N>
struct Tile<bf16, N> {
  static constexpr int kTiles = N / 8;
  static constexpr int kSize = 4 * kTiles;
  float v[kSize];

  __device__ __forceinline__ int row(int i) const {
    return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i % 4) / 2);
  }
  __device__ __forceinline__ int col(int i) const {
    return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i % 2);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kSize; ++i) v[i] = 0.f;
  }
  template <int K, int SAM, int SAK, int SBK, int SBN>
  __device__ __forceinline__ void mma(const bf16* a, const bf16* b) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bf16* ar = a + (16 * (threadIdx.x / 32) + g) * SAM + 2 * t * SAK;
    const bf16* bc = b + g * SBN + 2 * t * SBK;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const uint32_t a0 = pair<SAK>(ar + k0 * SAK);
      const uint32_t a1 = pair<SAK>(ar + 8 * SAM + k0 * SAK);
      const uint32_t a2 = pair<SAK>(ar + (k0 + 8) * SAK);
      const uint32_t a3 = pair<SAK>(ar + 8 * SAM + (k0 + 8) * SAK);
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        const bf16* bn = bc + 8 * n * SBN;
        mma16816(v + 4 * n, a0, a1, a2, a3, pair<SBK>(bn + k0 * SBK),
                 pair<SBK>(bn + (k0 + 8) * SBK));
      }
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
  static constexpr int kLd = D + Pad<T>::value;        // Q, dO, K, V rows
  static constexpr int kLdS = kKTile + Pad<T>::value;  // dS rows
  static constexpr int kLdF = kKTile + 4;              // float score rows
  static constexpr size_t kBytes =
      sizeof(T) * (2 * kRows * kLd + 2 * kKTile * kLd + kRows * kLdS) +
      sizeof(float) * (kRows * kLdF + 2 * kRows);
};

template <typename T, int D>
struct DkdvSmem {
  static constexpr int kLd = D + Pad<T>::value;        // K, V, Q, dO rows
  static constexpr int kLdP = kQTile + Pad<T>::value;  // P^T, dS^T rows
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
      acc = fmaf(to_float(dos[r * LD + c]), to_float(orow[c]), acc);
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
      dss[row * LDS + col] = from_float<T>(p * (dp.v[i] - delta[row]));
    }
    __syncthreads();
    dqa.template mma<kKTile, LDS, 1, LD, 1>(dss, ks);  // dQ += dS K
    __syncthreads();  // ks, vs and dss are written again
  }
  T* out = dq + row0 * D;
#pragma unroll
  for (int i = 0; i < Tile<T, D>::kSize; ++i)
    out[dqa.row(i) * D + dqa.col(i)] = from_float<T>(dqa.v[i] * scale);
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
          ps[key * LDP + qq] = from_float<T>(p);
          dss[key * LDP + qq] = from_float<T>(p * (dpt.v[i] - delta[qq]));
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
    dko[dka.row(i) * D + dka.col(i)] = from_float<T>(dka.v[i] * scale);
    dvo[dva.row(i) * D + dva.col(i)] = from_float<T>(dva.v[i]);
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

// q, o, dout and dq (batch, q_heads, sq, d); k, v, dk and dv (batch,
// kv_heads, sk, d): contiguous and 16-byte aligned, all of one dtype.
// lse and delta: (batch, q_heads, sq) float32 scratch, written by the
// first kernel and read by the second; with have_lse, lse holds the
// forward's row log-sum-exp on entry.  q_heads % kv_heads == 0; sq and sk
// multiples of 128; a causal or window mask only with sq == sk; 1 <=
// kv_len <= sk.  Two launches on ``stream``; each returns the first
// non-zero cudaGetLastError(), or cudaErrorInvalidValue, without a launch,
// for a head dim it was not built for.

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, float* lse, float* delta, void* dq, void* dk, void* dv,
    int batch, int q_heads, int kv_heads, int sq, int sk, int kv_len, int d,
    float scale, int causal, int window, int have_lse, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                         q_heads, kv_heads, sq, sk, kv_len, d, scale, causal,
                         window, have_lse, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, float* lse, float* delta, void* dq, void* dk, void* dv,
    int batch, int q_heads, int kv_heads, int sq, int sk, int kv_len, int d,
    float scale, int causal, int window, int have_lse, void* stream) {
  return dispatch<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                        q_heads, kv_heads, sq, sk, kv_len, d, scale, causal,
                        window, have_lse, stream);
}
