// Blockwise (flash) attention with GQA and causal / sliding-window masks,
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (kernel _flash_kernel).  For query row i of head h and key j of KV head
// h / g (g = q_heads / kv_heads), positions counted from 0 on both sides:
//
//   s_ij = (q_i . k_j) * scale,   scale = 1/sqrt(d) rounded to float32,
//   kept where (j <= i if causal) and (j > i - window if window > 0),
//
// and o_i = sum_j softmax_j(s_i) v_j, by the online softmax over tiles of
// keys with float32 m (running max, NEG_INF = -1e30 at the start), l (sum
// of exponentials) and acc (sum of p v).  A row that keeps no key has
// l == 0 and gets 0.  q, k and v are read as float32, or as bf16 widened
// to float32; o is written in q's dtype (bf16 rounded to nearest even).
//
// What bounds it on the H100: operations.  At the prefill shape of
// glm4-9b (q 2 x 32 x 4096 x 128, k/v 2 x 2 x 4096 x 128, causal) the
// unmasked (query, key) pairs need 4d = 512 float operations each, 275
// GFLOP, against 0.14 GB of q, k, v and o: 0.28 ms at the tensor cores'
// bf16 rate, 4.1 ms at the 67 TFLOP/s of float32 on the CUDA cores.
//
// Design.  This first kernel keeps the JAX kernel's float32 arithmetic on
// the CUDA cores: bf16 mma/wgmma would round p before the product with v.
// One block of 256 threads owns one (batch * q-head, 64-row query tile);
// the TPU grid's sequential KV axis becomes a loop inside the block over
// 64-key tiles, staged through shared memory.  GQA reads KV head h / g
// directly (no repeated K/V).  Per KV tile: S = Q K^T as a 4 x 4 register
// tile per thread (float4 reads along d, rows padded by 4 floats so a
// quarter-warp's reads hit distinct banks), the online-softmax update
// with the row max and row sum reduced across the 16 threads that share a
// row by warp shuffles (a butterfly, so every thread holds the same
// value), P written to shared memory, then acc += P V into a 4 x (4 * NC)
// register tile.  K and then V reuse one shared buffer, so two blocks fit
// on an SM.  KV tiles that lie wholly outside the causal / window band are
// skipped.  That is exact: such a tile has s = NEG_INF everywhere, so
// m_new = m_prev, alpha = exp(0) = 1 and p = 0, and m, l and acc are
// unchanged in the JAX kernel too.  Query tiles are walked heaviest first
// (blockIdx.y counts down the causal triangle), so the long tiles start in
// the first wave.  Tensor cores, TMA and pipelined loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows x D contiguous elements of global memory -> float32 rows of
// shared memory with stride Tile<D>::kLd.
template <int D, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int rows) {
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int q_heads,
             int kv_heads, int sq, int sk, float scale, int causal,
             int window) {
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
  const T* qb = q + (static_cast<size_t>(bh) * sq + q0) * D;
  const T* kb = k + static_cast<size_t>(kvh) * sk * D;
  const T* vb = v + static_cast<size_t>(kvh) * sk * D;

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

  // The band of KV tiles that hold a kept key for some row of this tile.
  int k_begin = 0;
  int k_end = sk;
  if (causal) k_end = min(sk, q0 + kBlockQ);
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
        keep[j] = (!causal || kpos <= qpos) &&
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
    T* orow = o + (static_cast<size_t>(bh) * sq + q0 + ty + 16 * i) * D;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 4 * (tx + 16 * c);
      if (col >= D) break;
      store4(orow + col, make_float4(acc[i][c][0] / safe, acc[i][c][1] / safe,
                                     acc[i][c][2] / safe, acc[i][c][3] / safe));
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int q_heads, int kv_heads, int sq, int sk,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmemBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(batch * q_heads, sq / kBlockQ);
  flash_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), q_heads, kv_heads, sq, sk,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int batch, int q_heads, int kv_heads, int sq,
                     int sk, float scale, int causal, int window,
                     cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, batch, q_heads, kv_heads, sq, sk,
                           scale, causal, window, stream);
    case 64:
      return launch<64, T>(q, k, v, o, batch, q_heads, kv_heads, sq, sk,
                           scale, causal, window, stream);
    case 80:
      return launch<80, T>(q, k, v, o, batch, q_heads, kv_heads, sq, sk,
                           scale, causal, window, stream);
    case 128:
      return launch<128, T>(q, k, v, o, batch, q_heads, kv_heads, sq, sk,
                            scale, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (batch, q_heads, sq, d), k and v (batch, kv_heads, sk, d), o like q:
// contiguous, all float32 (bf16 = 0) or all bf16 (bf16 = 1), 8-byte
// aligned.  d in {32, 64, 80, 128}; sq and sk multiples of 64 (the wrapper
// asks for 128, as the JAX kernel does); q_heads % kv_heads == 0.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue,
// without a launch, for a head dim it was not built for).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bf16, int batch, int q_heads,
                               int kv_heads, int sq, int sk, int d,
                               float scale, int causal, int window,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        d, q, k, v, o, batch, q_heads, kv_heads, sq, sk, scale, causal,
        window, s));
  return static_cast<int>(dispatch<float>(d, q, k, v, o, batch, q_heads,
                                          kv_heads, sq, sk, scale, causal,
                                          window, s));
}
