// Building blocks of the Hopper (sm_90a) attention kernels, shared by
// flash_attention.cu (the forward) and flash_attention_bwd.cu (the
// backward): the swizzled shared-memory layout of a tile, the mbarrier and
// TMA helpers, wgmma's descriptors and its products with A from shared
// memory (SS) or from registers (RS), and the host's tensor-map encoding.
// Each source includes it into its own library; nothing here is a kernel.
//
// Products.  D = A B, A (64 x K) and B (K x N), bf16 x bf16 -> float32 in
// registers.  A tile in shared memory is [chunk][rows][chunk columns], the
// chunks of one swizzle span each (Layout<D>), so:
// - a K-major operand (rows along M or N, d along K: Q, dO, K or V as
//   stored) steps along d 32 bytes at a time inside a chunk and a chunk
//   (rows x kSwizzle bytes) at a time across chunks (kmajor_offset);
// - an MN-major operand (rows along K, d along N: K, V, Q or dO as the B
//   of a product over their rows) is read through the transpose bit, 16
//   rows a k16 step; its column chunks lie ``rows`` rows apart (the
//   descriptor's leading byte offset).
// The accumulator of a 64 x N product holds, per thread, element 4j + e
// at (row r0 + 8 (e >> 1), column 8j + c0 + (e & 1)), r0 = 16 warp + lane
// / 4, c0 = 2 (lane % 4): exactly the A fragments of a product over its N
// columns, so a result packed to bf16 in place (pack_bf16 over element
// pairs) is the register A operand of the next product.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {
namespace hopper {

template <int D>
struct Layout {
  // Bytes of a swizzled shared-memory row; a TMA box is one column chunk
  // of that many bytes across all rows of the tile, chunks one after the
  // other.  The swizzle repeats every 8 rows (8 * kSwizzle bytes).  A
  // head dim that is no multiple of the chunk ends in a part chunk, whose
  // columns past d TMA fills with zeros: kDPad columns in shared memory.
  static constexpr int kSwizzle = D % 64 == 0 ? 128 : 64;
  static constexpr int kChunkCols = kSwizzle / 2;
  static constexpr int kChunks = (D + kChunkCols - 1) / kChunkCols;
  static constexpr int kDPad = kChunks * kChunkCols;
  static constexpr int kStepsPerChunk = kSwizzle / 32;  // k16 steps a chunk
  // bytes of a tile of ``rows`` rows
  static constexpr int bytes(int rows) { return rows * kDPad * 2; }
};

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void st_shared(uint32_t addr, int v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Returns once the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void bar_spin(uint32_t bar, uint32_t parity) {
  while (!bar_try_wait(bar, parity)) {
  }
}

// The same, but a wait of more than 4 s can only be a broken pipeline:
// it traps, so the launch fails (the wrapper's next synchronise reports
// it) instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// One box of ``map`` at (column c0, row c1) into shared memory at ``dst``;
// the bytes count against ``bar``'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// ``bytes`` contiguous bytes of global memory (a multiple of 16, both
// addresses 16-byte aligned) into shared memory at ``dst``, counted
// against ``bar`` as tma_load counts a box.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1 = 128 B, 2 = 64 B).
template <int kSwizzle>
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  constexpr uint64_t mode = kSwizzle == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (mode << 62);
}

// A K-major operand: K along d, rows along M or N (the leading offset
// unused); 8-row groups 8 rows apart.
template <int kSwizzle>
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return descriptor<kSwizzle>(addr, 16, 8 * kSwizzle);
}

// The MN-major descriptor of the B operand of kRows rows along K whose
// K-major descriptor is ``d``: its column chunks lie kRows rows apart
// (the leading byte offset, 16 bytes in ``d``); the rest is the same.
template <int kSwizzle, int kRows>
__device__ __forceinline__ uint64_t as_mnmajor(uint64_t d) {
  return d + (static_cast<uint64_t>((kRows * kSwizzle >> 4) - 1) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC32(i) ACC16(i), ACC16(i + 16)
#define REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REGS48                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47}"
#define REGS64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// The wgmma wrappers take a descriptor of the tile and the k16 step's
// offset into it (16-byte units) as an immediate, and add the two inside
// the asm: only the tiles' descriptors stay live, not one per step.

// d (64 x N, f32) = A B (+ d if accumulate): A and B from shared memory,
// both K-major.
template <int N, int kOffA, int kOffB>
struct MmaSs;

template <int kOffA, int kOffB>
struct MmaSs<64, kOffA, kOffB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "add.s64 da, %32, %35;\n"
        "add.s64 db, %33, %36;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", da, db, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC32(0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
  }
};

template <int kOffA, int kOffB>
struct MmaSs<128, kOffA, kOffB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "add.s64 da, %64, %67;\n"
        "add.s64 db, %65, %68;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", da, db, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC32(0), ACC32(32)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kOffA), "n"(kOffB));
  }
};

// d (64 x N, f32) += A B: A (64 x 16, bf16) from registers, B from shared
// memory, MN-major (the transpose bit).
template <int N, int kOffB>
struct MmaRs;

template <int kOffB>
struct MmaRs<32, kOffB> {
  __device__ __forceinline__ static void run(float (&d)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "add.s64 db, %20, %22;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
        ", {%16, %17, %18, %19}, db, p, 1, 1, 1;\n"
        "}\n"
        : ACC16(0)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1), "n"(kOffB));
  }
};

template <int kOffB>
struct MmaRs<64, kOffB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "add.s64 db, %36, %38;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n"
        "}\n"
        : ACC32(0)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1), "n"(kOffB));
  }
};

template <int kOffB>
struct MmaRs<96, kOffB> {
  __device__ __forceinline__ static void run(float (&d)[48], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "add.s64 db, %52, %54;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " REGS48
        ", {%48, %49, %50, %51}, db, p, 1, 1, 1;\n"
        "}\n"
        : ACC32(0), ACC16(32)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1), "n"(kOffB));
  }
};

template <int kOffB>
struct MmaRs<128, kOffB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "add.s64 db, %68, %70;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", {%64, %65, %66, %67}, db, p, 1, 1, 1;\n"
        "}\n"
        : ACC32(0), ACC32(32)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1), "n"(kOffB));
  }
};

#undef ACC4
#undef ACC16
#undef ACC32
#undef REGS16
#undef REGS32
#undef REGS48
#undef REGS64

// The offset (16-byte units) of k16 step ``kk`` into a K-major tile of
// ``rows`` rows: 32 bytes into a chunk's rows, chunk after chunk.
template <int D>
__host__ __device__ constexpr int kmajor_offset(int kk, int rows) {
  using L = Layout<D>;
  return ((kk / L::kStepsPerChunk) * rows * L::kSwizzle
          + (kk % L::kStepsPerChunk) * 32) / 16;
}

// d (64 x N) = A B^T over d in D / 16 k16 steps (at d = 80 five, which
// never read the zero columns): A a K-major tile of kRowsA rows (its
// descriptor points at the warpgroup's 64), B one of kRowsB = N rows.
template <int D, int N, int kRowsA, int kRowsB, int... kK>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b,
                                         std::integer_sequence<int, kK...>) {
  (MmaSs<N, kmajor_offset<D>(kK, kRowsA), kmajor_offset<D>(kK, kRowsB)>::run(
       d, a, b, kK > 0),
   ...);
}

template <int D, int N, int kRowsA, int kRowsB>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b) {
  issue_ss<D, N, kRowsA, kRowsB>(d, a, b,
                                 std::make_integer_sequence<int, D / 16>{});
}

// acc (64 x kDPad) += A B over K rows of B: A packed
// bf16 in registers (k16 step kk reads a[4kk .. 4kk + 3]), B an MN-major
// tile (16 rows a step: kSwizzle in the descriptor's 16-byte units).
template <int D, int K, int... kK>
__device__ __forceinline__ void issue_rs(float (&acc)[Layout<D>::kDPad / 2],
                                         const uint32_t (&a)[K / 4],
                                         uint64_t b,
                                         std::integer_sequence<int, kK...>) {
  (MmaRs<Layout<D>::kDPad, (kK * Layout<D>::kSwizzle)>::run(
       acc, a[4 * kK], a[4 * kK + 1], a[4 * kK + 2], a[4 * kK + 3], b),
   ...);
}

template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[Layout<D>::kDPad / 2],
                                         const uint32_t (&a)[K / 4],
                                         uint64_t b) {
  issue_rs<D, K>(acc, a, b, std::make_integer_sequence<int, K / 16>{});
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rounds a float32 accumulator to bf16 in place, into the A fragments of
// the next product: k16 step kk reads elements 8kk .. 8kk + 7, as they
// lie.
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N],
                                       uint32_t (&p)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// 2^x by the SFU's ex2 alone: a result below 2^-126 flushes to 0, where
// exp2f would scale its way to a subnormal.  p is at most 1 and such a
// term is far below the 2^-9 of p's own rounding to bf16.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 2-D map of a (rows, d) bf16 matrix whose box is one swizzled column
// chunk of ``box_rows`` rows.  The map is d wide: a box that reaches past
// column d (the last at d = 80) is filled with zeros there.
template <int D>
CUresult make_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                  int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Layout<D>::kChunkCols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Layout<D>::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The SM count of the current device, or a cudaError_t below 0.
inline int sm_count() {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return err == cudaSuccess ? sms : -static_cast<int>(err);
}

}  // namespace hopper
}  // namespace
