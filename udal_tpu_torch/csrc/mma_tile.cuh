// Shared tensor-core tile code of packed_pointwise.cu (B4) and
// fused_expand_dw.cu (B3): asynchronous 16-byte copies into a ring of
// shared-memory stages (cp.async, zero fill outside the operand), fragment
// loads with ldmatrix, and the bf16 m16n8k16 product with f32 accumulators
// (mma.sync, HMMA in the SASS), and the warpgroup product (wgmma, HGMMA)
// with its shared-memory descriptors.
//
// Both kernels multiply an A tile [M][K] stored K-contiguous with a B tile
// [K][N] stored N-contiguous, each in shared memory with a row stride that
// is a multiple of 8 values plus 8 (16 bytes of padding), so the eight
// 16-byte rows an ldmatrix reads fall in distinct bank groups. A warp's
// tile is MI fragments of 16 rows by NJ fragments of 8 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace udal {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst`, asynchronously; with !valid
// the 16 bytes are zeros and `src` is not read (it must still be a mapped
// address: pass the operand's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment of a 16 x 16 tile at `a` (row stride lda values, K-contiguous)
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* a, int lda, int lane) {
  const bf16* p = a + (lane & 15) * lda + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two B fragments (k16 x n8 each, columns [0, 8) and [8, 16)) of the tile
// at `b` (row stride ldb values, N-contiguous)
__device__ __forceinline__ void load_b2(uint32_t (&b0)[2], uint32_t (&b1)[2], const bf16* b,
                                        int ldb, int lane) {
  const bf16* p = b + (lane & 15) * ldb + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
               : "r"(smem_addr(p)));
}

// d += a . b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragments of a warp's NJ column fragments at one k16 step
template <int NJ>
__device__ __forceinline__ void load_b(uint32_t (&b)[NJ][2], const bf16* src, int ldb,
                                       int lane) {
  static_assert(NJ % 2 == 0, "B fragments load in pairs");
#pragma unroll
  for (int j = 0; j < NJ; j += 2) load_b2(b[j], b[j + 1], src + j * 8, ldb, lane);
}

// acc[i][j] += A rows [16 i, 16 i + 16) . b[j], for A at `a` (k offset
// included)
template <int MI, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[MI][NJ][4], const bf16* a, int lda,
                                         const uint32_t (&b)[NJ][2], int lane) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    uint32_t af[4];
    load_a(af, a + i * 16 * lda, lda, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_16816(acc[i][j], af, b[j]);
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Where accumulator e (0..3) of a fragment sits: row (lane / 4) + 8 for
// e >= 2, column 2 (lane % 4) + (e & 1).
__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int lane) { return (lane & 3) * 2; }

// -- Hopper warpgroup products (wgmma) -----------------------------------------
//
// Operands in shared memory K-major with the 128-byte swizzle: rows of 64
// bf16 (128 bytes), the 16-byte chunk c of row r stored at chunk c ^ (r % 8),
// in atoms of 8 rows (1 KB, 1 KB aligned); one atom after the other along M
// (or N). swizzle128(r, k) is the value offset of (r, k) in such a tile.
__device__ __forceinline__ int swizzle128(int r, int k) {
  return r * 64 + ((((k >> 3) ^ r) & 7) << 3) + (k & 7);
}

// the descriptor of a K-major 128-byte-swizzled operand at `smem` (its k
// offset within the 128-byte rows included): 1 KB from one 8-row atom to
// the next
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* smem) {
  return static_cast<uint64_t>((smem_addr(smem) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// shared-memory writes of the generic proxy (st.shared, cp.async) become
// visible to the tensor cores' reads (async proxy) after this and a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// pins the accumulators to their registers around wgmma: without it the
// compiler may copy them between the asynchronous products, and ptxas then
// waits for each product to finish (warning C7517)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// waits until at most N of the warpgroup's committed product groups are
// in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A [64 x 16] . B [16 x 128], bf16 from shared memory, f32 in the
// registers of the warpgroup: thread t holds rows 16 (t / 32) + (t % 32) / 4
// (+ 8 for d[4 j + 2], d[4 j + 3]) and columns 8 j + 2 (t % 4) (+ 1). With
// accumulate == 0 the product overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// two values rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16);
}

}  // namespace mma
}  // namespace udal
