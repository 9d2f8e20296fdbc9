// Packed pointwise conv as a matrix product on tensor cores, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel tools/perf_packed.py:80 packed_pointwise (its
// kernel at :85, call :90) and computes what udal_tpu_torch/ops/packed.py:
// packed_pointwise_plain computes:
//   y [M, N] = x [M, K] @ w [K, N]
// from bf16 operands, with f32 accumulation and one rounding to bf16. In
// the probe x is [N*H*W/g, g*Cin] (g pixels packed into a row) and w the
// block-diagonal [g*Cin, g*Cout]; any w is taken.
//
// Design: a block owns a slice of kBN = 128 output columns and m_tile rows
// (the TPU kernel's M tile). It stages its weight slice [K, 128] in shared
// memory once, with 16-byte loads and zeros past K and N, then walks its
// rows kBM = 64 at a time: the x rows [64, K] go to shared memory, eight
// warps each multiply a 32 x 32 tile with nvcuda::wmma bf16 16x16x16
// fragments into f32 accumulators (HMMA), the accumulators go through
// shared memory (aliasing the x rows), and the epilogue rounds each value
// once and writes 16-byte vectors. Block index runs over the column slices
// first, so the blocks that read one set of x rows run together and the
// other slices find those rows in L2.
//
// What bounds it on this card: bytes. At the probe's shape (M = 327,680,
// K = 192, N = 1152) it moves 126 MB in and 755 MB out, 0.26 ms at
// 3.35 TB/s, against 145 GFLOP (7/8 of them on the block diagonal's zeros),
// 0.15 ms at 989 TFLOP/s. This first version does not overlap the loads of
// a row tile with the products of the last (no cp.async ring, no wgmma);
// two blocks an SM (84 KB of shared memory each) hide what they can.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;           // eight warps
constexpr int kBM = 64;                 // rows of x a pass multiplies
constexpr int kBN = 128;                // output columns a block owns
constexpr int kWM = 32, kWN = 32;       // a warp's tile: 2 x 2 fragments of 16 x 16
constexpr int kFrag = 16;
constexpr int kPad = 8;                 // bf16 row padding (16 bytes) against bank conflicts
constexpr int kPadC = 4;                // f32 row padding of the accumulator tile
constexpr int kLdb = kBN + kPad;
constexpr int kLdc = kBN + kPadC;
static_assert((kBM / kWM) * (kBN / kWN) == kThreads / 32, "one warp per warp tile");

// two values rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16);
}

__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) & ~size_t(127); }

__host__ __device__ constexpr size_t smem_bytes(int kp) {
  // weight slice [kp][kLdb], then x rows [kBM][kp + kPad] and the f32
  // accumulator tile [kBM][kLdc] sharing one region
  const size_t a = static_cast<size_t>(kBM) * (kp + kPad) * sizeof(bf16);
  const size_t c = static_cast<size_t>(kBM) * kLdc * sizeof(float);
  return align128(static_cast<size_t>(kp) * kLdb * sizeof(bf16)) + align128(a > c ? a : c);
}

// s[r][c] = g[r][c] for r < rows, c < cols (a rows x cols window of a
// row-major matrix with leading dimension ldg), zero where r >= rows_valid
// or c >= cols_valid. cols is a multiple of 8; with kVec, so are cols_valid
// and ldg, and g is 16-byte aligned, so each 8-value vector is wholly in or
// out.
template <bool kVec>
__device__ __forceinline__ void stage(bf16* s, int lds, const bf16* g, size_t ldg,
                                      int rows_valid, int cols_valid, int rows, int cols) {
  if constexpr (kVec) {
    const int vc = cols / 8;
    for (int i = threadIdx.x; i < rows * vc; i += kThreads) {
      const int r = i / vc;
      const int c = (i - r * vc) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows_valid && c < cols_valid) {
        v = __ldg(reinterpret_cast<const uint4*>(g + r * ldg + c));
      }
      *reinterpret_cast<uint4*>(s + r * lds + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols;
      const int c = i - r * cols;
      s[r * lds + c] = (r < rows_valid && c < cols_valid) ? g[r * ldg + c] : __float2bfloat16(0.f);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
packed_pointwise_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ y, int M, int K, int N, int kp, int m_tile,
                        int slices) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);                                       // [kp][kLdb]
  unsigned char* region = smem + align128(static_cast<size_t>(kp) * kLdb * sizeof(bf16));
  bf16* s_x = reinterpret_cast<bf16*>(region);                                     // [kBM][lda]
  float* s_c = reinterpret_cast<float*>(region);                                   // [kBM][kLdc]
  const int lda = kp + kPad;

  const int n0 = (blockIdx.x % slices) * kBN;
  const int m_begin = (blockIdx.x / slices) * m_tile;
  const int m_end = min(m_begin + m_tile, M);
  stage<kVec>(s_w, kLdb, w + n0, N, K, N - n0, kp, kBN);

  const int warp = threadIdx.x / 32;
  const int wm = (warp / (kBN / kWN)) * kWM;
  const int wn = (warp % (kBN / kWN)) * kWN;
  for (int m0 = m_begin; m0 < m_end; m0 += kBM) {
    __syncthreads();  // the last pass's epilogue is done with s_c
    stage<kVec>(s_x, lda, x + static_cast<size_t>(m0) * K, K, m_end - m0, K, kBM, kp);
    __syncthreads();
    wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k = 0; k < kp; k += kFrag) {
      wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], s_x + (wm + i * kFrag) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], s_w + k * kLdb + wn + j * kFrag, kLdb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every warp has read s_x before s_c overwrites it
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(s_c + (wm + i * kFrag) * kLdc + wn + j * kFrag, acc[i][j], kLdc,
                                wmma::mem_row_major);
    __syncthreads();
    // epilogue: one rounding to bf16, 8 values (16 bytes) a thread a step
    for (int i = threadIdx.x; i < kBM * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8);
      const int c = (i - r * (kBN / 8)) * 8;
      const int gr = m0 + r, gc = n0 + c;
      if (gr >= m_end || gc >= N) continue;
      const float* src = s_c + r * kLdc + c;
      bf16* dst = y + static_cast<size_t>(gr) * N + gc;
      if constexpr (kVec) {
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        *reinterpret_cast<uint4*>(dst) = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w),
                                                    pack2(hi.x, hi.y), pack2(hi.z, hi.w));
      } else {
        for (int e = 0; e < 8 && gc + e < N; ++e) dst[e] = __float2bfloat16(src[e]);
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const void* x, const void* w, void* y, int m, int k, int n, int m_tile,
                   cudaStream_t stream) {
  const int kp = (k + kFrag - 1) / kFrag * kFrag;
  const size_t smem = smem_bytes(kp);
  const int slices = (n + kBN - 1) / kBN;
  const long long blocks = static_cast<long long>(m / m_tile) * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(packed_pointwise_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  packed_pointwise_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), m, k, n,
      kp, m_tile, slices);
  return cudaGetLastError();
}

}  // namespace

// x [m, k], w [k, n] and y [m, n], bf16, row-major and contiguous; m a
// multiple of m_tile. vec: k and n multiples of 8 and the three pointers
// 16-byte aligned (16-byte loads and stores). Returns the CUDA error code
// of the launch (0 on success).
extern "C" int udal_packed_pointwise(const void* x, const void* w, void* y, int m, int k, int n,
                                     int m_tile, int vec, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || m_tile <= 0 || m % m_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<true>(x, w, y, m, k, n, m_tile, s)
                              : launch<false>(x, w, y, m, k, n, m_tile, s));
}
