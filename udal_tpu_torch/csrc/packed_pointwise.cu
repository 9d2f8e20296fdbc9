// Packed pointwise conv as a matrix product on tensor cores, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel tools/perf_packed.py:80 packed_pointwise (its
// kernel at :85, call :90) and computes what udal_tpu_torch/ops/packed.py:
// packed_pointwise_plain computes:
//   y [M, N] = x [M, K] @ w [K, N]
// from bf16 operands, with f32 accumulation and one rounding to bf16. In
// the probe x is [N*H*W/g, g*Cin] (g pixels packed into a row) and w the
// block-diagonal [g*Cin, g*Cout]; any w is taken, and every product is
// computed (the zeros of a block diagonal too).
//
// What bounds it on this card: bytes. At the probe's shape (M = 327,680,
// K = 192, N = 1152) it moves 126 MB in and 755 MB out, 0.26 ms at
// 3.35 TB/s, against 145 GFLOP, 0.15 ms at 989 TFLOP/s.
//
// Design: a persistent grid, as many blocks as fit on the SMs (two an SM
// at K <= 256). A block owns a slice of kBN = 128 output columns, whose
// weights [K, 128] it stages in shared memory once, and walks its share of
// the m_tile row units (the TPU grid's step, the unit of work a block
// claims). The x rows stream through a ring of chunks of 64 columns
// filled by cp.async, so the loads of the next chunks are in flight while
// the current one is multiplied. Blocks next to each other in the grid take
// the same rows for other column slices, so x is read from device memory
// about once. Two instances:
// - the vector path (K and N multiples of 8, 16-byte aligned operands):
//   wgmma, below packed_pointwise_gmma_kernel; the output leaves in whole
//   16-byte row vectors staged through shared memory (pairs of 4-byte
//   stores straight from the accumulators were far slower);
// - any other shape or view: mma.sync m16n8k16 fed by ldmatrix (a 32 x 32
//   tile a warp, 64-row tiles, one barrier a chunk), plain loads into the
//   ring and element stores.
#include "mma_tile.cuh"

#include <cstddef>

namespace {

using udal::mma::bf16;
namespace mma = udal::mma;

constexpr int kThreads = 256;  // eight warps: 2 along rows x 4 along columns
constexpr int kBM = 64;        // rows of a tile
constexpr int kBN = 128;       // output columns a block owns
constexpr int kKC = 64;        // columns of x a ring stage holds
constexpr int kStages = 4;
constexpr int kWM = 32, kWN = 32;        // a warp's tile
constexpr int kMI = kWM / 16, kNJ = kWN / 8;
constexpr int kLdx = kKC + 8;            // padded row strides (values)
constexpr int kLdw = kBN + 8;
constexpr int kLdo = kWN + 8;
static_assert((kBM / kWM) * (kBN / kWN) == kThreads / 32, "one warp per warp tile");

__host__ __device__ constexpr size_t smem_bytes(int kp) {
  return (static_cast<size_t>(kp) * kLdw + static_cast<size_t>(kStages) * kBM * kLdx +
          static_cast<size_t>(kThreads / 32) * kWM * kLdo) *
         sizeof(bf16);
}

// w's column slice [K, 128] into s_w [kp][kLdw], zeros past K and N
__device__ void stage_weights(bf16* s_w, const bf16* w, int K, int N, int n0, int kp) {
  for (int i = threadIdx.x; i < kp * kBN; i += kThreads) {
    const int r = i / kBN;
    const int c = i - r * kBN;
    s_w[r * kLdw + c] = (r < K && n0 + c < N) ? w[size_t(r) * N + n0 + c] : __float2bfloat16(0.f);
  }
}

// x rows [m0, m_end) and columns [k0, k0 + kKC) into a ring stage, zeros
// outside
__device__ void stage_x(bf16* s, const bf16* x, int K, int m0, int m_end, int k0) {
  for (int i = threadIdx.x; i < kBM * kKC; i += kThreads) {
    const int r = i / kKC;
    const int c = i - r * kKC;
    s[r * kLdx + c] = (m0 + r < m_end && k0 + c < K) ? x[size_t(m0 + r) * K + k0 + c]
                                                     : __float2bfloat16(0.f);
  }
}

struct Rows {
  int m0, m_end;
};

// any shape and view: plain loads through the ring, mma.sync, element stores
__global__ void __launch_bounds__(kThreads, 2)
packed_pointwise_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ y, int M, int K, int N, int kp, int m_tile,
                        int slices, int row_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);  // [kp][kLdw]
  bf16* s_ring = s_w + static_cast<size_t>(kp) * kLdw;  // [kStages][kBM][kLdx]
  bf16* s_out = s_ring + static_cast<size_t>(kStages) * kBM * kLdx;  // [warps][kWM][kLdo]

  const int n0 = (blockIdx.x % slices) * kBN;
  const int rb = blockIdx.x / slices;
  const int units = M / m_tile;
  const int tiles_per_unit = (m_tile + kBM - 1) / kBM;
  const int my_units = (units - rb + row_blocks - 1) / row_blocks;
  const int chunks = kp / kKC;
  const int total = my_units * tiles_per_unit * chunks;
  // the rows of this block's tile t: unit rb + (t / tiles_per_unit) * row_blocks
  auto rows = [&](int t) {
    const int u = rb + (t / tiles_per_unit) * row_blocks;
    const int m0 = u * m_tile + (t % tiles_per_unit) * kBM;
    return Rows{m0, min(m0 + kBM, (u + 1) * m_tile)};
  };
  auto load = [&](int j) {
    const Rows r = rows(j / chunks);
    stage_x(s_ring + (j % kStages) * kBM * kLdx, x, K, r.m0, r.m_end, (j % chunks) * kKC);
  };

  stage_weights(s_w, w, K, N, n0, kp);
  for (int s = 0; s < kStages - 1 && s < total; ++s) load(s);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / (kBN / kWN)) * kWM;
  const int wn = (warp % (kBN / kWN)) * kWN;
  bf16* s_o = s_out + warp * kWM * kLdo;
  float acc[kMI][kNJ][4];
  mma::zero(acc);
  for (int j = 0; j < total; ++j) {
    __syncthreads();  // stage j is in place for every thread; stage j - 1 is free
    if (j + kStages - 1 < total) load(j + kStages - 1);

    const bf16* sx = s_ring + (j % kStages) * kBM * kLdx + wm * kLdx;
    const int kc = j % chunks;
    const bf16* sw = s_w + static_cast<size_t>(kc) * kKC * kLdw + wn;
#pragma unroll
    for (int k = 0; k < kKC; k += 16) {
      uint32_t b[kNJ][2];
      mma::load_b(b, sw + k * kLdw, kLdw, lane);
      mma::mma_rows(acc, sx + k, kLdx, b, lane);
    }
    if (kc != chunks - 1) continue;

    // epilogue of the tile: round once, through the warp's own staging tile
    const Rows r = rows(j / chunks);
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = i * 16 + mma::frag_row(lane, 2 * h);
          *reinterpret_cast<uint32_t*>(s_o + row * kLdo + jj * 8 + mma::frag_col(lane)) =
              mma::pack2(acc[i][jj][2 * h], acc[i][jj][2 * h + 1]);
        }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kWM * kWN / 8 / 32; ++it) {
      const int v = it * 32 + lane;
      const int row = v / (kWN / 8);
      const int c = (v % (kWN / 8)) * 8;
      const int gr = r.m0 + wm + row;
      const int gc = n0 + wn + c;
      if (gr >= r.m_end || gc >= N) continue;
      const bf16* src = s_o + row * kLdo + c;
      bf16* dst = y + static_cast<size_t>(gr) * N + gc;
      for (int e = 0; e < 8 && gc + e < N; ++e) dst[e] = src[e];
    }
    __syncwarp();
    mma::zero(acc);
  }
}

// -- the vector path: warpgroup products (wgmma) ------------------------------
//
// The same persistent grid and column slices, in 64-row tiles, with the two
// warpgroups of a block working apart: each takes every other tile of the
// block's rows, streams its x chunks [64 rows, 64 columns] through a ring
// of its own (cp.async, its own named barrier), and multiplies them by the
// slice's 128 columns with wgmma m64n128k16, both operands read by the
// tensor cores from shared memory. So one warpgroup's epilogue runs while
// the other's products do. The weight slice is staged once, transposed to
// kp / 64 tiles [128 columns, 64 rows of w]; all operands are K-major with
// the 128-byte swizzle (mma_tile.cuh), which the tensor cores read without
// bank conflicts. The epilogue rounds to bf16 and stores value pairs from
// the registers.
constexpr int kGRows = 64;  // rows of a warpgroup's tile
constexpr int kGStages = 4;
constexpr int kAlign = 1024;  // a swizzle atom

size_t gmma_smem_bytes(int kp) {
  return (static_cast<size_t>(kp) * kBN + 2 * static_cast<size_t>(kGStages) * kGRows * kKC) *
             sizeof(bf16) + kAlign;
}

__device__ __forceinline__ void warpgroup_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
packed_pointwise_gmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                             bf16* __restrict__ y, int M, int K, int N, int kp, int m_tile,
                             int slices, int row_blocks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms must be 1 KB aligned
  unsigned char* smem =
      smem_raw + ((kAlign - (mma::smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  bf16* s_w = reinterpret_cast<bf16*>(smem);  // [kp / 64][kBN][64]
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  // [kGStages][kGRows][64], this warpgroup's ring
  bf16* s_ring = s_w + static_cast<size_t>(kp) * kBN + wg * kGStages * kGRows * kKC;

  const int n0 = (blockIdx.x % slices) * kBN;
  const int rb = blockIdx.x / slices;
  const int units = M / m_tile;
  const int tiles_per_unit = (m_tile + kGRows - 1) / kGRows;
  const int my_units = (units - rb + row_blocks - 1) / row_blocks;
  const int chunks = kp / kKC;
  const int my_tiles = (my_units * tiles_per_unit - wg + 1) / 2;  // tiles wg, wg + 2, ...
  const int total = my_tiles * chunks;
  auto rows = [&](int i) {
    const int bt = wg + 2 * i;  // the block's tile
    const int u = rb + (bt / tiles_per_unit) * row_blocks;
    const int m0 = u * m_tile + (bt % tiles_per_unit) * kGRows;
    return Rows{m0, min(m0 + kGRows, (u + 1) * m_tile)};
  };
  // eight consecutive threads fill one 128-byte row (its chunks permuted)
  auto load = [&](int j) {
    const Rows r = rows(j / chunks);
    const int k0 = (j % chunks) * kKC;
    bf16* slot = s_ring + (j % kGStages) * kGRows * kKC;
    for (int i = t; i < kGRows * (kKC / 8); i += 128) {
      const int row = i / (kKC / 8);
      const int c = (i % (kKC / 8)) * 8;
      const bool valid = r.m0 + row < r.m_end && k0 + c < K;
      mma::cp_async16(slot + mma::swizzle128(row, c),
                      valid ? x + static_cast<size_t>(r.m0 + row) * K + k0 + c : x, valid);
    }
  };

  for (int i = threadIdx.x; i < kp * (kBN / 8); i += kThreads) {
    const int k = i / (kBN / 8);
    const int n8 = (i - k * (kBN / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K && n0 + n8 < N) {
      v = __ldg(reinterpret_cast<const uint4*>(w + size_t(k) * N + n0 + n8));
    }
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    bf16* tile = s_w + static_cast<size_t>(k / kKC) * kBN * kKC;
#pragma unroll
    for (int q = 0; q < 8; ++q) tile[mma::swizzle128(n8 + q, k % kKC)] = e[q];
  }
  mma::fence_proxy_async();
  __syncthreads();  // the weights are in place for both warpgroups

  // loads run kGStages - 2 chunks ahead, so that the products of the last
  // chunk may still read their stage while this one's are issued
#pragma unroll
  for (int s = 0; s < kGStages - 2; ++s) {
    if (s < total) load(s);
    mma::cp_async_commit();
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int j = 0; j < total;) {
    const int tile = j / chunks;
    // the tile's chunks; the accumulators are touched again only after the
    // products have been waited for
    for (int kc = 0; kc < chunks; ++kc, ++j) {
      mma::cp_async_wait<kGStages - 3>();
      mma::fence_proxy_async();
      mma::wgmma_wait<1>();  // the products of chunk j - 2 are done with their stage
      warpgroup_barrier(wg);  // stage j has landed for every thread of the warpgroup
      if (j + kGStages - 2 < total) load(j + kGStages - 2);
      mma::cp_async_commit();

      const bf16* sx = s_ring + (j % kGStages) * kGRows * kKC;
      const bf16* sw = s_w + static_cast<size_t>(kc) * kBN * kKC;
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        mma::wgmma_m64n128k16(acc, mma::gmma_desc_sw128(sx + kk * 16),
                              mma::gmma_desc_sw128(sw + kk * 16), kc > 0 || kk > 0);
      }
      mma::wgmma_commit();
    }
    mma::wgmma_wait<0>();
    mma::fence_operands(acc);

    // the epilogue: round to bf16 into the two ring stages the products are
    // done with (columns [0, 64) and [64, 128), swizzled so that neither
    // side conflicts), then whole 16-byte vectors of each row to y; the
    // next chunk's barrier keeps the loads off these stages until then
    bf16* half[2] = {s_ring + ((j - 1) % kGStages) * kGRows * kKC,
                     s_ring + ((j + kGStages - 2) % kGStages) * kGRows * kKC};
    const int r0 = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* dst = half[jn / 8] + mma::swizzle128(r0 + 8 * h, (jn % 8) * 8 + (t % 4) * 2);
        *reinterpret_cast<uint32_t*>(dst) =
            mma::pack2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
      }
    warpgroup_barrier(wg);
    const Rows r = rows(tile);
#pragma unroll
    for (int i = t; i < kGRows * (kBN / 8); i += 128) {
      const int row = i / (kBN / 8);
      const int c = (i % (kBN / 8)) * 8;
      if (r.m0 + row < r.m_end && n0 + c < N) {
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(r.m0 + row) * N + n0 + c) =
            *reinterpret_cast<const uint4*>(half[c / 64] + mma::swizzle128(row, c % 64));
      }
    }
  }
  mma::cp_async_wait<0>();
}

// Launches either kernel on the persistent grid: smem_of(kp) bytes of shared
// memory (kp = K rounded up to whole ring chunks), and as many row blocks
// per column slice as fill the resident slots, at most one a unit.
using PointwiseKernel = void (*)(const bf16*, const bf16*, bf16*, int, int, int, int, int, int,
                                 int);

cudaError_t launch_persistent(PointwiseKernel kernel, size_t (*smem_of)(int), const void* x,
                              const void* w, void* y, int m, int k, int n, int m_tile,
                              cudaStream_t stream) {
  const int kp = (k + kKC - 1) / kKC * kKC;
  const size_t smem = smem_of(kp);
  const int slices = (n + kBN - 1) / kBN;
  const int units = m / m_tile;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int row_blocks = max(1, min(units, per_sm * sms / slices));
  const long long blocks = static_cast<long long>(row_blocks) * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), m, k, n,
      kp, m_tile, slices, row_blocks);
  return cudaGetLastError();
}

}  // namespace

// x [m, k], w [k, n] and y [m, n], bf16, row-major and contiguous; m a
// multiple of m_tile. vec: k and n multiples of 8 and the three pointers
// 16-byte aligned (16-byte copies and stores). Returns the CUDA error code
// of the launch (0 on success).
extern "C" int udal_packed_pointwise(const void* x, const void* w, void* y, int m, int k, int n,
                                     int m_tile, int vec, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || m_tile <= 0 || m % m_tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_persistent(packed_pointwise_gmma_kernel, gmma_smem_bytes, x, w, y, m, k, n,
                              m_tile, s)
          : launch_persistent(packed_pointwise_kernel, smem_bytes, x, w, y, m, k, n, m_tile, s));
}
