// Fused depthwise conv + BatchNorm + activation (+ channel mask, + SE mean)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel udal_tpu/ops/pallas_dw.py:_dw_kernel (wrapper
// fused_depthwise) and computes what udal_tpu_torch/ops/fused_dw.py:
// fused_depthwise_plain computes:
//   y = act(depthwise_KxK,S,TF SAME(x) * scale + bias) * mask[n, c]
// in f32 from f32 or bf16 x, y rounded to x's type, and optionally the f32
// spatial mean of y per (n, c) (the squeeze-excite input).
//
// What bounds it: bytes. Each input and output value has to move once
// between device memory and the SM against K*K multiply-adds and one
// activation per output, far below the card's ~20 f32 operations per byte:
// the MC prefix (8 x 32 x 256 x 512 bf16, k3 s1) moves 134 MB, 0.040 ms at
// 3.35 TB/s. The first design (the general path below) reached 0.41 TB/s
// there: two integer divisions and four bounds tests per staged 2-byte
// value, a division and K*K shared loads per output, 2-byte stores, and a
// 1.29x halo around 8 x 64 tiles.
//
// Fast path (fused_dw_rows_kernel), for rows of W * itemsize bytes that
// are a multiple of 16 and a 16-byte aligned x (every shape of the serve):
// - a tile is a band of th output rows across the whole width of one
//   (n, c) plane, so the halo is the K - 1 extra rows alone (1.125x at
//   th = 16, k = 3);
// - each of the band's (th - 1) * S + K input rows that lies in the image
//   is one bulk copy of the tensor memory accelerator (TMA) into its staged
//   row, which is widened to whole 16-byte groups (its left edge rounded
//   down below TF SAME's leading pad); the staged columns and rows outside
//   the image are zeros, the SAME border: no bounds test, division or
//   load instruction per value, and the copies complete on a transaction
//   barrier (mbarrier) per stage;
// - a persistent grid (as many blocks as fit on the card) walks the tiles
//   through a ring of kStages stages, so the next tiles' copies run while
//   this tile's stencil does;
// - the stencil is the column-segment form (depthwise_pair_cols): a lane
//   forms 8 outputs down each of two neighbouring columns from one load of
//   each staged value they read, and stores y as bf16x2 / float2 pairs;
// - the SE mean stays a per-tile partial (a fixed-order block reduction,
//   finished after the next tile's barrier) summed by sum_partials in a
//   fixed order: no float atomics.
// Staging by 16-byte cp.async copies, one per thread and group, measured
// slower than the bulk copies (see PERF.md).
// General path (fused_dw_kernel), for the other shapes: a block per (image,
// th x tw output tile, CT channels) stages the CT input planes' rows and
// halo value by value, loads outside the image writing the zero border;
// one warp per channel runs the stencil, BN, activation and mask
// (depthwise_epilogue), and the mean goes through the same partials.
#include "depthwise_tile.cuh"
#include "mbarrier.cuh"

#include <algorithm>

namespace {

using udal::kThreads;

template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
fused_dw_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const float* __restrict__ mask, T* __restrict__ y, float* __restrict__ partial,
                int N, int C, int H, int W, int Ho, int Wo, int pad_t, int pad_l, int th, int tw,
                int ct, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_in = reinterpret_cast<T*>(smem);  // [ct][ih][iw]
  const int ih = (th - 1) * S + K;
  const int iw = (tw - 1) * S + K;
  const udal::TilePos pos = udal::tile_pos(udal::ceil_div(C, ct), udal::ceil_div(Ho, th),
                                           udal::ceil_div(Wo, tw), ct, th, tw);
  const int gh0 = pos.oh0 * S - pad_t;
  const int gw0 = pos.ow0 * S - pad_l;
  const int plane = ih * iw;
  for (int i = threadIdx.x; i < ct * plane; i += kThreads) {
    const int cl = i / plane;
    const int p = i - cl * plane;
    const int r = p / iw;
    const int q = p - r * iw;
    const int c = pos.c0 + cl;
    const int gh = gh0 + r;
    const int gw = gw0 + q;
    T v = udal::from_float<T>(0.f);
    if (c < C && gh >= 0 && gh < H && gw >= 0 && gw < W) {
      v = x[(static_cast<size_t>(pos.n) * C + c) * H * W + static_cast<size_t>(gh) * W + gw];
    }
    s_in[i] = v;
  }
  __syncthreads();
  udal::depthwise_epilogue<T, K, S>(s_in, ct, ih, iw, th, tw, pos, taps, scale, bias, mask,
                                    act, y, partial, N, C, Ho, Wo);
}

template <typename T, int K, int S>
cudaError_t launch(const void* x, const void* taps, const void* scale, const void* bias,
                   const void* mask, void* y, void* partial, int n, int c, int h, int w,
                   int ho, int wo, int pad_t, int pad_l, int th, int tw, int ct, int act,
                   cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(ct) * ((th - 1) * S + K) * ((tw - 1) * S + K) * sizeof(T);
  const long long blocks = static_cast<long long>(n) * udal::ceil_div(ho, th) *
                           udal::ceil_div(wo, tw) * udal::ceil_div(c, ct);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(fused_dw_kernel<T, K, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_dw_kernel<T, K, S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(y), static_cast<float*>(partial), n, c,
      h, w, ho, wo, pad_t, pad_l, th, tw, ct, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int k, int stride, const void* x, const void* taps, const void* scale,
                     const void* bias, const void* mask, void* y, void* partial, int n, int c,
                     int h, int w, int ho, int wo, int pad_t, int pad_l, int th, int tw, int ct,
                     int act, cudaStream_t s) {
#define UDAL_DW_CASE(KK, SS)                                                                 \
  if (k == KK && stride == SS)                                                              \
    return launch<T, KK, SS>(x, taps, scale, bias, mask, y, partial, n, c, h, w, ho, wo,    \
                             pad_t, pad_l, th, tw, ct, act, s);
  UDAL_DW_CASE(3, 1)
  UDAL_DW_CASE(3, 2)
  UDAL_DW_CASE(5, 1)
  UDAL_DW_CASE(5, 2)
#undef UDAL_DW_CASE
  return cudaErrorInvalidValue;
}

// -- the fast path: bands of whole rows, staged by bulk copies through a ring --

using udal::kWarps;
constexpr int kStages = 3;  // ring stages: one tile computed, two loading
constexpr int kSeg = 8;     // outputs a lane forms down a column; th is a multiple

// staged rows of a band of th output rows
__host__ __device__ inline int band_rows(int th, int k, int s) { return (th - 1) * s + k; }

// the ring: kStages stages of band_rows x iwx values
size_t rows_smem_bytes(int th, int iwx, int k, int s, size_t itemsize) {
  return static_cast<size_t>(kStages) * band_rows(th, k, s) * iwx * itemsize;
}

// Tile t is band t % bands of plane t / bands (plane = n * C + c), so the
// blocks that share a halo row run at the same time. Staged column j of a
// band holds image column gwa + j (gwa a multiple of 16 bytes' values, at
// or below -pad_l); output column q's tap dx reads staged column off + q * S
// + dx, off = -pad_l - gwa. W * sizeof(T) and x are 16-byte aligned, so
// each image row of a band is one 16-byte aligned bulk copy into its staged
// row at column -gwa; the staged columns outside the image are zeroed once
// and never written again, and a staged row outside the image is zeroed
// when its tile is loaded.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads, 2)
fused_dw_rows_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ mask, T* __restrict__ y,
                     float* __restrict__ partial, int N, int C, int H, int W, int Ho, int Wo,
                     int pad_t, int gwa, int off, int iwx, int th, int bands, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);          // [kStages][band_rows][iwx]
  __shared__ float s_red[2][kWarps];             // the warps' SE sums of a tile, by parity
  __shared__ __align__(8) uint64_t s_full[kStages];  // stage s's image rows have landed
  const int rows = band_rows(th, K, S);
  const int stage = rows * iwx;
  const int total = N * C * bands;
  const size_t hw = static_cast<size_t>(H) * W;
  const unsigned row_bytes = static_cast<unsigned>(W * sizeof(T));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kStages * stage * static_cast<int>(sizeof(T)) / 16;
       i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // each thread orders its zeros before the bulk copies issued after the
  // barrier (the copies' proxy writes the same bytes)
  udal::fence_proxy_async_shared();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) udal::mbarrier_init(&s_full[s]);
  }
  __syncthreads();

  // tile t into stage `slot` (free): the rows outside the image zeroed by
  // every thread, each row inside it one bulk copy issued by thread 0. The
  // zeros and this tile's copies write different rows; each thread's fence
  // orders its zeros before the copies a later tile issues into the same
  // stage after the barriers between them.
  auto load = [&](int t, int slot) {
    if (t >= total) return;
    const int plane = t / bands;
    const int gh0 = (t - plane * bands) * th * S - pad_t;
    const int r0 = max(0, -gh0), r1 = min(rows, H - gh0);  // the staged rows in the image
    T* dst = ring + slot * stage;
    for (int i = threadIdx.x; i < (rows - (r1 - r0)) * iwx; i += kThreads) {
      const int r = i / iwx;
      dst[(r < r0 ? r : r + r1 - r0) * iwx + i - r * iwx] = udal::from_float<T>(0.f);
    }
    udal::fence_proxy_async_shared();
    if (threadIdx.x == 0) {
      udal::mbarrier_expect(&s_full[slot], (r1 - r0) * row_bytes);
      const T* src = x + plane * hw;
      for (int r = r0; r < r1; ++r) {
        udal::bulk_copy(dst + r * iwx - gwa, src + static_cast<size_t>(gh0 + r) * W, row_bytes,
                        &s_full[slot]);
      }
    }
  };
  // the SE partial of tile t from its warps' sums, in a fixed order
  auto finish = [&](int t, const float* red) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    const int plane = t / bands;
    partial[static_cast<size_t>(t - plane * bands) * N * C + plane] = s;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(blockIdx.x + s * gridDim.x, s);
  const int pairs = Wo / 2;
  const int items = th / kSeg * pairs;
  int j = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x, ++j) {
    __syncthreads();  // tile t - grid is done: its stage is free, its SE sums written
    if (partial != nullptr && j > 0 && threadIdx.x == 0) finish(t - gridDim.x, s_red[(j - 1) & 1]);
    load(t + (kStages - 1) * gridDim.x, (j + kStages - 1) % kStages);
    udal::mbarrier_wait<false>(&s_full[j % kStages], (j / kStages) & 1);

    const int plane = t / bands;
    const int band = t - plane * bands;
    const int c = plane % C;
    float w[K * K];
#pragma unroll
    for (int i = 0; i < K * K; ++i) w[i] = __ldg(taps + c * K * K + i);
    const float sc = __ldg(scale + c);
    const float bi = __ldg(bias + c);
    const float mk = mask != nullptr ? __ldg(mask + plane) : 1.f;
    const T* tile = ring + (j % kStages) * stage + off;
    T* out = y + (static_cast<size_t>(plane) * Ho + band * th) * Wo;
    const int left = Ho - band * th;  // output rows of the band inside the image
    float sum = 0.f;
    udal::with_activation(act, [&](auto tag) {
      for (int it = threadIdx.x; it < items; it += kThreads) {
        const int g = it / pairs;
        const int q = (it - g * pairs) * 2;
        const int r0 = g * kSeg;
        if (r0 >= left) continue;
        sum += udal::depthwise_pair_cols<T, decltype(tag)::kAct, K, S, kSeg>(
            tile + r0 * S * iwx + q * S, iwx, w, sc, bi, mk, act,
            out + static_cast<size_t>(r0) * Wo + q, Wo, left - r0);
      }
    });
    if (partial != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) s_red[j & 1][warp] = sum;
    }
  }
  if (partial != nullptr && j > 0) {
    __syncthreads();
    if (threadIdx.x == 0) finish(blockIdx.x + (j - 1) * gridDim.x, s_red[(j - 1) & 1]);
  }
}

template <typename T, int K, int S>
cudaError_t launch_rows(const void* x, const void* taps, const void* scale, const void* bias,
                        const void* mask, void* y, void* partial, int n, int c, int h, int w,
                        int ho, int wo, int pad_t, int gwa, int off, int iwx, int th, int act,
                        cudaStream_t stream) {
  const int bands = udal::ceil_div(ho, th);
  const long long total = static_cast<long long>(n) * c * bands;
  if (total > 0x7fffffffLL || th % kSeg != 0 || wo % 2 != 0 || iwx % (16 / sizeof(T)) != 0 ||
      (w * sizeof(T)) % 16 != 0 || (-gwa * sizeof(T)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = rows_smem_bytes(th, iwx, K, S, sizeof(T));
  auto* kernel = fused_dw_rows_kernel<T, K, S>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // the persistent grid: as many blocks as the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(std::min(total, static_cast<long long>(sms) * per_sm));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<T*>(y),
      static_cast<float*>(partial), n, c, h, w, ho, wo, pad_t, gwa, off, iwx, th, bands, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int k, int stride, const void* x, const void* taps, const void* scale,
                          const void* bias, const void* mask, void* y, void* partial, int n,
                          int c, int h, int w, int ho, int wo, int pad_t, int gwa, int off,
                          int iwx, int th, int act, cudaStream_t s) {
#define UDAL_DW_ROWS_CASE(KK, SS)                                                            \
  if (k == KK && stride == SS)                                                              \
    return launch_rows<T, KK, SS>(x, taps, scale, bias, mask, y, partial, n, c, h, w, ho,   \
                                  wo, pad_t, gwa, off, iwx, th, act, s);
  UDAL_DW_ROWS_CASE(3, 1)
  UDAL_DW_ROWS_CASE(3, 2)
  UDAL_DW_ROWS_CASE(5, 1)
  UDAL_DW_ROWS_CASE(5, 2)
#undef UDAL_DW_ROWS_CASE
  return cudaErrorInvalidValue;
}

cudaError_t finish_mean(const void* partial, void* mean, int tiles, int nc, int ho, int wo,
                        cudaStream_t s) {
  return udal::launch_sum_partials(static_cast<const float*>(partial), static_cast<float*>(mean),
                                   tiles, nc, static_cast<float>(ho) * wo, s);
}

}  // namespace

// x [n, c, h, w] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); taps
// [c, k, k], scale, bias [c] and mask [n, c] (or null) f32; y [n, c, ho, wo]
// in x's type. With `mean` (f32 [n, c]) non-null, `partial` is f32 scratch
// of ceil(ho/th) * ceil(wo/tw) * n * c values. k in {3, 5}, stride in
// {1, 2}; (pad_t, pad_l) are TF SAME's leading pads. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int udal_fused_dw(const void* x, const void* taps, const void* scale,
                             const void* bias, const void* mask, void* y, void* partial,
                             void* mean, int bf16, int n, int c, int h, int w, int k, int stride,
                             int ho, int wo, int pad_t, int pad_l, int th, int tw, int ct,
                             int act, void* stream) {
  if (n <= 0 || c <= 0 || ho <= 0 || wo <= 0 || th <= 0 || tw <= 0 || ct <= 0 ||
      (mean != nullptr && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* part = mean != nullptr ? partial : nullptr;
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(k, stride, x, taps, scale, bias, mask, y, part, n, c, h, w,
                                     ho, wo, pad_t, pad_l, th, tw, ct, act, s)
           : dispatch<float>(k, stride, x, taps, scale, bias, mask, y, part, n, c, h, w, ho, wo,
                             pad_t, pad_l, th, tw, ct, act, s);
  if (err != cudaSuccess || mean == nullptr) return static_cast<int>(err);
  const int tiles = udal::ceil_div(ho, th) * udal::ceil_div(wo, tw);
  return static_cast<int>(finish_mean(partial, mean, tiles, n * c, ho, wo, s));
}

// The fast path: operands as udal_fused_dw, with W * itemsize a multiple of
// 16, x 16-byte aligned and wo even. The band is th output rows (a
// multiple of 8); staged column j holds image column gwa + j (gwa a
// multiple of 16 bytes' values), output column q's first tap is staged
// column off + q * stride, and a staged row has iwx values (a multiple of
// 16 bytes). With `mean`, `partial` holds ceil(ho/th) * n * c values.
extern "C" int udal_fused_dw_rows(const void* x, const void* taps, const void* scale,
                                  const void* bias, const void* mask, void* y, void* partial,
                                  void* mean, int bf16, int n, int c, int h, int w, int k,
                                  int stride, int ho, int wo, int pad_t, int gwa, int off,
                                  int iwx, int th, int act, void* stream) {
  if (n <= 0 || c <= 0 || ho <= 0 || wo <= 0 || th <= 0 || iwx <= 0 ||
      (mean != nullptr && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* part = mean != nullptr ? partial : nullptr;
  cudaError_t err =
      bf16 ? dispatch_rows<__nv_bfloat16>(k, stride, x, taps, scale, bias, mask, y, part, n, c,
                                          h, w, ho, wo, pad_t, gwa, off, iwx, th, act, s)
           : dispatch_rows<float>(k, stride, x, taps, scale, bias, mask, y, part, n, c, h, w, ho,
                                  wo, pad_t, gwa, off, iwx, th, act, s);
  if (err != cudaSuccess || mean == nullptr) return static_cast<int>(err);
  return static_cast<int>(finish_mean(partial, mean, udal::ceil_div(ho, th), n * c, ho, wo, s));
}

// The dynamic shared memory of a fast-path block (the ring) for a band of
// th rows and staged rows of iwx values: what the host's planner
// (ops/fused_dw.py) models, checked against this before a launch.
extern "C" long long udal_fused_dw_rows_smem(int bf16, int th, int iwx, int k, int stride) {
  return static_cast<long long>(rows_smem_bytes(th, iwx, k, stride, bf16 ? 2 : 4));
}
