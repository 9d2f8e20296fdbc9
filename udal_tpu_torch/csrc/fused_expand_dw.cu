// Fused MBConv front half for Hopper (sm_90a): expand 1x1 + bn0 + act +
// mask, then depthwise KxK + bn1 + act + mask, and the SE sum.
//
// Replaces the TPU kernel udal_tpu/ops/pallas_mbconv.py:_kernel (wrapper
// fused_expand_dw) and computes what udal_tpu_torch/ops/fused_mbconv.py:
// fused_expand_dw_plain computes, with bn0 folded into the expand weights
// and bn1 into the taps:
//   z = act(x . We + b0) * m1[n, e]          (rounded to x's type)
//   a = act(depthwise_KxK,S,TF SAME(z) + b1) * m2[n, e]
// returning y = a in x's type and se_sum[n, e] = sum over pixels of a (f32).
// Unlike the TPU kernel, which centres stride-2 windows on input row s*i,
// the stencil follows TF SAME (the extra pad row and column at the end),
// as the model's convolution does.
//
// Design: a block per (image, TH x TW output tile, CT = 16 expanded
// channels), the channel tile fastest so blocks that read the same input
// pixels run together. The block first computes the expanded tile for its
// output rows and halo, (TH-1)*S+K rows by (TW-1)*S+K columns, into shared
// memory: one thread per pixel keeps the CT sums in registers and loops
// over Cin on CUDA cores in f32, reading x from device memory (L2) and the
// folded weights [Cin][CT] from shared memory. Only the pixels inside the
// image are computed; the rest of the tile is the zero border of TF SAME,
// applied after the expand as the model pads z, not x. The halo pixels
// that neighbouring tiles also need are recomputed. The depthwise stencil,
// bias, activation and mask then run from shared memory
// (depthwise_tile.cuh), and the SE sum is a per-tile partial reduced by a
// second, deterministic kernel. The expanded tensor never goes to device
// memory.
//
// What bounds it: the expand's multiply-adds on CUDA cores (Cin*CT per
// staged pixel; at d0's 1024x512 MC batch about 140 G in blocks 1-15),
// where the plain chain is bound by writing and re-reading the expanded
// tensor about six times. Tensor cores (wgmma) for the expand are the next
// step.
#include "depthwise_tile.cuh"

namespace {

using udal::kThreads;
constexpr int kCT = 16;  // expanded channels a block computes

template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
fused_expand_dw_kernel(const T* __restrict__ x, const float* __restrict__ we,
                       const float* __restrict__ b0, const float* __restrict__ m1,
                       const float* __restrict__ wd, const float* __restrict__ b1,
                       const float* __restrict__ m2, T* __restrict__ y,
                       float* __restrict__ partial, int N, int Cin, int Ce, int H, int W, int Ho,
                       int Wo, int pad_t, int pad_l, int th, int tw, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_we = reinterpret_cast<float*>(smem);  // [Cin][kCT]
  T* s_z = reinterpret_cast<T*>(s_we + Cin * kCT);  // [kCT][ih][iw]
  __shared__ float s_b0[kCT];
  __shared__ float s_m1[kCT];
  const int ih = (th - 1) * S + K;
  const int iw = (tw - 1) * S + K;
  const udal::TilePos pos = udal::tile_pos(udal::ceil_div(Ce, kCT), udal::ceil_div(Ho, th),
                                           udal::ceil_div(Wo, tw), kCT, th, tw);
  for (int i = threadIdx.x; i < Cin * kCT; i += kThreads) {
    const int ci = i / kCT;
    const int e = pos.c0 + (i - ci * kCT);
    s_we[i] = e < Ce ? we[static_cast<size_t>(ci) * Ce + e] : 0.f;
  }
  if (threadIdx.x < kCT) {
    const int e = pos.c0 + threadIdx.x;
    s_b0[threadIdx.x] = e < Ce ? b0[e] : 0.f;
    s_m1[threadIdx.x] = (e < Ce && m1 != nullptr) ? m1[pos.n * Ce + e] : 1.f;
  }
  __syncthreads();

  const int gh0 = pos.oh0 * S - pad_t;
  const int gw0 = pos.ow0 * S - pad_l;
  const int plane = ih * iw;
  // the staged rows [r0, r1) and columns [q0, q1) that lie in the image;
  // the rest of the tile is the zero border of TF SAME
  const int r0 = max(0, -gh0), r1 = min(ih, H - gh0);
  const int q0 = max(0, -gw0), q1 = min(iw, W - gw0);
  const int wi = q1 - q0;
  if (r0 > 0 || r1 < ih || q0 > 0 || q1 < iw) {
    for (int i = threadIdx.x; i < kCT * plane; i += kThreads) {
      s_z[i] = udal::from_float<T>(0.f);
    }
    __syncthreads();
  }
  const size_t hw = static_cast<size_t>(H) * W;
  const T* xn = x + static_cast<size_t>(pos.n) * Cin * hw;
  for (int i = threadIdx.x; i < (r1 - r0) * wi; i += kThreads) {
    const int r = r0 + i / wi;
    const int q = q0 + i % wi;
    float acc[kCT];
#pragma unroll
    for (int j = 0; j < kCT; ++j) acc[j] = 0.f;
    const T* xp = xn + static_cast<size_t>(gh0 + r) * W + gw0 + q;
#pragma unroll 4
    for (int ci = 0; ci < Cin; ++ci) {
      const float xv = udal::to_float(xp[ci * hw]);
      const float4* wrow = reinterpret_cast<const float4*>(s_we + ci * kCT);
#pragma unroll
      for (int j = 0; j < kCT / 4; ++j) {
        const float4 w4 = wrow[j];
        acc[4 * j] += xv * w4.x;
        acc[4 * j + 1] += xv * w4.y;
        acc[4 * j + 2] += xv * w4.z;
        acc[4 * j + 3] += xv * w4.w;
      }
    }
    const int p = r * iw + q;
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
      s_z[j * plane + p] = udal::from_float<T>(udal::activate(acc[j] + s_b0[j], act) * s_m1[j]);
    }
  }
  __syncthreads();
  udal::depthwise_epilogue<T, K, S>(s_z, kCT, ih, iw, th, tw, pos, wd, nullptr, b1, m2, act, y,
                                    partial, N, Ce, Ho, Wo);
}

template <typename T, int K, int S>
cudaError_t launch(const void* x, const void* we, const void* b0, const void* m1,
                   const void* wd, const void* b1, const void* m2, void* y, void* partial, int n,
                   int cin, int ce, int h, int w, int ho, int wo, int pad_t, int pad_l, int th,
                   int tw, int act, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cin) * kCT * sizeof(float) +
                      static_cast<size_t>(kCT) * ((th - 1) * S + K) * ((tw - 1) * S + K) *
                          sizeof(T);
  const long long blocks = static_cast<long long>(n) * udal::ceil_div(ho, th) *
                           udal::ceil_div(wo, tw) * udal::ceil_div(ce, kCT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(fused_expand_dw_kernel<T, K, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_expand_dw_kernel<T, K, S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(we), static_cast<const float*>(b0),
      static_cast<const float*>(m1), static_cast<const float*>(wd),
      static_cast<const float*>(b1), static_cast<const float*>(m2), static_cast<T*>(y),
      static_cast<float*>(partial), n, cin, ce, h, w, ho, wo, pad_t, pad_l, th, tw, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int k, int stride, const void* x, const void* we, const void* b0,
                     const void* m1, const void* wd, const void* b1, const void* m2, void* y,
                     void* partial, int n, int cin, int ce, int h, int w, int ho, int wo,
                     int pad_t, int pad_l, int th, int tw, int act, cudaStream_t s) {
#define UDAL_EDW_CASE(KK, SS)                                                                \
  if (k == KK && stride == SS)                                                              \
    return launch<T, KK, SS>(x, we, b0, m1, wd, b1, m2, y, partial, n, cin, ce, h, w, ho,   \
                             wo, pad_t, pad_l, th, tw, act, s);
  UDAL_EDW_CASE(3, 1)
  UDAL_EDW_CASE(3, 2)
  UDAL_EDW_CASE(5, 1)
  UDAL_EDW_CASE(5, 2)
#undef UDAL_EDW_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x [n, cin, h, w] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); we
// [cin, ce], b0 [ce], wd [ce, k, k], b1 [ce] f32; m1, m2 [n, ce] f32 or
// null; y [n, ce, ho, wo] in x's type; se_sum [n, ce] f32; `partial` f32
// scratch of ceil(ho/th) * ceil(wo/tw) * n * ce values. k in {3, 5},
// stride in {1, 2}; (pad_t, pad_l) are TF SAME's leading pads. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int udal_fused_expand_dw(const void* x, const void* we, const void* b0,
                                    const void* m1, const void* wd, const void* b1,
                                    const void* m2, void* y, void* partial, void* se_sum,
                                    int bf16, int n, int cin, int ce, int h, int w, int k,
                                    int stride, int ho, int wo, int pad_t, int pad_l, int th,
                                    int tw, int act, void* stream) {
  if (n <= 0 || cin <= 0 || ce <= 0 || ho <= 0 || wo <= 0 || th <= 0 || tw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(k, stride, x, we, b0, m1, wd, b1, m2, y, partial, n, cin,
                                     ce, h, w, ho, wo, pad_t, pad_l, th, tw, act, s)
           : dispatch<float>(k, stride, x, we, b0, m1, wd, b1, m2, y, partial, n, cin, ce, h, w,
                             ho, wo, pad_t, pad_l, th, tw, act, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = udal::ceil_div(ho, th) * udal::ceil_div(wo, tw);
  return static_cast<int>(udal::launch_sum_partials(static_cast<const float*>(partial),
                                                    static_cast<float*>(se_sum), tiles, n * ce,
                                                    1.f, s));
}
