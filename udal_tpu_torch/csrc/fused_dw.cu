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
// Design: a block per (image, TH x TW output tile, CT channels). It stages
// the CT input planes' rows and halo into shared memory in x's type; loads
// that fall outside the image write the zero border of TF SAME instead, so
// no padded copy of x exists. Then one warp per channel runs the stencil,
// the BN affine, the activation and the mask, and writes y. The mean is a
// per-tile partial sum per channel written to a scratch buffer, then a
// second small kernel sums the tiles in a fixed order: no float atomics,
// so a run repeats bit for bit.
//
// What bounds it: bytes, in principle. Each input and output value moves
// once between device memory and the SM (plus the halo, (TH+K-1)(TW+K-1)/
// (TH*TW) ~ 1.1 at TH=8, TW=64, K=3) against K*K multiply-adds per output:
// far below the card's ~20 f32 operations per byte. The plain chain it
// replaces makes separate passes for the pad, the conv, the BN, the
// activation, the mask and the mean. On an H100 SXM at 700 W the MC
// prefix (8x32x256x512 bf16) takes 0.30 ms, 0.45 TB/s of the card's 3.35:
// the per-element index arithmetic of the staging loop, not the bytes,
// sets the time so far.
#include "depthwise_tile.cuh"

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
  return static_cast<int>(udal::launch_sum_partials(static_cast<const float*>(partial),
                                                    static_cast<float*>(mean), tiles, n * c,
                                                    static_cast<float>(ho) * wo, s));
}
