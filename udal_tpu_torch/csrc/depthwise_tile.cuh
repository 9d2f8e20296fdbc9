// Shared pieces of the fused depthwise kernels (fused_dw.cu and
// fused_expand_dw.cu): conversions, the activations, the depthwise stencil
// with its epilogue over a tile staged in shared memory, and the
// deterministic reduction of the per-tile SE partial sums.
//
// Layout is the port's NCHW. A block owns one image n, one tile of TH x TW
// output pixels and one tile of CT channels. Its input tile
// [CT][(TH-1)*S+K][(TW-1)*S+K] sits in shared memory in the activation type,
// with the TF SAME zero border already in place, so the stencil reads no
// padded copy from device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace udal {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// activation codes, as ACTS in udal_tpu_torch/ops/fused_dw.py
enum Act : int { kSwish = 0, kRelu = 1, kRelu6 = 2, kIdentity = 3, kHswish = 4, kMish = 5 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>  // round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    // hardware exp2 and reciprocal (a few ulps of f32): the exact expf and
    // IEEE divide cost as much as the expand at Cin = 16. For v < -87 the
    // denominator is huge or inf and the quotient 0, as it should be.
    case kSwish: return __fdividef(v, 1.f + __expf(-v));
    case kRelu: return fmaxf(v, 0.f);
    case kRelu6: return fminf(fmaxf(v, 0.f), 6.f);
    case kHswish: return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) / 6.f;
    case kMish: return v * tanhf(v > 20.f ? v : log1pf(expf(v)));  // softplus threshold 20
    default: return v;
  }
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Where a block sits: image n, first channel c0, first output row and
// column (oh0, ow0), and the index of its spatial tile within the image.
struct TilePos {
  int n, c0, oh0, ow0, tile;
};

// Decodes blockIdx.x with the channel tile fastest, so the blocks that
// read the same input pixels run next to each other (and hit in L2).
__device__ __forceinline__ TilePos tile_pos(int c_tiles, int h_tiles, int w_tiles, int ct,
                                            int th, int tw) {
  int b = blockIdx.x;
  const int ctile = b % c_tiles;
  b /= c_tiles;
  const int wt = b % w_tiles;
  b /= w_tiles;
  const int ht = b % h_tiles;
  return {b / h_tiles, ctile * ct, ht * th, wt * tw, ht * w_tiles + wt};
}

// The depthwise K x K, stride S stencil over the staged tile `s_in`
// [ct][ih][iw], then v = act(acc * scale + bias) * mask, stored to y
// [N, C, Ho, Wo] in T. One warp per channel, lanes over the tile's output
// pixels (row-major, so a warp's stores coalesce). With `partial`, lane 0
// writes the channel's sum of v (f32, before rounding) over the tile to
// partial[tile][n*C + c], summed in a fixed order: no atomics, so the same
// inputs give the same bits run to run.
template <typename T, int K, int S>
__device__ __forceinline__ void depthwise_epilogue(
    const T* __restrict__ s_in, int ct, int ih, int iw, int th, int tw, const TilePos& pos,
    const float* __restrict__ taps, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ mask, int act, T* __restrict__ y,
    float* __restrict__ partial, int N, int C, int Ho, int Wo) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int cl = warp; cl < ct; cl += kWarps) {
    const int c = pos.c0 + cl;
    if (c >= C) break;
    float w[K * K];
#pragma unroll
    for (int i = 0; i < K * K; ++i) w[i] = taps[c * K * K + i];
    const float sc = scale != nullptr ? scale[c] : 1.f;
    const float bi = bias[c];
    const float mk = mask != nullptr ? mask[pos.n * C + c] : 1.f;
    const T* src = s_in + static_cast<size_t>(cl) * ih * iw;
    T* dst = y + static_cast<size_t>(pos.n * C + c) * Ho * Wo;
    float sum = 0.f;
    for (int o = lane; o < th * tw; o += 32) {
      const int r = o / tw;
      const int q = o - r * tw;
      const int oh = pos.oh0 + r;
      const int ow = pos.ow0 + q;
      if (oh >= Ho || ow >= Wo) continue;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          acc += to_float(src[(r * S + dy) * iw + q * S + dx]) * w[dy * K + dx];
        }
      }
      const float v = activate(acc * sc + bi, act) * mk;
      dst[static_cast<size_t>(oh) * Wo + ow] = from_float<T>(v);
      sum += v;
    }
    if (partial != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) partial[static_cast<size_t>(pos.tile) * N * C + pos.n * C + c] = sum;
    }
  }
}

// out[i] = (sum over t of partial[t][i], in order t = 0, 1, ...) / div
__global__ void sum_partials(const float* __restrict__ partial, float* __restrict__ out,
                             int tiles, int nc, float div) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nc) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += partial[static_cast<size_t>(t) * nc + i];
  out[i] = s / div;
}

inline cudaError_t launch_sum_partials(const float* partial, float* out, int tiles, int nc,
                                       float div, cudaStream_t stream) {
  sum_partials<<<(nc + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, out, tiles,
                                                                        nc, div);
  return cudaGetLastError();
}

}  // namespace udal
