// Shared pieces of the fused depthwise kernels (fused_dw.cu and
// fused_expand_dw.cu): conversions, the activations, the depthwise
// stencils with their epilogues over a tile staged in shared memory, and
// the deterministic reduction of the per-tile SE partial sums.
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

// For values rounded to bf16 next and used nowhere else (8 significant
// bits): swish as v/2 + v/2 tanh(v/2), one MUFU operation (tanh.approx,
// about 2^-11 relative) where exp and a reciprocal take two. Only the
// tensor-core expand kernel's z takes it; its swishes set that kernel's
// floor. A = kAnyAct takes the activation `act` at run time.
constexpr int kAnyAct = -1;

template <int A>
__device__ __forceinline__ float activate_bf16(float v, int act) {
  if constexpr (A == kSwish) {
    const float h = 0.5f * v;
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
    return fmaf(h, t, h);
  } else {
    return activate(v, act);
  }
}

template <int A>
struct ActTag {
  static constexpr int kAct = A;
};

// f(ActTag<kSwish>{}) for swish, the model's activation, else
// f(ActTag<kAnyAct>{}): a generic lambda gets the activation as a constant
// (decltype(tag)::kAct), so its unrolled loops hold one compact copy of
// swish; a runtime switch in each unrolled copy scatters the code of every
// case through the loop and thrashes the instruction cache
template <typename F>
__device__ __forceinline__ void with_activation(int act, F&& f) {
  if (act == kSwish) {
    f(ActTag<kSwish>{});
  } else {
    f(ActTag<kAnyAct>{});
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

// The same stencil and epilogue with each lane on kSeg (4 or 8) outputs
// down a column: the lane reads the (kSeg-1)*S+K staged values of each of
// the K columns once into registers and forms the kSeg outputs from them (the
// per-pixel stencil above reads K*K values an output). Lanes take
// neighbouring columns, so a warp's loads fall in distinct banks and its
// stores coalesce; rows past the staged tile are not read. One warp per
// channel as above; the SE partial is the lanes' sums reduced in a fixed
// order. No scale (it is folded into the taps). The activation is the exact
// one (activate, specialised to A when A is not kAnyAct): its values also go
// into the f32 SE sum, which is not rounded to bf16.
template <int A, int K, int S, int kSeg>
__device__ __forceinline__ void depthwise_cols_epilogue(
    const __nv_bfloat16* __restrict__ s_in, int ct, int plane, int row, int col0, int ih,
    int th, int tw, const TilePos& pos, const float* __restrict__ taps,
    const float* __restrict__ bias, const float* __restrict__ mask,
    int act, __nv_bfloat16* __restrict__ y, float* __restrict__ partial, int N, int C, int Ho,
    int Wo) {
  constexpr int kSpan = (kSeg - 1) * S + K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = ceil_div(th, kSeg);
  for (int cl = warp; cl < ct; cl += kWarps) {
    const int c = pos.c0 + cl;
    if (c >= C) break;
    float w[K * K];
#pragma unroll
    for (int i = 0; i < K * K; ++i) w[i] = __ldg(taps + c * K * K + i);
    const float bi = __ldg(bias + c);
    const float mk = mask != nullptr ? __ldg(mask + pos.n * C + c) : 1.f;
    const __nv_bfloat16* src = s_in + static_cast<size_t>(cl) * plane + col0;
    __nv_bfloat16* dst = y + static_cast<size_t>(pos.n * C + c) * Ho * Wo;
    float sum = 0.f;
    for (int it = lane; it < groups * tw; it += 32) {
      const int g = it / tw;
      const int q = it - g * tw;
      const int r0 = g * kSeg;
      const int ow = pos.ow0 + q;
      if (ow >= Wo) continue;
      float acc[kSeg];
#pragma unroll
      for (int o = 0; o < kSeg; ++o) acc[o] = 0.f;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const __nv_bfloat16* cp = src + r0 * S * row + q * S + dx;
        float v[kSpan];
#pragma unroll
        for (int i = 0; i < kSpan; ++i) {
          v[i] = r0 * S + i < ih ? __bfloat162float(cp[i * row]) : 0.f;
        }
#pragma unroll
        for (int o = 0; o < kSeg; ++o)
#pragma unroll
          for (int dy = 0; dy < K; ++dy) acc[o] += v[o * S + dy] * w[dy * K + dx];
      }
      const int valid = min(min(kSeg, th - r0), Ho - pos.oh0 - r0);
#pragma unroll
      for (int o = 0; o < kSeg; ++o) {
        const float out = activate(acc[o] + bi, A == kAnyAct ? act : A) * mk;
        if (o < valid) {
          dst[static_cast<size_t>(pos.oh0 + r0 + o) * Wo + ow] = __float2bfloat16(out);
          sum += out;
        }
      }
    }
    if (partial != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) partial[static_cast<size_t>(pos.tile) * N * C + pos.n * C + c] = sum;
    }
  }
}

// Two neighbouring output values of a row, rounded to T, stored as one
// vector (float2, or bf16x2 rounded to nearest even): p is 8- or 4-byte
// aligned.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The column-segment stencil of depthwise_cols_epilogue for any staged type
// and with the BN scale: one lane forms kSeg outputs down each of two
// neighbouring output columns (q, q + 1). `src` is the staged value under
// tap (0, 0) of output (r0, q), `row` the staged row stride; the lane loads
// each staged value the two columns' windows cover ((kSeg-1)*S+K rows of
// S+K columns) once into registers. It stores v = act(acc * scale + bias)
// * mask of the first `rows` rows as pairs to `dst` (output (r0, q), row
// stride Wo; q and Wo even) and returns the f32 sum of the stored values.
// The activation is the exact one (activate, specialised to A when A is not
// kAnyAct), as v also goes into the f32 SE mean.
template <typename T, int A, int K, int S, int kSeg>
__device__ __forceinline__ float depthwise_pair_cols(const T* __restrict__ src, int row,
                                                     const float (&w)[K * K], float sc, float bi,
                                                     float mk, int act, T* __restrict__ dst,
                                                     int Wo, int rows) {
  constexpr int kSpan = (kSeg - 1) * S + K;
  float acc[2][kSeg];
#pragma unroll
  for (int o = 0; o < kSeg; ++o) acc[0][o] = acc[1][o] = 0.f;
#pragma unroll
  for (int c = 0; c < S + K; ++c) {
    float v[kSpan];
#pragma unroll
    for (int i = 0; i < kSpan; ++i) v[i] = to_float(src[i * row + c]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dx = c - h * S;  // the tap of column q + h this staged column meets
      if (dx < 0 || dx >= K) continue;
#pragma unroll
      for (int o = 0; o < kSeg; ++o)
#pragma unroll
        for (int dy = 0; dy < K; ++dy) acc[h][o] += v[o * S + dy] * w[dy * K + dx];
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int o = 0; o < kSeg; ++o) {
    const float a = activate(acc[0][o] * sc + bi, A == kAnyAct ? act : A) * mk;
    const float b = activate(acc[1][o] * sc + bi, A == kAnyAct ? act : A) * mk;
    if (o < rows) {
      store_pair(dst + static_cast<size_t>(o) * Wo, a, b);
      sum += a + b;
    }
  }
  return sum;
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
