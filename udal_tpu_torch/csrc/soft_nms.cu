// Greedy (soft-)NMS for Hopper (sm_90a): one thread block per image.
//
// Replaces the TPU kernel udal_tpu/ops/pallas_nms.py:_nms_kernel, and
// computes exactly what it and udal_tpu_torch/ops/nms.py:greedy_picks
// compute (TF NonMaxSuppressionV5 semantics), with the same expressions in
// the same order. Built with --fmad=false and without fast math, so that
// `area + barea - inter` is never contracted into an FMA: the picks then
// equal the plain PyTorch version's, index for index.
//
// Design: a 1024-thread block holds one image's candidates for all K picks.
// Each thread keeps up to PER candidates (box, area, working score) in
// registers, strided by the block size so the 16-byte box loads coalesce;
// the boxes are also copied to dynamic shared memory so every thread can
// read the pick's box after the argmax. Each pick is a block-wide argmax
// over the key (score, -index): warp shuffles, then one warp over the 32
// warp results. Thread 0 writes the output slot. Nothing is allocated here;
// the caller passes the outputs and the stream.
//
// What bounds it: latency. K = 100 dependent block reductions run on one SM
// per image, so a batch of 8 fills 8 of the 132 SMs. The later lever is a
// thread-block cluster that splits an image's candidates across the SMs of
// a cluster and reduces through distributed shared memory.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e10f;  // a dead candidate, as NEG_INF in ops/nms.py

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bs, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, bs, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads, 1)
soft_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                int32_t* __restrict__ out_idx, float* __restrict__ out_score,
                int n, int k, float iou_thr, float score_thr, float sigma) {
  extern __shared__ float4 s_boxes[];  // [n] (y1, x1, y2, x2)
  __shared__ float s_wscore[kWarps];
  __shared__ int s_widx[kWarps];
  __shared__ int s_best;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  boxes += static_cast<size_t>(blockIdx.x) * n;
  scores += static_cast<size_t>(blockIdx.x) * n;
  out_idx += static_cast<size_t>(blockIdx.x) * k;
  out_score += static_cast<size_t>(blockIdx.x) * k;

  float y1[PER], x1[PER], y2[PER], x2[PER], area[PER], work[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = tid + p * kThreads;
    if (j < n) {
      const float4 b = boxes[j];
      y1[p] = b.x;
      x1[p] = b.y;
      y2[p] = b.z;
      x2[p] = b.w;
      area[p] = fmaxf(b.z - b.x, 0.f) * fmaxf(b.w - b.y, 0.f);
      work[p] = scores[j];
      s_boxes[j] = b;
    } else {
      // the ragged edge: never picked, never updated
      y1[p] = x1[p] = y2[p] = x2[p] = area[p] = 0.f;
      work[p] = -INFINITY;
    }
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    float bs = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int j = tid + p * kThreads;
      if (better(work[p], j, bs, bi)) {
        bs = work[p];
        bi = j;
      }
    }
    warp_argmax(bs, bi);
    if (lane == 0) {
      s_wscore[warp] = bs;
      s_widx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = s_wscore[lane];
      bi = s_widx[lane];
      warp_argmax(bs, bi);
      if (lane == 0) {
        s_best = bi;
        out_idx[i] = bi;
        out_score[i] = bs;
      }
    }
    __syncthreads();

    const int best = s_best;
    const float4 bb = s_boxes[min(best, n - 1)];
    const float barea = fmaxf(bb.z - bb.x, 0.f) * fmaxf(bb.w - bb.y, 0.f);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int j = tid + p * kThreads;
      if (j >= n) continue;
      const float inter = fmaxf(fminf(y2[p], bb.z) - fmaxf(y1[p], bb.x), 0.f) *
                          fmaxf(fminf(x2[p], bb.w) - fmaxf(x1[p], bb.y), 0.f);
      const float uni = area[p] + barea - inter;
      const float iou = uni > 0.f ? inter / fmaxf(uni, 1e-12f) : 0.f;
      float weight;
      if (sigma > 0.f) {
        weight = iou <= iou_thr ? expf(-(iou * iou) / sigma) : 0.f;
      } else {
        weight = iou <= iou_thr ? 1.f : 0.f;
      }
      const float decayed = work[p] * weight;
      const bool dead = weight == 0.f || decayed < score_thr || j == best;
      work[p] = dead ? kNegInf : decayed;
    }
  }
}

template <int PER>
cudaError_t launch(const void* boxes, const void* scores, void* out_idx, void* out_score,
                   int batch, int n, int k, float iou_thr, float score_thr, float sigma,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(soft_nms_kernel<PER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  soft_nms_kernel<PER><<<batch, kThreads, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<int32_t*>(out_idx), static_cast<float*>(out_score), n, k, iou_thr,
      score_thr, sigma);
  return cudaGetLastError();
}

}  // namespace

// boxes [batch, n, 4] f32 (y1, x1, y2, x2), scores [batch, n] f32, both
// contiguous; out_idx [batch, k] int32 and out_score [batch, k] f32 receive
// the K picks in order (an exhausted pool yields -1e10 picks). n <= 8192.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int udal_soft_nms(const void* boxes, const void* scores, void* out_idx,
                             void* out_score, int batch, int n, int k, float iou_thr,
                             float score_thr, float sigma, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (per <= 1) {
    err = launch<1>(boxes, scores, out_idx, out_score, batch, n, k, iou_thr, score_thr, sigma, s);
  } else if (per <= 2) {
    err = launch<2>(boxes, scores, out_idx, out_score, batch, n, k, iou_thr, score_thr, sigma, s);
  } else if (per <= 4) {
    err = launch<4>(boxes, scores, out_idx, out_score, batch, n, k, iou_thr, score_thr, sigma, s);
  } else if (per <= 5) {
    err = launch<5>(boxes, scores, out_idx, out_score, batch, n, k, iou_thr, score_thr, sigma, s);
  } else if (per <= 8) {
    err = launch<8>(boxes, scores, out_idx, out_score, batch, n, k, iou_thr, score_thr, sigma, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
