// Greedy (soft-)NMS for Hopper (sm_90a): one thread-block cluster per image.
//
// Replaces the TPU kernel udal_tpu/ops/pallas_nms.py:_nms_kernel, and
// computes exactly what it and udal_tpu_torch/ops/nms.py:greedy_picks
// compute (TF NonMaxSuppressionV5 semantics), with the same expressions in
// the same order. Built with --fmad=false and without fast math, so that
// `area + barea - inter` is never contracted into an FMA: the picks then
// equal the plain PyTorch version's, index for index.
//
// What bounds it: latency. The K picks depend on each other: each is an
// argmax over the N working scores, then a decay of all of them against
// the pick. The operations are few (about 1 us of the card's f32 rate at
// B = 8, N = 5000, K = 100); the time is K times the latency of one pick.
// A block per image leaves 124 of 132 SMs idle at batch 8 and gives each
// thread several candidates and each pick a two-level block reduction.
//
// Design: a cluster of kCluster = 8 blocks (the blocks of a cluster run at
// once on one GPC and reach each other's shared memory) holds one image.
// Block r owns the shard [r * shard, min((r + 1) * shard, n)) of its
// candidates, one a thread (n <= 8 * 1024): each thread keeps its
// candidate's box, area and working score in registers, and the shard's
// boxes also sit in shared memory. One pick:
//   1. the block's argmax over the key (score, -index): each warp with
//      redux.sync (the largest order-preserving unsigned key of the score,
//      then the smallest index among the lanes at that key), the warp
//      winners through shared memory and one __syncthreads to warp 0,
//      which reduces them the same way;
//   2. warp 0 pushes the block's winner (key, index, box: 32 bytes) into
//      its slot in every block of the cluster, lane r to block r, with
//      st.async, which also counts the bytes on block r's transaction
//      barrier (mbarrier) of this pick's parity;
//   3. every thread waits on its own block's barrier until all kCluster
//      winners have landed there, and thread 0 re-arms it for pick i + 2;
//   4. every warp reduces the kCluster slots from its own shared memory:
//      (score, -index) is a total order, so every block reaches the same
//      pick, whatever the split, with no second round;
//   5. each thread decays its candidate against the pick's box.
// The slots and barriers are double-buffered by the pick's parity: a block
// pushes pick i + 2 only after every block's pick i + 1 has reached it,
// which each block sends after it has read pick i. Pushing the winners
// where they are read replaces the first design's cluster barrier over
// every thread and the reads of remote shared memory after it, which took
// half of each pick's time. Cluster barriers remain only before the first
// pick (every block's barriers armed) and after the last. Clusters of 16
// blocks measured level with 8 and clusters of 4 slower (PERF.md). Nothing
// is allocated here; the caller passes the outputs and the stream.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mbarrier.cuh"

namespace {

using udal::smem_u32;

constexpr int kCluster = 8;        // blocks a cluster, one cluster an image
constexpr int kMaxThreads = 1024;  // threads a block, one candidate each
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
constexpr float kNegInf = -1e10f;  // a dead candidate, as NEG_INF in ops/nms.py

// A block's winner of one pick, as every block of the cluster receives it
struct __align__(16) Slot {
  uint4 head;  // (key, index, -, -)
  uint4 box;   // (y1, x1, y2, x2) as bits
};

// An unsigned key in the order of the scores; -0 counts as +0, as the
// comparison of floats has it. 0 is below every score (-inf is 0x007fffff).
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = s == 0.f ? 0u : __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The warp's best (key, index): the largest key, then the smallest index
// among the lanes that hold it. Every lane gets the result.
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == top ? idx : kNoIndex);
  key = top;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives; the writes before it
// become visible to the reads after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of this block's shared `addr` in block `rank`'s shared memory
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Stores a slot's 32 bytes into block `rank`'s copy of `slot` and counts
// them on block `rank`'s barrier `bar` (both given by this block's address).
__device__ __forceinline__ void push_slot(const Slot* slot, uint64_t* bar, unsigned rank,
                                          uint4 head, uint4 box) {
  const unsigned dst = map_rank(smem_u32(slot), rank);
  const unsigned rbar = map_rank(smem_u32(bar), rank);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst), "r"(head.x), "r"(head.y), "r"(head.z), "r"(head.w), "r"(rbar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst + 16), "r"(box.x), "r"(box.y), "r"(box.z), "r"(box.w), "r"(rbar)
      : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
soft_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                int32_t* __restrict__ out_idx, float* __restrict__ out_score, int n, int shard,
                int k, float iou_thr, float score_thr, float sigma) {
  extern __shared__ float4 s_boxes[];  // [shard] the block's boxes (y1, x1, y2, x2)
  __shared__ unsigned s_wkey[kMaxWarps];
  __shared__ unsigned s_widx[kMaxWarps];
  __shared__ Slot s_slot[2][kCluster];         // every block's winner, by the pick's parity
  __shared__ __align__(8) uint64_t s_full[2];  // complete when s_slot[parity] is

  const unsigned rank = cluster_rank();
  const int image = static_cast<int>(cluster_id());
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = static_cast<int>(rank) * shard;
  const int count = max(0, min(shard, n - base));  // candidates this block owns
  const int j = base + tid;                         // this thread's candidate
  const bool mine = tid < count;
  boxes += static_cast<size_t>(image) * n + base;
  scores += static_cast<size_t>(image) * n + base;
  out_idx += static_cast<size_t>(image) * k;
  out_score += static_cast<size_t>(image) * k;
  constexpr unsigned kSlotsBytes = kCluster * sizeof(Slot);
  if (tid == 0) {
    udal::mbarrier_init(&s_full[0]);
    udal::mbarrier_init(&s_full[1]);
    udal::mbarrier_expect(&s_full[0], kSlotsBytes);
    udal::mbarrier_expect(&s_full[1], kSlotsBytes);
  }

  // past the shard: never picked, never updated
  float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
  float work = -INFINITY;
  if (mine) {
    box = boxes[tid];
    work = scores[tid];
    s_boxes[tid] = box;
  }
  const float area = fmaxf(box.z - box.x, 0.f) * fmaxf(box.w - box.y, 0.f);
  // every block's barriers are armed and its boxes staged before any push
  cluster_barrier();

  for (int i = 0; i < k; ++i) {
    const int par = i & 1;
    // 1. the block's winner; an empty thread holds the key 0 (below every score)
    unsigned key = mine ? order_key(work) : 0u;
    unsigned idx = mine ? static_cast<unsigned>(j) : kNoIndex;
    warp_best(key, idx);
    if (lane == 0) {
      s_wkey[warp] = key;
      s_widx[warp] = idx;
    }
    __syncthreads();
    // 2. warp 0 pushes it into every block's slot of this pick: lane r to block r
    if (warp == 0) {
      key = lane < warps ? s_wkey[lane] : 0u;
      idx = lane < warps ? s_widx[lane] : kNoIndex;
      warp_best(key, idx);
      if (lane < kCluster) {
        const int local = static_cast<int>(idx) - base;
        const float4 b = local >= 0 && local < count ? s_boxes[local] : make_float4(0, 0, 0, 0);
        push_slot(&s_slot[par][rank], &s_full[par], lane, make_uint4(key, idx, 0u, 0u),
                  make_uint4(__float_as_uint(b.x), __float_as_uint(b.y), __float_as_uint(b.z),
                             __float_as_uint(b.w)));
      }
    }
    // 3. wait until every block's winner has landed here; re-arm for pick i + 2
    udal::mbarrier_wait<true>(&s_full[par], (i >> 1) & 1);
    if (tid == 0) udal::mbarrier_expect(&s_full[par], kSlotsBytes);
    // 4. the cluster's winner, in every warp, from the block's own copy
    unsigned ckey = 0u, cidx = kNoIndex;
    uint4 cbox = make_uint4(0u, 0u, 0u, 0u);
    if (lane < kCluster) {
      ckey = s_slot[par][lane].head.x;
      cidx = s_slot[par][lane].head.y;
      cbox = s_slot[par][lane].box;
    }
    const unsigned top = __reduce_max_sync(kFull, ckey);
    const unsigned pick = __reduce_min_sync(kFull, ckey == top ? cidx : kNoIndex);
    const int src = __ffs(__ballot_sync(kFull, ckey == top && cidx == pick)) - 1;
    const float4 bb = make_float4(__uint_as_float(__shfl_sync(kFull, cbox.x, src)),
                                  __uint_as_float(__shfl_sync(kFull, cbox.y, src)),
                                  __uint_as_float(__shfl_sync(kFull, cbox.z, src)),
                                  __uint_as_float(__shfl_sync(kFull, cbox.w, src)));
    if (rank == 0 && tid == 0) {
      out_idx[i] = static_cast<int32_t>(pick);
      out_score[i] = key_score(top);
    }

    // 5. decay the thread's candidate
    if (mine) {
      const float barea = fmaxf(bb.z - bb.x, 0.f) * fmaxf(bb.w - bb.y, 0.f);
      const float inter = fmaxf(fminf(box.z, bb.z) - fmaxf(box.x, bb.x), 0.f) *
                          fmaxf(fminf(box.w, bb.w) - fmaxf(box.y, bb.y), 0.f);
      const float uni = area + barea - inter;
      const float iou = uni > 0.f ? inter / fmaxf(uni, 1e-12f) : 0.f;
      float weight;
      if (sigma > 0.f) {
        weight = iou <= iou_thr ? expf(-(iou * iou) / sigma) : 0.f;
      } else {
        weight = iou <= iou_thr ? 1.f : 0.f;
      }
      const float decayed = work * weight;
      const bool dead = weight == 0.f || decayed < score_thr || j == static_cast<int>(pick);
      work = dead ? kNegInf : decayed;
    }
  }
  cluster_barrier();  // no block leaves while a push to it may be in flight
}

}  // namespace

// boxes [batch, n, 4] f32 (y1, x1, y2, x2), scores [batch, n] f32, both
// contiguous; out_idx [batch, k] int32 and out_score [batch, k] f32 receive
// the K picks in order (an exhausted pool yields -1e10 picks). A cluster of
// kCluster blocks holds an image, each block a shard of ceil(n / kCluster)
// candidates, one a thread: n <= kCluster * kMaxThreads. Returns the CUDA
// error code of the launch (0 on success); a cluster the card cannot
// schedule is an error.
extern "C" int udal_soft_nms(const void* boxes, const void* scores, void* out_idx,
                             void* out_score, int batch, int n, int k, float iou_thr,
                             float score_thr, float sigma, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int shard = (n + kCluster - 1) / kCluster;
  if (shard > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(shard) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(soft_nms_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch) * kCluster);
  config.blockDim = dim3((shard + 31) / 32 * 32);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, soft_nms_kernel, static_cast<const float4*>(boxes),
                           static_cast<const float*>(scores), static_cast<int32_t*>(out_idx),
                           static_cast<float*>(out_score), n, shard, k, iou_thr, score_thr,
                           sigma);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
