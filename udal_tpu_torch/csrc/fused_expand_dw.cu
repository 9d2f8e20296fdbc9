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
// Two instances, one design around them: a block per (image, TH x TW
// output tile, CT expanded channels: 32 in bf16, 16 in f32), the channel
// tile fastest so blocks that read the same input pixels run together.
// The block first computes the expanded tile z for its output rows and
// halo, (TH-1)*S+K rows by (TW-1)*S+K columns, into shared memory, then
// runs the depthwise stencil, bias, activation and mask from there
// (depthwise_tile.cuh); the SE sum is a per-tile partial reduced by a
// second, deterministic kernel. The expanded tensor never goes to device
// memory. TF SAME pads z, not x: staged z outside the image is zero,
// written after the expand.
//
// bf16 (expand_dw_tc_kernel): the expand is a tensor-core product
// (mma_tile.cuh, the tile of packed_pointwise.cu), z^T [CT, pixels] =
// We^T [CT, Cin] . x [Cin, pixels]. The staged pixels are the x window
// widened to whole 16-byte groups (its left edge rounded down to a
// multiple of 8 columns), walked 256 at a time; for each such pass Cin
// streams through a ring of 16-channel stages filled by cp.async (zero
// fill outside the image and past Cin), so the loads run ahead of the
// products. We is f32 in the model: the host splits it into hi = bf16(We)
// and lo = bf16(We - hi), and every product runs twice, hi and lo, into
// the same f32 accumulators, so the expand keeps We to about 2^-16 and
// the plain version's tolerances hold. With 16-byte copies (W and Cin
// multiples of 8, the pointers aligned: every launch of the models) the
// weights ride the ring too (expand_dw_tc_kernel_streamed): each stage
// holds x's 16 channels and the same 16 channels of We^T's block rows, hi
// and lo, loaded in the same cp.async group, so z takes the whole block
// budget past the ring. Otherwise (plain loads, expand_dw_tc_kernel)
// We^T's block rows stay resident for the whole of Cin, 2 * 32 * (Cin + 8)
// values, which leave z less room as Cin grows (at Cin = 640 a 1x8 output
// tile, whose 72 staged pixels fill one 256-pixel pass for 8 outputs).
// Both run the same K-chunks in the same order into the same
// accumulators, so y is the same bit for bit. The accumulators take b0, the
// activation and m1, round once to bf16 and go to z; the depthwise then
// forms 4 or 8 outputs down a column per lane (depthwise_cols_epilogue).
// z's swish, rounded to bf16 next, is one tanh.approx (activate_bf16); the
// depthwise's, which also goes into the f32 SE sum, is the exact one.
//
// f32 (fused_expand_dw_kernel): CT = 16, the expand on CUDA cores: one
// thread per staged pixel keeps the 16 sums in registers and loops over
// Cin, reading x from device memory (L2) and the folded weights from
// shared memory. It carries the f32 checks.
//
// What bounds it: at d0's 1024x512 MC batch the 15 blocks move 4.1 GB (x
// in, y out), 1.2 ms at 3.35 TB/s, against 278 GFLOP of expand on tensor
// cores (0.3 ms; twice that with hi and lo) and 52 GFLOP of depthwise on
// CUDA cores (0.8 ms). The swishes a serve, about 2.8 G on z at one MUFU
// operation and 1.6 G on y at two, put a floor of about 1.4 ms beside it.
// On an H100 SXM at 700 W the 15 blocks take about 17 ms a serve: the
// swish and stencil epilogues and the barriers between a block's two
// phases, at 16 warps an SM, set it. Streaming the weights keeps d0's
// tiles and takes 1-8% off each of its blocks' time. At d7x's 1536x768
// (B7, B = 8, 51 launches, a bound of 2.29 ms) resident weights would
// leave tiles at Cin = 224-640 that recompute 3-32 times the expand and
// reload We^T and x from L2 for each small block: 128 ms a serve, 74 of
// them in the three Cin = 640 launches (1x8 tiles). Streamed, those take
// tiles of 8x64 to 16x48, at most 2.2 computed pixels an output, and a
// Cin = 640 launch 1.7 ms. The k5 launches stay at 2-3% of their bound,
// and a fourth ring stage gains only 3% there, so the ring's depth is not
// what limits them; the planner's tiles are not the fastest at every
// shape (8x48 beats its 16x32 at Cin = 384, k5).
#include "depthwise_tile.cuh"
#include "mma_tile.cuh"

namespace {

using udal::kThreads;
constexpr int kCT = 16;  // expanded channels a block computes

template <int K, int S>
__global__ void __launch_bounds__(kThreads)
fused_expand_dw_kernel(const float* __restrict__ x, const float* __restrict__ we,
                       const float* __restrict__ b0, const float* __restrict__ m1,
                       const float* __restrict__ wd, const float* __restrict__ b1,
                       const float* __restrict__ m2, float* __restrict__ y,
                       float* __restrict__ partial, int N, int Cin, int Ce, int H, int W, int Ho,
                       int Wo, int pad_t, int pad_l, int th, int tw, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_we = reinterpret_cast<float*>(smem);  // [Cin][kCT]
  float* s_z = s_we + Cin * kCT;  // [kCT][ih][iw]
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
      s_z[i] = 0.f;
    }
    __syncthreads();
  }
  const size_t hw = static_cast<size_t>(H) * W;
  const float* xn = x + static_cast<size_t>(pos.n) * Cin * hw;
  for (int i = threadIdx.x; i < (r1 - r0) * wi; i += kThreads) {
    const int r = r0 + i / wi;
    const int q = q0 + i % wi;
    float acc[kCT];
#pragma unroll
    for (int j = 0; j < kCT; ++j) acc[j] = 0.f;
    const float* xp = xn + static_cast<size_t>(gh0 + r) * W + gw0 + q;
#pragma unroll 4
    for (int ci = 0; ci < Cin; ++ci) {
      const float xv = xp[ci * hw];
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
      s_z[j * plane + p] = udal::activate(acc[j] + s_b0[j], act) * s_m1[j];
    }
  }
  __syncthreads();
  udal::depthwise_epilogue<float, K, S>(s_z, kCT, ih, iw, th, tw, pos, wd, nullptr, b1, m2, act, y,
                                    partial, N, Ce, Ho, Wo);
}

// the folded weights [Cin][kCT] and z [kCT][ih][iw], f32
size_t f32_smem_bytes(int cin, int ih, int iw) {
  return (static_cast<size_t>(cin) * kCT + static_cast<size_t>(kCT) * ih * iw) * sizeof(float);
}

template <int K, int S>
cudaError_t launch_f32(const void* x, const void* we, const void* b0, const void* m1,
                       const void* wd, const void* b1, const void* m2, void* y, void* partial,
                       int n, int cin, int ce, int h, int w, int ho, int wo, int pad_t,
                       int pad_l, int th, int tw, int act, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(cin, (th - 1) * S + K, (tw - 1) * S + K);
  const long long blocks = static_cast<long long>(n) * udal::ceil_div(ho, th) *
                           udal::ceil_div(wo, tw) * udal::ceil_div(ce, kCT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(fused_expand_dw_kernel<K, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_expand_dw_kernel<K, S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(we), static_cast<const float*>(b0),
      static_cast<const float*>(m1), static_cast<const float*>(wd),
      static_cast<const float*>(b1), static_cast<const float*>(m2), static_cast<float*>(y),
      static_cast<float*>(partial), n, cin, ce, h, w, ho, wo, pad_t, pad_l, th, tw, act);
  return cudaGetLastError();
}

// -- bf16: the expand on tensor cores ------------------------------------------

using udal::mma::bf16;
namespace mma = udal::mma;

constexpr int kTcCT = 32;    // expanded channels a block computes
constexpr int kKC = 16;      // input channels a ring stage holds: one k16 step
constexpr int kNP = 256;     // staged pixels a pass multiplies, 32 a warp
constexpr int kStages = 3;
constexpr int kLdb = kNP + 8;

// staged columns: the window of iw columns widened to whole 8-column groups
__host__ __device__ inline int tc_width(int iw) { return (iw + 14) / 8 * 8; }
// a channel's plane of staged z, padded to 8 mod 16 values so the eight
// channels of a fragment's rows store to distinct banks
__host__ __device__ inline int tc_plane(int ih, int iwx) {
  const int p = ih * iwx;
  return p % 16 == 0 ? p + 8 : p;
}
__host__ __device__ inline int tc_cinp(int cin) { return (cin + kKC - 1) / kKC * kKC; }

// A ring stage: x's kKC input channels of kNP staged pixels, [kKC][kLdb];
// with streamed weights We^T's same kKC channels for the block's kTcCT
// expanded ones follow, hi then lo, [2][kTcCT][kLdw]. Rows of kLdw values
// (48 bytes) put an ldmatrix's eight rows in distinct bank groups.
constexpr int kLdw = kKC + 8;
__host__ __device__ constexpr int tc_stage(bool streamed) {
  return kKC * kLdb + (streamed ? 2 * kTcCT * kLdw : 0);
}

// resident: We^T hi and lo for the whole of Cin, then the ring and z;
// streamed: the ring (which carries We^T a K-chunk a stage) and z
size_t tc_smem_bytes(bool streamed, int cin, int ih, int iw) {
  return ((streamed ? 0 : 2 * static_cast<size_t>(kTcCT) * (tc_cinp(cin) + 8)) +
          static_cast<size_t>(kStages) * tc_stage(streamed) +
          static_cast<size_t>(kTcCT) * tc_plane(ih, tc_width(iw))) *
         sizeof(bf16);
}

// The bf16 kernel's body. kVec: W and Cin multiples of 8 and x, we_hi,
// we_lo 16-byte aligned: 16-byte asynchronous copies, and We^T rides the
// ring with x, a K-chunk a stage. Otherwise plain loads, and We^T stays in
// shared memory for the whole of Cin.
template <int K, int S, bool kVec>
__device__ __forceinline__ void expand_dw_tc_body(
    unsigned char* smem, const bf16* __restrict__ x, const bf16* __restrict__ we_hi,
    const bf16* __restrict__ we_lo, const float* __restrict__ b0, const float* __restrict__ m1,
    const float* __restrict__ wd, const float* __restrict__ b1, const float* __restrict__ m2,
    bf16* __restrict__ y, float* __restrict__ partial, int N, int Cin, int Ce, int H, int W,
    int Ho, int Wo, int pad_t, int pad_l, int th, int tw, int act) {
  constexpr int kMI = kTcCT / 16, kNJ = 4;
  constexpr int kStage = tc_stage(kVec);
  const int cinp = tc_cinp(Cin);
  // the row stride of We^T's hi and lo; lo = hi + kTcCT * lda in both layouts
  const int lda = kVec ? kLdw : cinp + 8;
  bf16* s_we = reinterpret_cast<bf16*>(smem);  // resident: We^T, hi and lo [2][kTcCT][lda]
  bf16* s_ring = s_we + (kVec ? 0 : 2 * kTcCT * lda);  // [kStages][kStage]
  bf16* s_z = s_ring + kStages * kStage;  // [kTcCT][plane]
  __shared__ float s_b0[kTcCT];
  __shared__ float s_m1[kTcCT];

  const int ih = (th - 1) * S + K;
  const int iw = (tw - 1) * S + K;
  const int iwx = tc_width(iw);
  const int npix = ih * iwx;
  const int plane = tc_plane(ih, iwx);
  const udal::TilePos pos = udal::tile_pos(udal::ceil_div(Ce, kTcCT), udal::ceil_div(Ho, th),
                                           udal::ceil_div(Wo, tw), kTcCT, th, tw);
  const int gh0 = pos.oh0 * S - pad_t;
  const int gw0 = pos.ow0 * S - pad_l;
  const int gwa = gw0 & ~7;  // rounded down (also below zero)
  const int off = gw0 - gwa;  // z column q is staged column off + q

  // resident: the block's rows of We^T, zeros past Ce and Cin
  if constexpr (!kVec) {
    for (int i = threadIdx.x; i < kTcCT * cinp; i += kThreads) {
      const int m = i / cinp;
      const int k = i - m * cinp;
      const int e = pos.c0 + m;
      const bool valid = e < Ce && k < Cin;
      const size_t g = static_cast<size_t>(e) * Cin + k;
      s_we[m * lda + k] = valid ? we_hi[g] : __float2bfloat16(0.f);
      s_we[(kTcCT + m) * lda + k] = valid ? we_lo[g] : __float2bfloat16(0.f);
    }
  }
  if (threadIdx.x < kTcCT) {
    const int e = pos.c0 + threadIdx.x;
    s_b0[threadIdx.x] = e < Ce ? b0[e] : 0.f;
    s_m1[threadIdx.x] = (e < Ce && m1 != nullptr) ? m1[pos.n * Ce + e] : 1.f;
  }

  const size_t hw = static_cast<size_t>(H) * W;
  const bf16* xn = x + static_cast<size_t>(pos.n) * Cin * hw;
  const int chunks = cinp / kKC;
  const int total = udal::ceil_div(npix, kNP) * chunks;
  // stage j: input channels [kc * 16, +16) of staged pixels [pass * 256, +256),
  // and with 16-byte copies We^T's same 16 channels, zeros past Ce and Cin
  auto load = [&](int j) {
    const int pass = j / chunks;
    const int c0 = (j - pass * chunks) * kKC;
    bf16* dst = s_ring + (j % kStages) * kStage;
    if constexpr (kVec) {
      if (threadIdx.x < 2 * kTcCT * (kKC / 8)) {
        const int lo = threadIdx.x / (kTcCT * (kKC / 8));
        const int m = threadIdx.x / (kKC / 8) % kTcCT;
        const int k = threadIdx.x % (kKC / 8) * 8;
        const int e = pos.c0 + m;
        const bool valid = e < Ce && c0 + k < Cin;
        const bf16* src = lo ? we_lo : we_hi;
        mma::cp_async16(dst + kKC * kLdb + (lo * kTcCT + m) * kLdw + k,
                        valid ? src + static_cast<size_t>(e) * Cin + c0 + k : src, valid);
      }
      for (int i = threadIdx.x; i < kKC * (kNP / 8); i += kThreads) {
        const int kk = i / (kNP / 8);
        const int g = (i - kk * (kNP / 8)) * 8;
        const int ci = c0 + kk;
        const int p = pass * kNP + g;
        const int r = p / iwx;
        const int gh = gh0 + r;
        const int gw = gwa + (p - r * iwx);
        const bool valid = ci < Cin && p < npix && gh >= 0 && gh < H && gw >= 0 && gw < W;
        mma::cp_async16(dst + kk * kLdb + g,
                        valid ? xn + static_cast<size_t>(ci) * hw + static_cast<size_t>(gh) * W + gw
                              : x,
                        valid);
      }
    } else {
      for (int i = threadIdx.x; i < kKC * kNP; i += kThreads) {
        const int kk = i / kNP;
        const int pp = i - kk * kNP;
        const int ci = c0 + kk;
        const int p = pass * kNP + pp;
        const int r = p / iwx;
        const int gh = gh0 + r;
        const int gw = gwa + (p - r * iwx);
        const bool valid = ci < Cin && p < npix && gh >= 0 && gh < H && gw >= 0 && gw < W;
        const size_t at = static_cast<size_t>(ci) * hw + static_cast<size_t>(gh) * W + gw;
        dst[kk * kLdb + pp] = valid ? xn[at] : __float2bfloat16(0.f);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    mma::cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kMI][kNJ][4];
  mma::zero(acc);
  for (int j = 0; j < total; ++j) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage j has landed for every thread; stage j - 1 is free
    if (j + kStages - 1 < total) load(j + kStages - 1);
    mma::cp_async_commit();

    const int pass = j / chunks;
    const int kc = j - pass * chunks;
    const bf16* stage = s_ring + (j % kStages) * kStage;
    const bf16* a_hi = kVec ? stage + kKC * kLdb : s_we + kc * kKC;
    uint32_t b[kNJ][2];
    mma::load_b(b, stage + warp * 32, kLdb, lane);
    mma::mma_rows(acc, a_hi, lda, b, lane);
    mma::mma_rows(acc, a_hi + kTcCT * lda, lda, b, lane);
    if (kc != chunks - 1) continue;

    // z = act(acc + b0) * m1 for the pass's pixels, zero outside the image
    // and in the columns the depthwise does not read. A fragment's 8
    // columns are 8 pixels of one staged row (npix and iwx are multiples
    // of 8). Every value is computed and masked by a product, without
    // branches, so the 8 x MI independent activations of a lane interleave
    // (a branch per fragment, to skip the dead ones, measured slower).
    int zp[kNJ];
    float keep[kNJ][2];  // 1 where z is kept, 0 where it is the zero border
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      zp[jj] = pass * kNP + warp * 32 + jj * 8 + mma::frag_col(lane);
      const int r = zp[jj] / iwx;
      const int c = zp[jj] - r * iwx;
      const bool row_in = gh0 + r >= 0 && gh0 + r < H;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        keep[jj][e] = (row_in && c + e >= off && c + e < off + iw && gwa + c + e >= 0 &&
                       gwa + c + e < W)
                          ? 1.f
                          : 0.f;
      }
    }
    udal::with_activation(act, [&](auto tag) {
      constexpr int A = decltype(tag)::kAct;
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = i * 16 + mma::frag_row(lane, 2 * h);
          const float bm = s_b0[m], mm = s_m1[m];
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj) {
            const float v0 =
                udal::activate_bf16<A>(acc[i][jj][2 * h] + bm, act) * (mm * keep[jj][0]);
            const float v1 =
                udal::activate_bf16<A>(acc[i][jj][2 * h + 1] + bm, act) * (mm * keep[jj][1]);
            if (zp[jj] < npix) {
              *reinterpret_cast<uint32_t*>(s_z + m * plane + zp[jj]) = mma::pack2(v0, v1);
            }
          }
        }
    });
    mma::zero(acc);
  }
  mma::cp_async_wait<0>();
  __syncthreads();
  udal::with_activation(act, [&](auto tag) {
    if (th % 8 == 0) {
      udal::depthwise_cols_epilogue<decltype(tag)::kAct, K, S, 8>(
          s_z, kTcCT, plane, iwx, off, ih, th, tw, pos, wd, b1, m2, act, y, partial, N, Ce, Ho,
          Wo);
    } else {
      udal::depthwise_cols_epilogue<decltype(tag)::kAct, K, S, 4>(
          s_z, kTcCT, plane, iwx, off, ih, th, tw, pos, wd, b1, m2, act, y, partial, N, Ce, Ho,
          Wo);
    }
  });
}

#define UDAL_TC_PARAMS                                                                     \
  const bf16 *__restrict__ x, const bf16 *__restrict__ we_hi, const bf16 *__restrict__ we_lo, \
      const float *__restrict__ b0, const float *__restrict__ m1,                            \
      const float *__restrict__ wd, const float *__restrict__ b1,                            \
      const float *__restrict__ m2, bf16 *__restrict__ y, float *__restrict__ partial, int N, \
      int Cin, int Ce, int H, int W, int Ho, int Wo, int pad_t, int pad_l, int th, int tw,   \
      int act
#define UDAL_TC_ARGS                                                                       \
  x, we_hi, we_lo, b0, m1, wd, b1, m2, y, partial, N, Cin, Ce, H, W, Ho, Wo, pad_t, pad_l, th, \
      tw, act

// plain loads, We^T resident
template <int K, int S>
__global__ void __launch_bounds__(kThreads, 2) expand_dw_tc_kernel(UDAL_TC_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem[];
  expand_dw_tc_body<K, S, false>(smem, UDAL_TC_ARGS);
}

// 16-byte copies, We^T streamed: an entry of its own, so a trace tells the
// two apart
template <int K, int S>
__global__ void __launch_bounds__(kThreads, 2) expand_dw_tc_kernel_streamed(UDAL_TC_PARAMS) {
  extern __shared__ __align__(128) unsigned char smem[];
  expand_dw_tc_body<K, S, true>(smem, UDAL_TC_ARGS);
}
#undef UDAL_TC_ARGS
#undef UDAL_TC_PARAMS

template <int K, int S, bool kVec>
cudaError_t launch_tc(const void* x, const void* we_hi, const void* we_lo, const void* b0,
                      const void* m1, const void* wd, const void* b1, const void* m2, void* y,
                      void* partial, int n, int cin, int ce, int h, int w, int ho, int wo,
                      int pad_t, int pad_l, int th, int tw, int act, cudaStream_t stream) {
  const auto kernel = [] {
    if constexpr (kVec) {
      return expand_dw_tc_kernel_streamed<K, S>;
    } else {
      return expand_dw_tc_kernel<K, S>;
    }
  }();
  const size_t smem = tc_smem_bytes(kVec, cin, (th - 1) * S + K, (tw - 1) * S + K);
  const long long blocks = static_cast<long long>(n) * udal::ceil_div(ho, th) *
                           udal::ceil_div(wo, tw) * udal::ceil_div(ce, kTcCT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(we_hi),
      static_cast<const bf16*>(we_lo), static_cast<const float*>(b0),
      static_cast<const float*>(m1), static_cast<const float*>(wd),
      static_cast<const float*>(b1), static_cast<const float*>(m2), static_cast<bf16*>(y),
      static_cast<float*>(partial), n, cin, ce, h, w, ho, wo, pad_t, pad_l, th, tw, act);
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory of a block of the f32 (bf16 == 0) or bf16
// kernel, the latter with We^T resident (streamed == 0, plain loads) or
// streamed (16-byte copies), at an output tile of th x tw: what the host's
// tile planner (ops/fused_mbconv.py) models, checked against this before a
// launch.
extern "C" long long udal_fused_expand_dw_smem(int bf16, int streamed, int cin, int th, int tw,
                                               int k, int stride) {
  const int ih = (th - 1) * stride + k, iw = (tw - 1) * stride + k;
  return static_cast<long long>(bf16 ? tc_smem_bytes(streamed != 0, cin, ih, iw)
                                     : f32_smem_bytes(cin, ih, iw));
}

// x [n, cin, h, w] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); b0
// [ce], wd [ce, k, k], b1 [ce] f32; m1, m2 [n, ce] f32 or null; y [n, ce,
// ho, wo] in x's type; se_sum [n, ce] f32; `partial` f32 scratch of
// ceil(ho/th) * ceil(wo/tw) * n * ce values. f32 takes we [cin, ce] f32;
// bf16 takes we_hi, we_lo [ce, cin] bf16 (We^T split in two) and vec (w and
// cin multiples of 8, x, we_hi, we_lo 16-byte aligned: 16-byte copies, We^T
// streamed through the ring with x). k in {3, 5},
// stride in {1, 2}; (pad_t, pad_l) are TF SAME's leading pads. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int udal_fused_expand_dw(const void* x, const void* we, const void* we_hi,
                                    const void* we_lo, const void* b0, const void* m1,
                                    const void* wd, const void* b1, const void* m2, void* y,
                                    void* partial, void* se_sum, int bf16, int n, int cin, int ce,
                                    int h, int w, int k, int stride, int ho, int wo, int pad_t,
                                    int pad_l, int th, int tw, int vec, int act, void* stream) {
  if (n <= 0 || cin <= 0 || ce <= 0 || ho <= 0 || wo <= 0 || th <= 0 || tw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define UDAL_EDW_F32(KK, SS)                                                                  \
  if (!bf16 && k == KK && stride == SS)                                                       \
    err = launch_f32<KK, SS>(x, we, b0, m1, wd, b1, m2, y, partial, n, cin, ce, h, w, ho, wo, \
                             pad_t, pad_l, th, tw, act, s);
#define UDAL_EDW_TC(KK, SS, V)                                                                \
  if (bf16 && vec == V && k == KK && stride == SS)                                            \
    err = launch_tc<KK, SS, V>(x, we_hi, we_lo, b0, m1, wd, b1, m2, y, partial, n, cin,   \
                                   ce, h, w, ho, wo, pad_t, pad_l, th, tw, act, s);
#define UDAL_EDW_TC_ALL(KK, SS) \
  UDAL_EDW_TC(KK, SS, 0)        \
  UDAL_EDW_TC(KK, SS, 1)
  UDAL_EDW_F32(3, 1)
  UDAL_EDW_F32(3, 2)
  UDAL_EDW_F32(5, 1)
  UDAL_EDW_F32(5, 2)
  UDAL_EDW_TC_ALL(3, 1)
  UDAL_EDW_TC_ALL(3, 2)
  UDAL_EDW_TC_ALL(5, 1)
  UDAL_EDW_TC_ALL(5, 2)
#undef UDAL_EDW_TC_ALL
#undef UDAL_EDW_TC
#undef UDAL_EDW_F32
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = udal::ceil_div(ho, th) * udal::ceil_div(wo, tw);
  return static_cast<int>(udal::launch_sum_partials(static_cast<const float*>(partial),
                                                    static_cast<float*>(se_sum), tiles, n * ce,
                                                    1.f, s));
}
