// Fused separable conv for Hopper (sm_90a): the BiFPN nodes' and the
// heads' SeparableConv with what follows it at inference, in one pass:
//   y[n, co, p] = post(s[co] * sum_ci W[co, ci] * dw_ci(pre(x))[n, ci, p] + t[co])
//                 * mask[n, co]
// dw the 3x3 stride-1 depthwise with TF SAME padding, pre and post an
// activation or the identity, (s, t) the pointwise bias folded with the
// inference BatchNorm that follows it (ones and the bias for a predict
// conv), mask the optional f32 [N, Cout] channel-dropout multiplier. It
// computes what udal_tpu_torch/ops/fused_sepconv.py:fused_sepconv_plain
// computes.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to
// XLA. Unfused, the port ran them as ATen's NCHW depthwise, cuDNN's 1x1
// conv, a BatchNorm, the activation and the mask multiply, five passes
// over device memory a conv; here the depthwise output never leaves the
// SM.
//
// Design. The global rows g = n * H + y of the NCHW tensor are cut into
// bands of TH rows and TW columns (a band may span images: a level of 4
// rows fills a block with 8 images), and the Cout outputs into slices of
// 64, 128 or 384 (Cfg; the 384-wide block has 16 warps, so d7x's towers
// stage and convolve their input once); a block per (band, slice), the
// slice fastest so the blocks that stage the same input run together.
// Cin streams through a two-stage ring of 32-channel chunks filled by
// cp.async (zero fill outside the tensor): each chunk holds the band's
// TH + 2 rows by TW + halo columns of x and the slice's rows of W. For a
// chunk the block applies `pre` in place (rounded to x's type, as the
// unfused chain rounds it), computes the depthwise in f32 from the staged
// rows, rounds it to bf16 into a [32][pixels] tile in shared memory (a
// row whose neighbour lies in another image, or outside it, takes no tap
// from it), and multiplies W's chunk by that tile on tensor cores
// (mma.sync m16n8k16, f32 accumulators, mma_tile.cuh), while the next
// chunk's copies land. The epilogue applies s, t, `post` and the mask in
// f32, rounds once to bf16 into an output tile over the ring, and stores
// the tile's rows in 16-byte runs. bf16 only: f32 activations run the
// unfused chain, which was faster than a CUDA-core product of the same
// staging.
//
// What bounds it: the input read once and the output written once. At
// d0's heads (C = 64) the 1x1 product is 128 operations a value moved,
// far below the card's ridge, so the bound is the bytes: 0.27 ms a tower
// layer at T*B = 320 over five levels of 1024x512 at 3.35 TB/s. At d7x
// (C = 384) it is 384 operations a byte, near the ridge. Measured on an
// H100 a tower layer takes about 1.0 ms at d0 (T*B = 320) and 7.4 ms at
// d7x (T*B = 80): the instructions of the depthwise (nine taps from three
// 32-bit loads a row for two outputs, converted to f32) and of the
// epilogue, and the barriers between a chunk's copies, depthwise and
// product, each a third or so; the halo rows are staged twice.
#include "depthwise_tile.cuh"
#include "mma_tile.cuh"

namespace {

using udal::ceil_div;
using udal::mma::bf16;
namespace mma = udal::mma;

constexpr int kKC = 32;        // input channels a chunk: two k16 steps
constexpr int kStages = 2;     // chunks in the ring
constexpr int kLdw = kKC + 8;  // row stride of a W chunk [kMb][kLdw]
constexpr int kLeft = 8;       // staged column of the band's first image column

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
// pixels a staged row holds: the band's columns rounded up to pairs
__host__ __device__ inline int pair_width(int tw) { return tw + (tw & 1); }
// staged columns a row: image columns [c0 - kLeft, c0 - kLeft + width),
// room for the reads of the last pair (its columns + 1 and + 2) in whole
// 16-byte groups
__host__ __device__ inline int staged_width(int tw) { return round_up(pair_width(tw) + 10, 8); }

// the tensor-core configurations: THREADS a block, MINB blocks an SM;
// warps WM along the outputs and the rest along the pixels; a warp's tile
// MI x 16 outputs by NJ x 8 pixels
template <int CFG>
struct Cfg;
template <>
struct Cfg<0> {  // Cout <= 64: 64 outputs by 256 pixels
  static constexpr int THREADS = 256, MINB = 2, WM = 2, MI = 2, NJ = 8;
};
template <>
struct Cfg<1> {  // Cout <= 128: 128 outputs by 128 pixels
  static constexpr int THREADS = 256, MINB = 2, WM = 2, MI = 4, NJ = 4;
};
template <>
struct Cfg<2> {  // wider: 384 outputs a slice by 64 pixels, 16 warps, so
  // that C = 384 stages and convolves its input once
  static constexpr int THREADS = 512, MINB = 1, WM = 8, MI = 3, NJ = 4;
};

template <int CFG>
__host__ __device__ constexpr int cfg_outputs() {
  return Cfg<CFG>::WM * Cfg<CFG>::MI * 16;
}
template <int CFG>
__host__ __device__ constexpr int cfg_pixels() {
  return (Cfg<CFG>::THREADS / 32 / Cfg<CFG>::WM) * Cfg<CFG>::NJ * 8;
}

// values of the ring (an x chunk and a W chunk a stage), which the output
// tile [mb][nb + 8] takes over after the last chunk
__host__ __device__ inline size_t ring_values(int mb, int nb, int th, int tw) {
  const size_t xs = static_cast<size_t>(kKC) * (th + 2) * staged_width(tw);
  const size_t ring = kStages * (xs + static_cast<size_t>(mb) * kLdw);
  const size_t out = static_cast<size_t>(mb) * (nb + 8);
  return ring > out ? ring : out;
}

// the bf16 kernel's dynamic shared memory: the ring, the depthwise tile,
// the taps of every input channel (f32), s and t
template <int CFG>
size_t tc_smem_bytes(int cin, int th, int tw) {
  constexpr int mb = cfg_outputs<CFG>(), nb = cfg_pixels<CFG>();
  return (ring_values(mb, nb, th, tw) + static_cast<size_t>(kKC) * (nb + 8)) * sizeof(bf16) +
         (static_cast<size_t>(round_up(cin, kKC)) * 9 + 2 * mb) * sizeof(float);
}

// Where a block sits: the band's first global row and column, the first
// output of its slice.
struct Band {
  int g0, c0, m0;
};

__device__ __forceinline__ Band band_of(int W, int th, int tw, int slices, int mb) {
  const int slice = blockIdx.x % slices;
  const int tile = blockIdx.x / slices;
  const int col_tiles = ceil_div(W, tw);
  return {(tile / col_tiles) * th, (tile % col_tiles) * tw, slice * mb};
}

template <int CFG, bool kVec>
__global__ void __launch_bounds__(Cfg<CFG>::THREADS, Cfg<CFG>::MINB)
fused_sepconv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                        const bf16* __restrict__ w, const float* __restrict__ s,
                        const float* __restrict__ t, const float* __restrict__ mask,
                        bf16* __restrict__ y, int N, int Cin, int Cout, int H, int W, int th,
                        int tw, int pre, int post) {
  using C = Cfg<CFG>;
  constexpr int WM = C::WM, MI = C::MI, NJ = C::NJ, kT = C::THREADS;
  constexpr int kMb = cfg_outputs<CFG>(), kNb = cfg_pixels<CFG>();
  constexpr int kLdd = kNb + 8;  // row stride of the depthwise tile [kKC][kLdd]
  const int twp = pair_width(tw);
  const int sw = staged_width(tw);
  const int srows = th + 2;
  const int xs = kKC * srows * sw;
  const int cinp = round_up(Cin, kKC);
  const int rows = N * H;
  const int npix = th * twp;  // the band's pixels, pairs padded
  const Band band = band_of(W, th, tw, ceil_div(Cout, kMb), kMb);

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);  // [kStages][kKC][srows][sw]
  bf16* s_w = s_x + kStages * xs;  // [kStages][kMb][kLdw]
  bf16* s_o = s_x;  // after the last chunk: the output tile [kMb][kLdo]
  bf16* s_d = s_x + ring_values(kMb, kNb, th, tw);  // [kKC][kLdd]
  float* s_taps = reinterpret_cast<float*>(s_d + kKC * kLdd);  // [cinp][9]
  float* s_s = s_taps + cinp * 9;  // [kMb]
  float* s_t = s_s + kMb;  // [kMb]

  for (int i = threadIdx.x; i < cinp * 9; i += kT) {
    s_taps[i] = i < Cin * 9 ? __bfloat162float(taps[i]) : 0.f;
  }
  for (int i = threadIdx.x; i < kMb; i += kT) {
    const int co = band.m0 + i;
    s_s[i] = co < Cout ? s[co] : 0.f;
    s_t[i] = co < Cout ? t[co] : 0.f;
  }

  // chunk j: input channels [32 j, 32 j + 32) of the band's staged rows
  // and of the slice's rows of W, into ring stage j % kStages
  auto load = [&](int j) {
    const int ci0 = j * kKC;
    bf16* dx = s_x + (j % kStages) * xs;
    bf16* dw = s_w + (j % kStages) * kMb * kLdw;
    if constexpr (kVec) {
      // a thread per (staged row, 16-byte group, 8 channels): the row's
      // address once, then 8 copies a channel plane apart
      const int groups = sw / 8;
      const int items = srows * groups;
      for (int i = threadIdx.x; i < items * (kKC / 8); i += kT) {
        const int it = i % items;
        const int k8 = (i / items) * 8;
        const int rr = it / groups;
        const int q = it - rr * groups;
        const int g = band.g0 - 1 + rr;
        const int col = band.c0 - kLeft + q * 8;
        const bool inside = g >= 0 && g < rows && col >= 0 && col < W;
        const bf16* src = x;
        if (inside) {
          const int n = g / H;
          src = x + ((static_cast<size_t>(n) * Cin + ci0 + k8) * H + (g - n * H)) * W + col;
        }
        bf16* dst = dx + (k8 * srows + rr) * sw + q * 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const bool valid = inside && ci0 + k8 + k < Cin;
          mma::cp_async16(dst + k * srows * sw, valid ? src + static_cast<size_t>(k) * H * W : x,
                          valid);
        }
      }
      for (int i = threadIdx.x; i < kMb * (kKC / 8); i += kT) {
        const int m = i / (kKC / 8);
        const int k = (i - m * (kKC / 8)) * 8;
        const int co = band.m0 + m, ci = ci0 + k;
        const bool valid = co < Cout && ci < Cin;
        mma::cp_async16(dw + m * kLdw + k, valid ? w + static_cast<size_t>(co) * Cin + ci : w,
                        valid);
      }
    } else {
      for (int i = threadIdx.x; i < xs; i += kT) {
        const int q = i % sw;
        const int rr = (i / sw) % srows;
        const int ci = ci0 + i / (sw * srows);
        const int g = band.g0 - 1 + rr;
        const int col = band.c0 - kLeft + q;
        bf16 v = __float2bfloat16(0.f);
        if (ci < Cin && g >= 0 && g < rows && col >= 0 && col < W) {
          const int n = g / H;
          v = x[((static_cast<size_t>(n) * Cin + ci) * H + (g - n * H)) * W + col];
        }
        dx[i] = v;
      }
      for (int i = threadIdx.x; i < kMb * kKC; i += kT) {
        const int m = i / kKC;
        const int k = i - m * kKC;
        const int co = band.m0 + m, ci = ci0 + k;
        dw[m * kLdw + k] =
            co < Cout && ci < Cin ? w[static_cast<size_t>(co) * Cin + ci] : __float2bfloat16(0.f);
      }
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int chunks = cinp / kKC;
  // a lane's depthwise pairs p = 2 lane + 64 k, the same in every channel:
  // where the pair's first staged row starts (column c - 2) and whether it
  // lies in the band and has an image row above and below
  constexpr int kSlots = kNb / 64;
  constexpr int kInBand = 1, kUp = 2, kDown = 4;
  int slot_at[kSlots], slot_flags[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int p = 2 * lane + 64 * k;
    const int r = p / twp;
    const int yy = (band.g0 + r) % H;
    slot_at[k] = r * sw + kLeft - 2 + (p - r * twp);
    slot_flags[k] = (p < npix ? kInBand : 0) | (yy > 0 ? kUp : 0) | (yy < H - 1 ? kDown : 0);
  }
  float acc[MI][NJ][4];
  mma::zero(acc);
  load(0);
  mma::cp_async_commit();
  for (int j = 0; j < chunks; ++j) {
    mma::cp_async_wait<0>();
    __syncthreads();  // chunk j has landed; the tile and stage j - 1 are free
    if (j + 1 < chunks) load(j + 1);
    mma::cp_async_commit();
    bf16* cx = s_x + (j % kStages) * xs;
    if (pre != udal::kIdentity) {
      uint32_t* v = reinterpret_cast<uint32_t*>(cx);
      udal::with_activation(pre, [&](auto tag) {
        constexpr int A = decltype(tag)::kAct;
        for (int i = threadIdx.x; i < xs / 2; i += kT) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(v + i);
          v[i] = mma::pack2(udal::activate_bf16<A>(__low2float(h), pre),
                            udal::activate_bf16<A>(__high2float(h), pre));
        }
      });
      __syncthreads();
    }
    // the depthwise: a warp a channel at a time, a lane the pairs of pixels
    // (p, p + 1) of its slots, from the 6 values of columns c - 2 to c + 3
    // of each of the pair's three staged rows
    for (int kc = warp; kc < kKC; kc += kT / 32) {
      float tap[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) tap[k] = s_taps[(j * kKC + kc) * 9 + k];
      const bf16* xc = cx + kc * srows * sw;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        uint32_t out = 0;
        if (slot_flags[k] & kInBand) {
          float o0 = 0.f, o1 = 0.f;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            if ((ky == 0 && !(slot_flags[k] & kUp)) || (ky == 2 && !(slot_flags[k] & kDown))) {
              continue;
            }
            const uint32_t* row = reinterpret_cast<const uint32_t*>(xc + slot_at[k] + ky * sw);
            float v[6];
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(row + q);
              v[2 * q] = __low2float(h);
              v[2 * q + 1] = __high2float(h);
            }
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              o0 = fmaf(tap[ky * 3 + kx], v[1 + kx], o0);
              o1 = fmaf(tap[ky * 3 + kx], v[2 + kx], o1);
            }
          }
          out = mma::pack2(o0, o1);
        }
        *reinterpret_cast<uint32_t*>(s_d + kc * kLdd + 2 * lane + 64 * k) = out;
      }
    }
    __syncthreads();
    const bf16* cw = s_w + (j % kStages) * kMb * kLdw + wm * MI * 16 * kLdw;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t b[NJ][2];
      mma::load_b(b, s_d + kk * kLdd + wn * NJ * 8, kLdd, lane);
      mma::mma_rows(acc, cw + kk, kLdw, b, lane);
    }
  }

  // the epilogue, through shared memory: each fragment's outputs
  // post(acc * s + t) * mask, rounded to bf16, into the output tile over
  // the ring (a fragment's two columns are two pixels of one row), then the
  // tile's rows to y in runs of 8 pixels
  constexpr int kLdo = kNb + 8;
  __syncthreads();  // every warp's last products are done: the ring is free
  udal::with_activation(post, [&](auto tag) {
    constexpr int A = decltype(tag)::kAct;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int p = wn * NJ * 8 + jj * 8 + mma::frag_col(lane);
      const int n = min(band.g0 + p / twp, rows - 1) / H;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm * MI * 16 + i * 16 + mma::frag_row(lane, 2 * h);
          const int co = band.m0 + m;
          const float mk = mask != nullptr && co < Cout ? mask[n * Cout + co] : 1.f;
          const float v0 =
              udal::activate_bf16<A>(fmaf(acc[i][jj][2 * h], s_s[m], s_t[m]), post) * mk;
          const float v1 =
              udal::activate_bf16<A>(fmaf(acc[i][jj][2 * h + 1], s_s[m], s_t[m]), post) * mk;
          *reinterpret_cast<uint32_t*>(s_o + m * kLdo + p) = mma::pack2(v0, v1);
        }
    }
  });
  __syncthreads();
  // a lane a run of 8 pixels p0 = 8 v of a row of the tile, the warp's
  // lanes over 32 / (kNb / 8) outputs at once
  constexpr int kLpc = kNb / 8;
  constexpr int kCpw = 32 / kLpc;
  const int p0 = 8 * (lane % kLpc);
  const size_t plane = static_cast<size_t>(H) * W;
  if constexpr (kVec) {  // a run lies in one row (twp is a multiple of 8)
    const int r = p0 / twp;
    const int c = p0 - r * twp;
    const int g = band.g0 + r;
    if (p0 < npix && g < rows && c < tw && band.c0 + c < W) {
      const int n = g / H;
      bf16* dst = y + static_cast<size_t>(n) * Cout * plane +
                  static_cast<size_t>(g - n * H) * W + band.c0 + c;
      for (int m = warp * kCpw + lane / kLpc; m < kMb && band.m0 + m < Cout;
           m += (kT / 32) * kCpw) {
        *reinterpret_cast<uint4*>(dst + (band.m0 + m) * plane) =
            *reinterpret_cast<const uint4*>(s_o + m * kLdo + p0);
      }
    }
  } else {
    for (int m = warp * kCpw + lane / kLpc; m < kMb && band.m0 + m < Cout;
         m += (kT / 32) * kCpw) {
      for (int e = 0; e < 8; ++e) {
        const int p = p0 + e;
        const int r = p / twp;
        const int c = p - r * twp;
        const int g = band.g0 + r;
        if (p >= npix || g >= rows || c >= tw || band.c0 + c >= W) continue;
        const int n = g / H;
        y[(static_cast<size_t>(n) * Cout + band.m0 + m) * plane +
          static_cast<size_t>(g - n * H) * W + band.c0 + c] = s_o[m * kLdo + p];
      }
    }
  }
}

template <int CFG, bool kVec>
cudaError_t launch_tc(const void* x, const void* taps, const void* w, const void* s,
                      const void* t, const void* mask, void* y, int n, int cin, int cout, int h,
                      int wd, int th, int tw, int pre, int post, cudaStream_t stream) {
  constexpr int kMb = cfg_outputs<CFG>(), kNb = cfg_pixels<CFG>();
  if (th * pair_width(tw) > kNb) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes<CFG>(cin, th, tw);
  const long long blocks = static_cast<long long>(ceil_div(n * h, th)) * ceil_div(wd, tw) *
                           ceil_div(cout, kMb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      cudaFuncSetAttribute(fused_sepconv_tc_kernel<CFG, kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_sepconv_tc_kernel<CFG, kVec>
      <<<static_cast<unsigned>(blocks), Cfg<CFG>::THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(taps), static_cast<const bf16*>(w),
      static_cast<const float*>(s), static_cast<const float*>(t),
      static_cast<const float*>(mask), static_cast<bf16*>(y), n, cin, cout, h, wd, th, tw, pre,
      post);
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory of a block of tensor-core configuration `cfg`
// at bands of th x tw: what the host's planner (ops/fused_sepconv.py)
// models, checked against this before a launch. -1 for an unknown
// configuration.
extern "C" long long udal_fused_sepconv_smem(int cfg, int cin, int th, int tw) {
  size_t bytes = 0;
  switch (cfg) {
    case 0: bytes = tc_smem_bytes<0>(cin, th, tw); break;
    case 1: bytes = tc_smem_bytes<1>(cin, th, tw); break;
    case 2: bytes = tc_smem_bytes<2>(cin, th, tw); break;
    default: return -1;
  }
  return static_cast<long long>(bytes);
}

// x [n, cin, h, w] contiguous bf16; taps [cin, 3, 3] and w [cout, cin]
// bf16; s, t [cout] f32; mask [n, cout] f32 or null; y [n, cout, h, w]
// bf16. Bands of th global rows by tw columns (th * tw rounded up to pairs
// within the configuration's pixels; tw a multiple of 8 where the columns
// take several bands); cfg the tensor-core configuration (0, 1, 2); vec: w and cin
// multiples of 8, x and w 16-byte aligned (16-byte asynchronous copies).
// pre and post are activation codes (depthwise_tile.cuh, enum Act).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int udal_fused_sepconv(const void* x, const void* taps, const void* w, const void* s,
                                  const void* t, const void* mask, void* y, int n, int cin,
                                  int cout, int h, int wd, int th, int tw, int cfg, int vec,
                                  int pre, int post, void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || h <= 0 || wd <= 0 || th <= 0 || tw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UDAL_SEP_TC(C, V)                                                                    \
  if (cfg == C && vec == V)                                                                  \
    return static_cast<int>(launch_tc<C, V>(x, taps, w, s, t, mask, y, n, cin, cout, h, wd, th, \
                                            tw, pre, post, st));
  UDAL_SEP_TC(0, 0)
  UDAL_SEP_TC(0, 1)
  UDAL_SEP_TC(1, 0)
  UDAL_SEP_TC(1, 1)
  UDAL_SEP_TC(2, 0)
  UDAL_SEP_TC(2, 1)
#undef UDAL_SEP_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
