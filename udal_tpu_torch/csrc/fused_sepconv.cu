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
// Two kernels, one arithmetic. Both cut the global rows g = n * H + y of
// the NCHW tensor into bands of TH rows and TW columns (a band may span
// images: a level of 4 rows fills a block with 8 images) and the Cout
// outputs into slices. Cin streams through a ring of 32-channel chunks
// filled by cp.async (zero fill outside the tensor), each holding the
// band's TH + 2 rows by TW + halo columns of x. For a chunk a block
// applies `pre` in place (rounded to x's type, as the unfused chain
// rounds it), computes the depthwise in f32 from the staged rows, rounds
// it to bf16 into a [32][pixels] tile in shared memory (a row whose
// neighbour lies in another image, or outside it, takes no tap from it),
// and multiplies W's chunk by that tile on tensor cores (mma.sync
// m16n8k16, f32 accumulators, mma_tile.cuh) while the next chunks' copies
// land. The epilogue applies s, t, `post` and the mask in f32 and rounds
// once to bf16. bf16 only: f32 activations run the unfused chain, which
// was faster than a CUDA-core product of the same staging. The host's
// planner (ops/fused_sepconv.py `plan`) picks the kernel by Cin alone.
//
// fused_sepconv_tc_kernel takes Cin <= 128 (d0 and every model up to d3):
// a block per (band, slice), slices of 64, 128 or 384 outputs (Cfg), the
// slice fastest so the blocks that stage the same input run together.
// The ring has two stages, each a chunk of x and the slice's rows of W;
// the epilogue goes through an output tile over the ring and stores its
// rows in 16-byte runs. At Cin = 64 W's 8 KB are nothing beside x.
//
// fused_sepconv_resident_kernel takes Cin > 128 (d4 to d7x), where the
// first kernel re-read all of W (288 KB at d7x) from L2 for every band of
// 64 pixels. It is persistent: a group of `slices` blocks (slice fastest,
// a slice at most 192 outputs, a multiple of 48) walks the bands with the
// stride of the grid, one block an SM, and each block keeps its slice's
// rows of W in shared memory from its first band to its last, loaded with
// that band's chunks; only x streams. Where two slices cover Cout (d7x's
// 384 = 2 x 192) the pair is a cluster: each block stages and convolves
// half of every chunk's channels and st.async's its half of the depthwise
// tile into the partner's, so x is read and convolved once a band. Inside
// a block the warps specialise: 8 producer warps copy x's chunks through
// a ring of 3 stages (cp.async, each thread's copies found once a band),
// apply `pre` to their own copies and convolve into a ring of 4 depthwise
// tiles; 8 consumer warps multiply each tile by W's chunk and, at a
// band's end, store it through a shared-memory piece each, 64 bytes of a
// row each four lanes, while the producers run on. mbarriers pass the
// tiles: full (the producer warps' arrivals and the partner's bytes),
// empty (both blocks' consumer warps). A band is 64 pixels (at d7x's P3 2
// rows by 32 columns, a lane convolving a 2 x 2 block from 4 staged rows)
// and a consumer warp's tile 48 x 32, so its 48 accumulators stay in
// registers. Shared memory at d7x's towers and nodes (Cin 384, slices of
// 192): W 147 KB, the ring 18 KB, the tiles 18 KB, the pieces 10 KB, the
// f32 taps 13.5 KB, s, t and the barriers: 208 of the 227 KB a block may
// have. Each band's chunks start at the band's index (mod the chunks), so
// the groups, which walk in step, read different channel planes at a time.
//
// What bounds it: the input read once and the output written once. At
// d0's heads (C = 64) the 1x1 product is 128 operations a value moved,
// far below the card's ridge, so the bound is the bytes: 0.27 ms a tower
// layer at T*B = 320 over five levels of 1024x512 at 3.35 TB/s. At d7x
// (C = 384) it is 384 operations a byte, near the ridge: 0.90 ms a tower
// layer at T*B = 80. Measured on an H100 the first kernel takes about
// 1.0 ms a tower layer at d0 and 7.3 at d7x: the instructions and
// latencies of the depthwise (nine taps from three 32-bit loads a row for
// two outputs, converted to f32), the epilogue and the barriers between a
// chunk's copies, depthwise and product, each in turn; W's copies from L2
// cost only about an eighth of it (4.87 -> 4.30 ms at P3 without them).
// The resident kernel takes 6.4 ms there: its producers' copies and
// depthwise now set its pace (about 2.2K cycles a step of 64 pixels).
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

// -- the resident kernel (Cin > 128) ------------------------------------------
//
// Warp-specialized (the design note at the top): producers stage and
// convolve, consumers multiply and store, mbarriers pass the tiles. A
// consumer thread keeps 48 accumulators: with 96 (bands of 128 pixels) it
// spilled, and the spills, with the ring's shared memory leaving L1 small,
// went to L2 beside the copies.

constexpr int kRProducerWarps = 8;
constexpr int kRConsumerWarps = 8;
constexpr int kRProducers = kRProducerWarps * 32;             // 256 threads
constexpr int kRThreads = (kRProducerWarps + kRConsumerWarps) * 32;  // 512
constexpr int kRCopies = 4;  // a producer's 16-byte copies of a chunk, found once a band
constexpr int kRWm = 4, kRMi = 3, kRNj = 4;  // 4 consumer warps along the outputs, a warp 48 x 32
constexpr int kRWarpRows = kRMi * 16;        // 48: slices are multiples of it
constexpr int kRMb = kRWm * kRWarpRows;      // 192: the widest slice
constexpr int kRNb = (kRConsumerWarps / kRWm) * kRNj * 8;  // 64 pixels a band
constexpr int kRStages = 3;                  // x chunks in the ring
constexpr int kRTiles = 4;                   // depthwise tiles [kKC][kRLdd]
constexpr int kRLdd = kRNb + 8;
constexpr int kRPiece = 32;                  // pixels of a consumer warp's output piece
constexpr int kRLdo = kRPiece + 8;           // its row stride: [16][kRLdo]

// the resident kernel's dynamic shared memory: the slice's rows of W, the
// ring of x (half of each chunk's channels in a pair), the depthwise
// tiles, the consumer warps' output pieces, the tiles' two barriers, the
// taps of every input channel (f32), s and t
__host__ __device__ inline size_t resident_smem_bytes(int cin, int mb, bool pair, int th,
                                                      int tw) {
  const size_t cinp = round_up(cin, kKC);
  const size_t ch = pair ? kKC / 2 : kKC;
  const size_t values = static_cast<size_t>(mb) * (cinp + 8) +
                        kRStages * ch * (th + 2) * staged_width(tw) +
                        static_cast<size_t>(kRTiles) * kKC * kRLdd + kRConsumerWarps * 16 * kRLdo;
  return values * sizeof(bf16) + 2 * kRTiles * sizeof(uint64_t) +
         (cinp * 9 + 2 * static_cast<size_t>(mb)) * sizeof(float);
}

// a chunk's 16-byte copies of x (channel, staged row, 16-byte group): at
// most 960 for bands of 64 pixels, within the producers' 4 slots a thread
__host__ __device__ inline int resident_copies(bool pair, int th, int tw) {
  return (th + 2) * (staged_width(tw) / 8) * (pair ? kKC / 2 : kKC);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of both blocks arrives, its earlier writes released, then
// waits for the others'
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of this block's shared `addr` in block `rank`'s shared memory
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 4 bytes into the partner's shared memory, counted on its barrier `bar`
// when they land (the producer does not wait for them)
__device__ __forceinline__ void st_async(unsigned addr, uint32_t v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma::smem_addr(bar)), "r"(count)
               : "memory");
}

// one arrival on this block's barrier at shared address `bar`, or on the
// partner's at its cluster address, released at the block's scope: a
// release to the cluster waited for every earlier store of the thread
// (the epilogue's to y) to be performed, thousands of cycles a step
__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_arrive_remote(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the arrival that also expects `bytes` stored by the partner's st.async
__device__ __forceinline__ void bar_arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// waits until the phase of `bar` with this parity has completed; what
// its arrivals released is visible after it (the suspend-time hint, as
// CUTLASS's pipelines give it, lets the hardware park the thread)
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "RWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1, %2;\n"
      "@!done bra RWAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity), "r"(0x989680)
      : "memory");
}

// The resident kernel's activations, each a constant of its copy of the
// code: a runtime switch, and libm's mish, inlined for each value made the
// epilogue tens of thousands of instructions and spilled the accumulators.
// Swish as the first kernel's (one MUFU), mish from the hardware exp, log
// and tanh (about 2^-11 relative, under the bf16 rounding that follows),
// the others exact.
template <int A>
__device__ __forceinline__ float act_value(float v) {
  if constexpr (A == udal::kIdentity) {
    return v;
  } else if constexpr (A == udal::kSwish) {
    return udal::activate_bf16<udal::kSwish>(v, A);
  } else if constexpr (A == udal::kMish) {
    float th;
    const float sp = v > 20.f ? v : __logf(1.f + __expf(v));
    asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(sp));
    return v * th;
  } else {
    return udal::activate(v, A);
  }
}

template <typename F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case udal::kSwish: f(udal::ActTag<udal::kSwish>{}); break;
    case udal::kRelu: f(udal::ActTag<udal::kRelu>{}); break;
    case udal::kRelu6: f(udal::ActTag<udal::kRelu6>{}); break;
    case udal::kHswish: f(udal::ActTag<udal::kHswish>{}); break;
    case udal::kMish: f(udal::ActTag<udal::kMish>{}); break;
    default: f(udal::ActTag<udal::kIdentity>{}); break;
  }
}

template <int A>
__device__ __forceinline__ uint32_t activate2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return mma::pack2(act_value<A>(__low2float(h)), act_value<A>(__high2float(h)));
}

// kPair: two slices as a cluster of two blocks, each convolving half of a
// chunk's channels into both; kVec: x's rows in 16-byte copies (W a
// multiple of 8, x 16-byte aligned), else plain loads. wvec: W's rows in
// 16-byte copies (Cin a multiple of 8, w aligned), else plain loads.
template <bool kPair, bool kVec>
__global__ void __launch_bounds__(kRThreads, 1)
fused_sepconv_resident_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                              const bf16* __restrict__ w, const float* __restrict__ s,
                              const float* __restrict__ t, const float* __restrict__ mask,
                              bf16* __restrict__ y, int N, int Cin, int Cout, int H, int W,
                              int th, int tw, int mb, int slices, int wvec, int pre, int post) {
  constexpr int kCh = kPair ? kKC / 2 : kKC;  // a chunk's channels this block convolves
  const int twp = pair_width(tw);
  const int sw = staged_width(tw);
  const int srows = th + 2;
  const int xs = kCh * srows * sw;
  const int cinp = round_up(Cin, kKC);
  const int ldw = cinp + 8;
  const int chunks = cinp / kKC;
  const int rows = N * H;
  const int npix = th * twp;
  const int col_tiles = ceil_div(W, tw);
  const int bands = ceil_div(rows, th) * col_tiles;
  // the walk: group g of `slices` blocks takes bands g, g + groups, ...
  const int slice = blockIdx.x % slices;
  const int group = blockIdx.x / slices;
  const int groups = gridDim.x / slices;
  const int mine = group < bands ? ceil_div(bands - group, groups) : 0;
  if (mine == 0) return;  // the whole group, a cluster too, before any barrier
  const int steps = mine * chunks;
  const int m0 = slice * mb;
  const int ch0 = kPair ? slice * kCh : 0;  // this block's channels of a chunk

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);           // [mb][ldw], resident
  bf16* s_x = s_w + static_cast<size_t>(mb) * ldw;     // [kRStages][kCh][srows][sw]
  bf16* s_d = s_x + kRStages * xs;                     // [kRTiles][kKC][kRLdd]
  bf16* s_o = s_d + kRTiles * kKC * kRLdd;             // [kRConsumerWarps][16][kRLdo]
  uint64_t* s_full = reinterpret_cast<uint64_t*>(s_o + kRConsumerWarps * 16 * kRLdo);
  uint64_t* s_empty = s_full + kRTiles;
  float* s_taps = reinterpret_cast<float*>(s_empty + kRTiles);  // [cinp][9]
  float* s_s = s_taps + cinp * 9;                      // [mb]
  float* s_t = s_s + mb;                               // [mb]

  for (int i = threadIdx.x; i < cinp * 9; i += kRThreads) {
    s_taps[i] = i < Cin * 9 ? __bfloat162float(taps[i]) : 0.f;
  }
  for (int i = threadIdx.x; i < mb; i += kRThreads) {
    const int co = m0 + i;
    s_s[i] = co < Cout ? s[co] : 0.f;
    s_t[i] = co < Cout ? t[co] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRTiles; ++i) {
      // full: each producer warp, and in a pair the arrival that expects
      // the partner's half of the tile
      bar_init(&s_full[i], kRProducerWarps + (kPair ? 1 : 0));
      bar_init(&s_empty[i], (kPair ? 2 : 1) * kRConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the barriers, taps, s and t in place in both blocks before any arrival
  if constexpr (kPair) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  const unsigned partner = kPair ? cluster_rank() ^ 1u : 0u;

  // The walk, step by step: band k of this block's (index b = group + k
  // groups, first global row g0 and column c0) and the chunk c of Cin its
  // step convolves. A band takes its chunks from its index on, so the
  // groups, which walk in step, read different channel planes at a time;
  // the order depends on the band alone, not on the grid.
  struct Walk {
    int k, c_raw, c, b, g0, c0;
  };
  auto set_band = [&](Walk& p) {
    const int row_tile = p.b / col_tiles;
    p.g0 = row_tile * th;
    p.c0 = (p.b - row_tile * col_tiles) * tw;
    p.c = p.b % chunks;
  };
  auto walk_start = [&]() {
    Walk p{0, 0, 0, group, 0, 0};
    set_band(p);
    return p;
  };
  auto walk_next = [&](Walk& p) {
    if (++p.c_raw == chunks) {
      p.c_raw = 0;
      ++p.k;
      p.b += groups;
      set_band(p);
    } else if (++p.c == chunks) {
      p.c = 0;
    }
  };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp < kRProducerWarps) {
    // -- producers: x's chunks through the ring, the depthwise into the tiles
    const int pt = threadIdx.x;
    // a chunk's 16-byte copies (channel, staged row, 16-byte group), spread
    // over every producer thread (consecutive threads along a row), each in
    // a thread's slot (the launch checks that they fit): the destination in
    // a stage (-1: none), the source in chunk 0 (-1: outside the tensor)
    // and the channel; a chunk adds its channels' planes
    const int n_copies = resident_copies(kPair, th, tw);
    long long copy_src[kRCopies];
    int copy_dst[kRCopies], copy_ch[kRCopies];
    int copy_band = -1;
    auto prepare_copies = [&](int g0, int c0) {
      const int groups8 = sw / 8;
      const int items = srows * groups8;
#pragma unroll
      for (int j = 0; j < kRCopies; ++j) {
        const int e = pt + j * kRProducers;
        const int ch = e / items;
        const int it = e - ch * items;
        const int rr = it / groups8;
        const int qq = it - rr * groups8;
        const int g = g0 - 1 + rr;
        const int col = c0 - kLeft + qq * 8;
        const bool inside = g >= 0 && g < rows && col >= 0 && col < W;
        const int n = inside ? g / H : 0;
        copy_dst[j] = e < n_copies ? (ch * srows + rr) * sw + qq * 8 : -1;
        copy_ch[j] = ch;
        copy_src[j] = inside ? ((static_cast<long long>(n) * Cin + ch0 + ch) * H + (g - n * H)) *
                                       W + col
                             : -1;
      }
    };
    // step q = (band k, chunk c): this block's channels of the chunk into
    // ring stage q % kRStages; in the first band also W's chunk, to stay
    auto load = [&](int q, const Walk& at) {
      const int k = at.k, c = at.c, g0 = at.g0, c0 = at.c0;
      const int ci0 = c * kKC + ch0;
      bf16* dx = s_x + (q % kRStages) * xs;
      if (k == 0) {
        if (wvec) {
          for (int i = pt; i < mb * (kKC / 8); i += kRProducers) {
            const int m = i / (kKC / 8);
            const int ci = c * kKC + (i - m * (kKC / 8)) * 8;
            const int co = m0 + m;
            const bool valid = co < Cout && ci < Cin;
            mma::cp_async16(s_w + m * ldw + ci,
                            valid ? w + static_cast<size_t>(co) * Cin + ci : w, valid);
          }
        } else {
          for (int i = pt; i < mb * kKC; i += kRProducers) {
            const int m = i / kKC;
            const int ci = c * kKC + (i - m * kKC);
            const int co = m0 + m;
            s_w[m * ldw + ci] = co < Cout && ci < Cin ? w[static_cast<size_t>(co) * Cin + ci]
                                                      : __float2bfloat16(0.f);
          }
        }
      }
      if constexpr (kVec) {
        // the band's copies, found when its first chunk goes out
        if (k != copy_band) {
          prepare_copies(g0, c0);
          copy_band = k;
        }
        const size_t chunk_off = static_cast<size_t>(c) * kKC * H * W;
#pragma unroll
        for (int j = 0; j < kRCopies; ++j) {
          if (copy_dst[j] < 0) continue;
          const bool valid = copy_src[j] >= 0 && c * kKC + ch0 + copy_ch[j] < Cin;
          mma::cp_async16(dx + copy_dst[j], valid ? x + copy_src[j] + chunk_off : x, valid);
        }
      } else {  // plain loads, pre applied on the way
        with_act(pre, [&](auto tag) {
          constexpr int A = decltype(tag)::kAct;
          for (int i = pt; i < xs; i += kRProducers) {
            const int qq = i % sw;
            const int rr = (i / sw) % srows;
            const int ci = ci0 + i / (sw * srows);
            const int g = g0 - 1 + rr;
            const int col = c0 - kLeft + qq;
            float v = 0.f;
            if (ci < Cin && g >= 0 && g < rows && col >= 0 && col < W) {
              const int n = g / H;
              v = __bfloat162float(
                  x[((static_cast<size_t>(n) * Cin + ci) * H + (g - n * H)) * W + col]);
              v = act_value<A>(v);
            }
            dx[i] = __float2bfloat16(v);
          }
        });
      }
    };

    // pre in place on the 16-byte groups this thread copied for step q,
    // once they have landed: no barrier between the copies and the
    // activation. Zeros, outside the tensor or past Cin, stay zeros.
    auto activate_own = [&](int q) {
      if constexpr (kVec) {
        if (pre == udal::kIdentity) return;
        bf16* dx = s_x + (q % kRStages) * xs;
        with_act(pre, [&](auto tag) {
          constexpr int A = decltype(tag)::kAct;
          auto activate16 = [&](bf16* at) {
            uint4* p = reinterpret_cast<uint4*>(at);
            uint4 v = *p;
            v.x = activate2<A>(v.x);
            v.y = activate2<A>(v.y);
            v.z = activate2<A>(v.z);
            v.w = activate2<A>(v.w);
            *p = v;
          };
#pragma unroll
          for (int j = 0; j < kRCopies; ++j) {
            if (copy_dst[j] >= 0) activate16(dx + copy_dst[j]);
          }
        });
      }
    };

    const unsigned full_local = mma::smem_addr(s_full), empty_local = mma::smem_addr(s_empty);
    const unsigned full_remote = kPair ? map_rank(full_local, partner) : 0u;
    // a lane's depthwise pairs p = 2 lane + 64 j of the current band (as
    // the first kernel's slots)
    constexpr int kSlots = kRNb / 64;
    constexpr int kInBand = 1, kUp = 2, kDown = 4, kUp1 = 8, kDown1 = 16;
    int slot_at[kSlots], slot_flags[kSlots];
    int slot_band = -1, strip_flags = 0;
    const bool strip = th == 2 && twp == 32;
    const unsigned d_remote = kPair ? map_rank(mma::smem_addr(s_d), partner) : 0u;
    auto depthwise = [&](int q, const Walk& at) {
      const int k = at.k, c = at.c;
      if (k != slot_band) {
        const int g0 = at.g0;
        const int y0 = g0 % H;
        // the strip's rows g0 and g0 + 1: a tap above and below each
        strip_flags = (y0 > 0 ? kUp : 0) | (y0 < H - 1 ? kDown | kUp1 : 0) |
                      ((g0 + 1) % H < H - 1 ? kDown1 : 0);
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int p = 2 * lane + 64 * j;
          const int r = p / twp;
          const int yy = (g0 + r) % H;
          slot_at[j] = r * sw + kLeft - 2 + (p - r * twp);
          slot_flags[j] =
              (p < npix ? kInBand : 0) | (yy > 0 ? kUp : 0) | (yy < H - 1 ? kDown : 0);
        }
        slot_band = k;
      }
      const bf16* cx = s_x + (q % kRStages) * xs;
      const int d_tile = (q % kRTiles) * kKC * kRLdd;
      if (strip) {
        // bands of 2 rows by 32 columns (most pixels at d7x): a lane the
        // pair of columns 2 (lane % 16) in both rows, from the 4 staged
        // rows, 16 lanes a channel; rows of other images take no tap
#pragma unroll
        for (int pass = 0; pass < kCh / kRProducerWarps / 2; ++pass) {
          const int kc = warp + (2 * pass + lane / 16) * kRProducerWarps;
          const int cc = 2 * (lane % 16);
          float tap[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) tap[j] = s_taps[(c * kKC + ch0 + kc) * 9 + j];
          const uint32_t* base =
              reinterpret_cast<const uint32_t*>(cx + kc * srows * sw + kLeft - 2 + cc);
          float v[4][4];  // staged rows 0..3, columns cc - 1 .. cc + 2
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t* row = base + r * (sw / 2);
            const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(row);
            const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(row + 1);
            const __nv_bfloat162 d = *reinterpret_cast<const __nv_bfloat162*>(row + 2);
            v[r][0] = __high2float(a);
            v[r][1] = __low2float(b);
            v[r][2] = __high2float(b);
            v[r][3] = __low2float(d);
          }
          float o[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
          for (int orow = 0; orow < 2; ++orow)
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              if ((ky == 0 && !(strip_flags & (orow ? kUp1 : kUp))) ||
                  (ky == 2 && !(strip_flags & (orow ? kDown1 : kDown)))) {
                continue;
              }
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                o[orow][0] = fmaf(tap[ky * 3 + kx], v[orow + ky][kx], o[orow][0]);
                o[orow][1] = fmaf(tap[ky * 3 + kx], v[orow + ky][kx + 1], o[orow][1]);
              }
            }
#pragma unroll
          for (int orow = 0; orow < 2; ++orow) {
            const uint32_t out = mma::pack2(o[orow][0], o[orow][1]);
            const int off = d_tile + (ch0 + kc) * kRLdd + 32 * orow + cc;
            *reinterpret_cast<uint32_t*>(s_d + off) = out;
            if constexpr (kPair) st_async(d_remote + 2u * off, out, full_remote + 8u * (q % kRTiles));
          }
        }
        return;
      }
#pragma unroll
      for (int u = 0; u < kCh / kRProducerWarps; ++u) {
        const int kc = warp + u * kRProducerWarps;
        float tap[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) tap[j] = s_taps[(c * kKC + ch0 + kc) * 9 + j];
        const bf16* xc = cx + kc * srows * sw;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          uint32_t out = 0;
          if (slot_flags[j] & kInBand) {
            float o0 = 0.f, o1 = 0.f;
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              if ((ky == 0 && !(slot_flags[j] & kUp)) || (ky == 2 && !(slot_flags[j] & kDown))) {
                continue;
              }
              const uint32_t* row = reinterpret_cast<const uint32_t*>(xc + slot_at[j] + ky * sw);
              float v[6];
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(row + e);
                v[2 * e] = __low2float(h);
                v[2 * e + 1] = __high2float(h);
              }
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                o0 = fmaf(tap[ky * 3 + kx], v[1 + kx], o0);
                o1 = fmaf(tap[ky * 3 + kx], v[2 + kx], o1);
              }
            }
            out = mma::pack2(o0, o1);
          }
          const int off = d_tile + (ch0 + kc) * kRLdd + 2 * lane + 64 * j;
          *reinterpret_cast<uint32_t*>(s_d + off) = out;
          if constexpr (kPair) st_async(d_remote + 2u * off, out, full_remote + 8u * (q % kRTiles));
        }
      }
    };

    // Step q: the tile q % kRTiles empty in both blocks; the producers'
    // barrier (every copy of step q landed and activated, stage q - 1
    // read); the copies of step q + 2; the depthwise of q into the tile of
    // both blocks; full arrivals in both; the own copies of q + 1 landed
    // and activated.
    Walk at_load = walk_start(), at = at_load;
#pragma unroll
    for (int q = 0; q < kRStages - 1; ++q) {
      if (q < steps) {
        load(q, at_load);
        walk_next(at_load);
      }
      mma::cp_async_commit();
    }
    mma::cp_async_wait<kRStages - 2>();
    activate_own(0);
    for (int q = 0; q < steps; ++q) {
      const int tile = q % kRTiles;
      if (q >= kRTiles) bar_wait(empty_local + 8u * tile, (q / kRTiles - 1) & 1);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kRProducers) : "memory");
      if (q + kRStages - 1 < steps) {
        load(q + kRStages - 1, at_load);
        walk_next(at_load);
      }
      mma::cp_async_commit();
      depthwise(q, at);
      walk_next(at);
      // the warp's stores, then one arrival a warp; in a pair the partner's
      // half of the tile lands by st.async, counted in bytes
      __syncwarp();
      if (lane == 0) {
        if (kPair && warp == 0) {
          bar_arrive_expect(full_local + 8u * tile, kCh * kRNb * sizeof(bf16));
        }
        bar_arrive(full_local + 8u * tile);
      }
      mma::cp_async_wait<kRStages - 2>();
      if (q + 1 < steps) activate_own(q + 1);
    }
  } else {
    // -- consumers: the product of each tile with W's chunk; at a band's
    // end its outputs
    const int cw = warp - kRProducerWarps;
    const int wm = cw % kRWm, wn = cw / kRWm;
    // a warp whose 48 rows start inside the slice and before Cout computes
    // them all (rows past Cout are W's zero rows, and are not stored)
    const bool live = wm * kRWarpRows < mb && m0 + wm * kRWarpRows < Cout;
    float acc[kRMi][kRNj][4];
    mma::zero(acc);

    auto product = [&](int q, int c) {
      if (!live) return;
      const bf16* dt = s_d + (q % kRTiles) * kKC * kRLdd;
      const bf16* aw = s_w + wm * kRWarpRows * ldw + c * kKC;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        uint32_t b[kRNj][2];
        mma::load_b(b, dt + kk * kRLdd + wn * kRNj * 8, kRLdd, lane);
#pragma unroll
        for (int i = 0; i < kRMi; ++i) {
          uint32_t af[4];
          mma::load_a(af, aw + i * 16 * ldw + kk, ldw, lane);
#pragma unroll
          for (int j = 0; j < kRNj; ++j) mma::mma_16816(acc[i][j], af, b[j]);
        }
      }
    };

    // band k's outputs post(acc * s + t) * mask, rounded once: a block of
    // 16 outputs by 32 pixels at a time through the warp's piece of
    // shared memory; then, where rows are a multiple of 8 wide (W % 8 ==
    // 0), 16 bytes a lane, 64 bytes of a row each four lanes (whole
    // sectors), else a pixel a lane
    const size_t plane = static_cast<size_t>(H) * W;
    const bool runs = (W & 7) == 0;
    bf16* piece = s_o + cw * 16 * kRLdo;
    auto epilogue = [&](int g0, int c0) {
      if (!live) return;
      // the image of each of the lane's pixel columns (pixels past the
      // tensor take the last image; they are not stored)
      int img[kRNj];
#pragma unroll
      for (int jj = 0; jj < kRNj; ++jj) {
        const int p = wn * kRNj * 8 + jj * 8 + mma::frag_col(lane);
        img[jj] = min(g0 + p / twp, rows - 1) / H;
      }
      // where the lane stores in each half: the run of 8 pixels (lane % 4)
      // or the pixel column lane of the piece
      constexpr int kHalves = kRNj * 8 / kRPiece, kJ = kRPiece / 8;
      bf16* y_st[kHalves];
      bool in_st[kHalves];
#pragma unroll
      for (int half = 0; half < kHalves; ++half) {
        const int p = wn * kRNj * 8 + half * kRPiece + (runs ? (lane % 4) * 8 : lane);
        const int r = p / twp;
        const int c = p - r * twp;
        const int g = g0 + r;
        in_st[half] = p < npix && g < rows && c < tw && c0 + c < W;
        const int n = in_st[half] ? g / H : 0;
        y_st[half] = y + (static_cast<size_t>(n) * Cout + m0) * plane +
                     static_cast<size_t>(g - n * H) * W + c0 + c;
      }
      with_act(post, [&](auto tag) {
        constexpr int A = decltype(tag)::kAct;
#pragma unroll
        for (int half = 0; half < kHalves; ++half) {
#pragma unroll
          for (int i = 0; i < kRMi; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = mma::frag_row(lane, 2 * h);
              const int m = wm * kRWarpRows + i * 16 + row;
              const int co = min(m0 + m, Cout - 1);
              const float sv = s_s[m], tv = s_t[m];
#pragma unroll
              for (int jj = 0; jj < kJ; ++jj) {
                const int j = half * kJ + jj;
                const float mk = mask != nullptr ? mask[img[j] * Cout + co] : 1.f;
                const float v0 = act_value<A>(fmaf(acc[i][j][2 * h], sv, tv)) * mk;
                const float v1 = act_value<A>(fmaf(acc[i][j][2 * h + 1], sv, tv)) * mk;
                *reinterpret_cast<uint32_t*>(piece + row * kRLdo + jj * 8 +
                                             mma::frag_col(lane)) = mma::pack2(v0, v1);
              }
            }
            __syncwarp();
            // the piece's rows are outputs m_top + row of the slice
            const int m_top = wm * kRWarpRows + i * 16;
            const int rows_out = min(16, min(mb, Cout - m0) - m_top);
            if (in_st[half] && runs) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int row = lane / 4 + 8 * e;
                if (row < rows_out) {
                  *reinterpret_cast<uint4*>(y_st[half] + (m_top + row) * plane) =
                      *reinterpret_cast<const uint4*>(piece + row * kRLdo + (lane % 4) * 8);
                }
              }
            } else if (in_st[half]) {
#pragma unroll 1
              for (int row = 0; row < rows_out; ++row) {
                y_st[half][(m_top + row) * plane] = piece[row * kRLdo + lane];
              }
            }
            __syncwarp();
          }
        }
      });
    };

    const unsigned full_local = mma::smem_addr(s_full), empty_local = mma::smem_addr(s_empty);
    const unsigned empty_remote = kPair ? map_rank(empty_local, partner) : 0u;
    Walk at = walk_start();
    for (int q = 0; q < steps; ++q) {
      const int tile = q % kRTiles;
      bar_wait(full_local + 8u * tile, (q / kRTiles) & 1);
      product(q, at.c);
      __syncwarp();
      if (lane == 0) {
        bar_arrive(empty_local + 8u * tile);
        if constexpr (kPair) bar_arrive_remote(empty_remote + 8u * tile);
      }
      if (at.c_raw == chunks - 1) {
        epilogue(at.g0, at.c0);
        mma::zero(acc);
      }
      walk_next(at);
    }
  }
  // no block leaves while its partner may still store or arrive into it
  if constexpr (kPair) cluster_sync();
}

template <bool kPair, bool kVec>
cudaError_t set_resident_smem(size_t smem) {
  return cudaFuncSetAttribute(fused_sepconv_resident_kernel<kPair, kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// blocks of the resident kernel the card holds at once (a multiple of 2
// for a pair), or a negative CUDA error code
template <bool kPair, bool kVec>
int resident_capacity(size_t smem) {
  cudaError_t err = set_resident_smem<kPair, kVec>(smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return -static_cast<int>(err);
  }
  if constexpr (kPair) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(sms / 2 * 2));
    config.blockDim = dim3(kRThreads);
    config.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fused_sepconv_resident_kernel<kPair, kVec>, &config);
    if (err != cudaSuccess) return -static_cast<int>(err);
    return 2 * clusters;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_sepconv_resident_kernel<kPair, kVec>,
                                                        kRThreads, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    return per_sm * sms;
  }
}

template <bool kPair, bool kVec>
cudaError_t launch_resident(const void* x, const void* taps, const void* w, const void* s,
                            const void* t, const void* mask, void* y, int n, int cin, int cout,
                            int h, int wd, int th, int tw, int mb, int slices, int grid,
                            int wvec, int pre, int post, cudaStream_t stream) {
  if (th * pair_width(tw) > kRNb || mb <= 0 || mb > kRMb || mb % kRWarpRows != 0 ||
      static_cast<long long>(slices) * mb < cout || grid < slices || grid % slices != 0 ||
      (kPair && slices != 2) ||
      (kVec && resident_copies(kPair, th, tw) > kRCopies * kRProducers)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = resident_smem_bytes(cin, mb, kPair, th, tw);
  cudaError_t err = set_resident_smem<kPair, kVec>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid));
  config.blockDim = dim3(kRThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kPair ? 1 : 0;
  err = cudaLaunchKernelEx(&config, fused_sepconv_resident_kernel<kPair, kVec>, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(taps), static_cast<const bf16*>(w),
                           static_cast<const float*>(s), static_cast<const float*>(t),
                           static_cast<const float*>(mask), static_cast<bf16*>(y), n, cin, cout,
                           h, wd, th, tw, mb, slices, wvec, pre, post);
  if (err != cudaSuccess) return err;
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

// The resident kernel's dynamic shared memory for a slice of mb outputs
// (a pair: two slices as a cluster) at bands of th x tw: what the host's
// planner models, checked against this before a launch.
extern "C" long long udal_fused_sepconv_resident_smem(int cin, int mb, int pair, int th,
                                                      int tw) {
  return static_cast<long long>(resident_smem_bytes(cin, mb, pair != 0, th, tw));
}

// Blocks of the resident kernel the card holds at once at that shared
// memory (twice the clusters for a pair): the most a persistent grid may
// launch. A negative CUDA error code on failure.
extern "C" int udal_fused_sepconv_resident_capacity(int cin, int mb, int pair, int th, int tw,
                                                    int vec) {
  const size_t smem = resident_smem_bytes(cin, mb, pair != 0, th, tw);
  if (pair) return vec ? resident_capacity<true, true>(smem) : resident_capacity<true, false>(smem);
  return vec ? resident_capacity<false, true>(smem) : resident_capacity<false, false>(smem);
}

// The resident kernel: operands as udal_fused_sepconv's; slices of mb
// outputs (a multiple of 48, at most 192; slices * mb >= cout), grid
// blocks in groups of `slices` walking the bands (two slices run as a
// cluster of two); vec: x in 16-byte copies (wd a multiple of 8, x
// 16-byte aligned); wvec: W in 16-byte copies (cin a multiple of 8, w
// 16-byte aligned). Returns the CUDA error code of the launch.
extern "C" int udal_fused_sepconv_resident(const void* x, const void* taps, const void* w,
                                           const void* s, const void* t, const void* mask,
                                           void* y, int n, int cin, int cout, int h, int wd,
                                           int th, int tw, int mb, int slices, int grid, int vec,
                                           int wvec, int pre, int post, void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || h <= 0 || wd <= 0 || th <= 0 || tw <= 0 ||
      slices <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UDAL_SEP_RESIDENT(P, V)                                                                  \
  if ((slices == 2) == P && (vec != 0) == V)                                                     \
    return static_cast<int>(launch_resident<P, V>(x, taps, w, s, t, mask, y, n, cin, cout, h, wd, \
                                                  th, tw, mb, slices, grid, wvec, pre, post, st));
  UDAL_SEP_RESIDENT(false, false)
  UDAL_SEP_RESIDENT(false, true)
  UDAL_SEP_RESIDENT(true, false)
  UDAL_SEP_RESIDENT(true, true)
#undef UDAL_SEP_RESIDENT
  return static_cast<int>(cudaErrorInvalidValue);
}
