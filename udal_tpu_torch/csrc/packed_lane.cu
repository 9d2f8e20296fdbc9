// Packed-layout lane passes for Hopper (sm_90a): the shift along W, the +1
// pass through two views, and the 3-tap depthwise along W.
//
// Replaces four TPU kernels of tools/perf_packed.py and computes what
// udal_tpu_torch/ops/packed.py's plain versions compute:
//   :147 packed_wshift_kernel (call :180)   -> wshift_kernel
//   :236 kernel of case_p1.run (call :241)  -> add_one_kernel
//   :264 kernel of case_p1.fn_copy (:266)   -> add_one_kernel
//   :296 kernel of case_p2 (call :313)      -> dw_w3_kernel
//
// The packed tensor [N, H, W/g, g*C] is, in row-major memory, the NHWC
// tensor [N, H, W, C] itself: packing g pixels into a row was a TPU lane
// layout. So a shift of one pixel along W is a copy of each (n, h) row
// offset by C values with one zeroed pixel, and the neighbours a depthwise
// tap reads sit C values either side; the TPU kernels' lane rolls and
// slice-concats are not carried over. The relayout [Mp, g*C] -> [g*Mp, C]
// that case_p1.run asked of Mosaic (refused there, :378-380) is the
// identity here, so the two +1 kernels are one body over the same bytes.
//
// What bounds them: bytes. wshift and dw_w3 move 1.51 GB each at the
// probe's shape (two 755 MB tensors), 0.45 ms at 3.35 TB/s. A block takes
// one (n, h) row and moves it as 16-byte vectors when C is a multiple of 8
// (the offset of C values then keeps every vector aligned), unrolled so a
// thread keeps several loads in flight. dw_w3 multiplies and adds with
// __fmul_rn / __fadd_rn in the plain version's order, so no multiply-add is
// contracted and its result is the plain version's bit for bit. The +1 pass
// moves 15.7 MB each way in one grid of at most one wave of resident blocks
// (kAddBlocksPerSm on each SM), each thread first issuing kAddUnroll 16-byte
// loads through the read-only path (__ldg), then adding and storing them, in
// a grid-stride loop; the values past the last whole vector, and every value
// when a pointer is not 16-byte aligned, take a scalar loop. (A first design
// with four loads a thread, the L1::no_allocate hint and 64-bit indices
// spilled at 8 blocks an SM and was slower; PERF.md has the times.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kAddUnroll = 2;      // 16-byte loads a thread has in flight in the +1 pass
constexpr int kAddBlocksPerSm = 8;  // 8 x 256 threads: an SM's 2,048, at <= 32 registers

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// eight values rounded to bf16 (nearest even), as torch's .to(torch.bfloat16)
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// B5: y[r, i] = x[r, i + shift] inside each row of row_len values, 0 past
// its ends; shift = +C (the value at w + 1) or -C (at w - 1).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
wshift_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int row_len, int shift) {
  const size_t base = static_cast<size_t>(blockIdx.x) * row_len;
  if constexpr (kVec) {
    const int nv = row_len / 8;
    const int sv = shift / 8;
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    uint4* yv = reinterpret_cast<uint4*>(y + base);
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const int j = i + sv;
      yv[i] = (j >= 0 && j < nv) ? __ldg(xv + j) : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < row_len; i += kThreads) {
      const int j = i + shift;
      y[base + i] = (j >= 0 && j < row_len) ? x[base + j] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ bf16 add_one(bf16 v) {
  return __float2bfloat16(__bfloat162float(v) + 1.f);
}

// B6 and B7: y = x + 1 over `total` values, f32 add, one rounding to bf16.
// The first nvec * 8 values go as 16-byte vectors (both pointers aligned),
// the rest one at a time. The vector loop indexes in 32 bits (the host
// keeps nvec and the stride in range): 64-bit indices took the registers
// of 8 resident blocks past 32 a thread and spilled.
__global__ void __launch_bounds__(kThreads, kAddBlocksPerSm)
add_one_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int nvec, long long total) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (int base = tid; base < nvec; base += stride * kAddUnroll) {
    uint4 v[kAddUnroll];
#pragma unroll
    for (int u = 0; u < kAddUnroll; ++u) {
      if (base + u * stride < nvec) v[u] = __ldg(xv + base + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kAddUnroll; ++u) {
      if (base + u * stride < nvec) {
        float f[8];
        unpack8(v[u], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] += 1.f;
        yv[base + u * stride] = pack8(f);
      }
    }
  }
  for (long long i = 8LL * nvec + tid; i < total; i += stride) y[i] = add_one(x[i]);
}

// B8: y[w] = (x[w-1] t0[l] + x[w] t1[l]) + x[w+1] t2[l] along each row of
// row_len = W*C values, zeros past its ends; l = (w mod g)*C + c is the
// position within the packed row of gc = g*C values, and taps [3, gc] f32.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dw_w3_kernel(const bf16* __restrict__ x, const float* __restrict__ taps, bf16* __restrict__ y,
             int row_len, int c, int gc) {
  const size_t base = static_cast<size_t>(blockIdx.x) * row_len;
  if constexpr (kVec) {
    const int nv = row_len / 8;
    const int cv = c / 8;
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    uint4* yv = reinterpret_cast<uint4*>(y + base);
    const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll 2
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const int l = (i * 8) % gc;
      float left[8], mid[8], right[8], t[3][8], out[8];
      unpack8(i >= cv ? __ldg(xv + i - cv) : zero, left);
      unpack8(__ldg(xv + i), mid);
      unpack8(i + cv < nv ? __ldg(xv + i + cv) : zero, right);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4* tv = reinterpret_cast<const float4*>(taps + k * gc + l);
        const float4 lo = __ldg(tv), hi = __ldg(tv + 1);
        t[k][0] = lo.x, t[k][1] = lo.y, t[k][2] = lo.z, t[k][3] = lo.w;
        t[k][4] = hi.x, t[k][5] = hi.y, t[k][6] = hi.z, t[k][7] = hi.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[e] = __fadd_rn(__fadd_rn(__fmul_rn(left[e], t[0][e]), __fmul_rn(mid[e], t[1][e])),
                           __fmul_rn(right[e], t[2][e]));
      }
      yv[i] = pack8(out);
    }
  } else {
    for (int i = threadIdx.x; i < row_len; i += kThreads) {
      const int l = i % gc;
      const float left = i >= c ? __bfloat162float(x[base + i - c]) : 0.f;
      const float right = i + c < row_len ? __bfloat162float(x[base + i + c]) : 0.f;
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(left, taps[l]),
                                          __fmul_rn(__bfloat162float(x[base + i]), taps[gc + l])),
                                __fmul_rn(right, taps[2 * gc + l]));
      y[base + i] = __float2bfloat16(v);
    }
  }
}

}  // namespace

// Every function below takes bf16 tensors, row-major and contiguous, and
// with vec != 0 the caller vouches that the rows and shifts are multiples
// of 8 values and the pointers 16-byte aligned. Each returns the CUDA error
// code of its launch (0 on success).

// x, y [rows, row_len]; shift = +C or -C.
extern "C" int udal_packed_wshift(const void* x, void* y, int rows, int row_len, int shift,
                                  int vec, void* stream) {
  if (rows <= 0 || row_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xi = static_cast<const bf16*>(x);
  bf16* yo = static_cast<bf16*>(y);
  if (vec) {
    wshift_kernel<true><<<rows, kThreads, 0, s>>>(xi, yo, row_len, shift);
  } else {
    wshift_kernel<false><<<rows, kThreads, 0, s>>>(xi, yo, row_len, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: `total` values, contiguous. Vectors when both pointers are 16-byte
// aligned; a grid of at most one wave of resident blocks.
extern "C" int udal_add_one(const void* x, void* y, long long total, void* stream) {
  // the vector loop's 32-bit index runs to nvec + stride * kAddUnroll
  if (total <= 0 || total / 8 > INT_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const long long nvec = vec ? total / 8 : 0;
  // blocks for the vectors at kAddUnroll a thread, or for the scalars at one
  const long long work = nvec > 0 ? (nvec + kThreads * kAddUnroll - 1) / (kThreads * kAddUnroll)
                                  : (total + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(sms) * kAddBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(work < wave ? work : wave);
  add_one_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), static_cast<int>(nvec), total);
  return static_cast<int>(cudaGetLastError());
}

// x, y [rows, row_len = W*C]; taps [3, gc = g*C] f32.
extern "C" int udal_packed_dw_w3(const void* x, const void* taps, void* y, int rows, int row_len,
                                 int c, int gc, int vec, void* stream) {
  if (rows <= 0 || row_len <= 0 || c <= 0 || gc <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xi = static_cast<const bf16*>(x);
  const float* ti = static_cast<const float*>(taps);
  bf16* yo = static_cast<bf16*>(y);
  if (vec) {
    dw_w3_kernel<true><<<rows, kThreads, 0, s>>>(xi, ti, yo, row_len, c, gc);
  } else {
    dw_w3_kernel<false><<<rows, kThreads, 0, s>>>(xi, ti, yo, row_len, c, gc);
  }
  return static_cast<int>(cudaGetLastError());
}
