// The encoder's fp32 LayerNorm over rows for Hopper (sm_90a): bf16 or fp32
// rows in, fp32 arithmetic, rows out in the input's dtype.
//
// Replaces no TPU kernel: the JAX package leaves this LayerNorm to XLA,
// which fuses it.  In eager PyTorch the same function (Fp32LayerNorm in
// encoder/xlsr.py, the fast-variance form of kernels/frontend.py's
// fp32_layer_norm) is 14 launches: a cast to fp32, two reductions, five
// [N, 1] ops, four full-size broadcast passes and a cast back, ~444 MB of
// traffic at the scoring batch's [36 * 201, 1024] bf16 where one read and
// one write of the rows are 29.6 MB.  A forward makes ~50 such calls (two
// a layer, the encoder's final norm, the post-extract norm, the head's), so
// they were both device time (the scoring batch) and host launches (a long
// clip at batch 1).  Per row of width C it computes
//
//     mean = sum(x) / C,  var = max(sum(x^2) / C - mean^2, 0)
//     y    = dtype((x - mean) * rsqrt(var + eps) * scale + shift)
//
// with x in fp32, scale and shift fp32, each step rounded in fp32 as the
// plain version's passes round it, and one rounding at the end.
//
// What bounds it on the H100: bytes.  N C (in + out) itemsize over 3.35
// TB/s: 8.8 us at [7236, 1024] bf16.  Two flops a byte; scale and shift
// (C fp32 each) are read from L1 / L2 by every row.
//
// Design.  A warp owns a row and holds it in registers: lane l loads the
// 16-byte vectors l, l + 32, l + 64, ... of the row (consecutive lanes on
// consecutive addresses), C / 32 values a lane (32 at C 1024, 16 at 512,
// 128 at the head's 4096), all loads issued before any is used.  Each lane
// sums its values and their squares in fp32; two warp butterflies
// (shuffles, no shared memory) give every lane the row's sums; the lane
// then normalises its values and stores them back as 16-byte vectors.
// ROWS warps a block, one row each, and a grid that covers N with the last
// block's extra warps idle.  The input rows may be a strided view (one row
// stride, 16-byte aligned); the output is contiguous.  Loads and stores
// carry no cache hints: the rows are usually in L2 from the residual add
// that made them, and the next GEMM reads the output from there.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 4;             // rows (warps) a block
constexpr int THREADS = ROWS * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A 16-byte vector of T as floats and back (round to nearest even).
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 r = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&r);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// (x - mean) * rstd * scale + shift, each product and sum rounded on its
// own (no fused multiply-add), as the plain version's passes are
__device__ __forceinline__ float affine(float x, float mean, float rstd, float a, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), a), b);
}

template <int C, typename T>
__global__ void __launch_bounds__(THREADS)
layernorm_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      long long n_rows, long long row_stride, float eps) {
  constexpr int E = Vec<T>::N;       // values a 16-byte vector
  constexpr int V = C / (32 * E);    // vectors a lane
  static_assert(C % (32 * E) == 0, "a row is whole 16-byte vectors on every lane");
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp: no block-wide barrier follows
  const uint4* src = reinterpret_cast<const uint4*>(x + row * row_stride);
  uint4 raw[V];
#pragma unroll
  for (int i = 0; i < V; ++i) raw[i] = src[i * 32 + lane];
  float v[V * E];
#pragma unroll
  for (int i = 0; i < V; ++i) Vec<T>::unpack(raw[i], v + i * E);
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int j = 0; j < V * E; ++j) {
    s += v[j];
    q += __fmul_rn(v[j], v[j]);
  }
  s = warp_sum(s);
  q = warp_sum(q);
  const float mean = s / C;
  const float var = fmaxf(__fsub_rn(q / C, __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(var + eps);
  const float4* sc = reinterpret_cast<const float4*>(scale);
  const float4* sh = reinterpret_cast<const float4*>(shift);
  uint4* dst = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c4 = (i * 32 + lane) * (E / 4);  // the vector's first channel, in float4s
    float o[E];
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 a = __ldg(sc + c4 + k), b = __ldg(sh + c4 + k);
      const float* xv = v + i * E + 4 * k;
      o[4 * k] = affine(xv[0], mean, rstd, a.x, b.x);
      o[4 * k + 1] = affine(xv[1], mean, rstd, a.y, b.y);
      o[4 * k + 2] = affine(xv[2], mean, rstd, a.z, b.z);
      o[4 * k + 3] = affine(xv[3], mean, rstd, a.w, b.w);
    }
    dst[i * 32 + lane] = Vec<T>::pack(o);
  }
}

template <int C, typename T>
cudaError_t launch(const void* x, void* y, const float* scale, const float* shift,
                   long long n_rows, long long row_stride, float eps, cudaStream_t st) {
  const long long blocks = (n_rows + ROWS - 1) / ROWS;
  layernorm_rows_kernel<C, T><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, shift, n_rows, row_stride, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int width, const void* x, void* y, const float* scale,
                         const float* shift, long long n_rows, long long row_stride, float eps,
                         cudaStream_t st) {
  switch (width) {
    case 512: return launch<512, T>(x, y, scale, shift, n_rows, row_stride, eps, st);
    case 1024: return launch<1024, T>(x, y, scale, shift, n_rows, row_stride, eps, st);
    case 4096: return launch<4096, T>(x, y, scale, shift, n_rows, row_stride, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y [n_rows, width] (contiguous) = LayerNorm of the rows of x, row r at
// x + r * row_stride elements; x, y, scale and shift 16-byte aligned, the
// row stride a whole number of 16-byte vectors and at least the width;
// width 512, 1024 or 4096; bf16 (is_bf16 = 1) or fp32 rows; scale and
// shift fp32 [width].  Returns the launch's cudaError_t.
extern "C" int layernorm_rows_launch(const void* x, void* y, const void* scale,
                                     const void* shift, long long n_rows, int width,
                                     long long row_stride, float eps, int is_bf16,
                                     void* stream) {
  if (n_rows == 0) return cudaSuccess;
  const int itemsize = is_bf16 ? 2 : 4;
  if (n_rows < 0 || row_stride < width || (row_stride * itemsize) % 16 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(shift)) % 16)
    return cudaErrorInvalidValue;
  const float* fs = static_cast<const float*>(scale);
  const float* fh = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_width<bf16>(width, x, y, fs, fh, n_rows, row_stride, eps, st)
                 : launch_width<float>(width, x, y, fs, fh, n_rows, row_stride, eps, st);
}
