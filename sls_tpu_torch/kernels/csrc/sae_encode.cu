// SAE encode without top-k for Hopper (sm_90a), all in fp32:
//
//     out = relu((x - b_dec) @ W_enc + b_enc)      x [N, D] -> out [N, M]
//
// Replaces: sls_tpu/kernels/sae_kernels.py::sae_encode_fused (lines
// 74-116; kernel body _encode_kernel, 68-71).  Unlike the fused
// encode + top-k (sae_encode_topk.cu), the TPU kernel casts x, W_enc and
// both biases to fp32 and sums in fp32, so this kernel multiplies fp32
// operands on the CUDA cores: no bf16, and no TF32 (which would keep ten
// mantissa bits and change the numbers).
//
// What bounds it on the H100: at the window-overlap path's shape
// (N = 36*201 = 7236, D = 1024, M = 4096) the product is 2*N*D*M = 60.7
// GFLOP of fp32, 0.91 ms at the 67 TFLOP/s non-tensor fp32 peak, against
// about 165 MB that must move (x and W_enc read once, out written once),
// 0.05 ms at 3.35 TB/s: the operations bound it, by a factor of 18.
//
// Design: the classic register-blocked SIMT GEMM, whose aim is to keep
// the FMA pipes fed from registers.  Each block owns a 128x128 output
// tile; its 256 threads each own an 8x8 sub-tile (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise with tx), so every value read
// from shared memory feeds 8 FMAs.  K is stepped by 16 through two
// shared-memory buffers: the next step's operands are loaded into
// registers while the current step is multiplied, then stored to the
// other buffer, one barrier a step.  The x tile is stored transposed
// (k-major) with a 4-float pad per row so the transposing stores hit
// distinct banks and the float4 reads stay aligned.  The b_dec centring
// is applied as the x tile is loaded, bias and ReLU in the epilogue, so
// nothing but x, W_enc and the output touches device memory.  cp.async,
// a deeper pipeline and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 16;        // contraction step per shared tile
constexpr int AS_LD = BM + 4; // padded k-major row of the x tile
constexpr int THREADS = 256;  // 16 x 16 threads, 8x8 outputs each
constexpr int A_F4 = BK / 4;  // float4 in a row of the x tile
constexpr int B_F4 = BN / 4;  // float4 in a row of the W tile
constexpr int LOADS = BM * BK / 4 / THREADS;  // float4 of each tile a thread
static_assert(BM * BK == BK * BN && LOADS * THREADS * 4 == BM * BK, "tile shape");

__global__ void __launch_bounds__(THREADS)
encode_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b_enc,
                  const float* __restrict__ b_dec, float* __restrict__ out,
                  int N, int D, int M) {
  __shared__ __align__(16) float As[2][BK * AS_LD];  // As[k][row]
  __shared__ __align__(16) float Bs[2][BK * BN];     // Bs[k][col]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // loads of one K step: the x tile is BM rows x BK, the W tile BK rows
  // x BN, LOADS float4 of each a thread
  float4 ra[LOADS], rb[LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / A_F4, c = (idx % A_F4) * 4;
      const int gr = row0 + r;
      if (gr < N) {
        const float4 v = *reinterpret_cast<const float4*>(x + (size_t)gr * D + k0 + c);
        const float4 b = *reinterpret_cast<const float4*>(b_dec + k0 + c);
        ra[i] = make_float4(v.x - b.x, v.y - b.y, v.z - b.z, v.w - b.w);
      } else {
        ra[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const int kr = idx / B_F4, n = (idx % B_F4) * 4;
      rb[i] = *reinterpret_cast<const float4*>(w + (size_t)(k0 + kr) * M + col0 + n);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / A_F4, c = (idx % A_F4) * 4;
      float* a = &As[buf][c * AS_LD + r];
      a[0] = ra[i].x;
      a[AS_LD] = ra[i].y;
      a[2 * AS_LD] = ra[i].z;
      a[3 * AS_LD] = ra[i].w;
      const int kr = idx / B_F4, n = (idx % B_F4) * 4;
      *reinterpret_cast<float4*>(&Bs[buf][kr * BN + n]) = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = D / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* a = &As[buf][kk * AS_LD];
      const float* b = &Bs[buf][kk * BN];
      const float4 a0 = *reinterpret_cast<const float4*>(a + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read in step s - 1, before its barrier
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: bias + ReLU, four float4 stores a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = col0 + h * 64 + tx * 4;
    const float4 be = *reinterpret_cast<const float4*>(b_enc + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + (i >> 2) * 64 + ty * 4 + (i & 3);
      if (r >= N) continue;
      const float* c = &acc[i][h * 4];
      *reinterpret_cast<float4*>(out + (size_t)r * M + col) =
          make_float4(fmaxf(c[0] + be.x, 0.f), fmaxf(c[1] + be.y, 0.f),
                      fmaxf(c[2] + be.z, 0.f), fmaxf(c[3] + be.w, 0.f));
    }
  }
}

}  // namespace

// x [N, D], w_enc [D, M], b_enc [M], b_dec [D], out [N, M]: fp32,
// contiguous, 16-byte aligned.  D % 16 == 0, M % 128 == 0, N >= 1.
extern "C" int sae_encode_launch(const void* x, const void* w_enc,
                                 const void* b_enc, const void* b_dec,
                                 void* out, int N, int D, int M,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(M / BN, (N + BM - 1) / BM);
  encode_f32_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_enc),
      static_cast<const float*>(b_enc), static_cast<const float*>(b_dec),
      static_cast<float*>(out), N, D, M);
  return cudaGetLastError();
}
