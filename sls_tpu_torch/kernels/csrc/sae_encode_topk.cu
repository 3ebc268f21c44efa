// Fused SAE encode + exact row top-k for Hopper (sm_90a).
//
// Replaces: sls_tpu/kernels/sae_kernels.py::sae_encode_topk_fused
// (lines 143-182; kernel body _encode_topk_kernel, 119-140; threshold
// search _topk_threshold_mask, 38-65).  It computes
//
//     acts  = relu(bf16(f32(bf16(x)) - b_dec) @ bf16(W_enc) + b_enc)
//     codes = where(bits(acts) >= lo, acts, 0)
//
// with fp32 accumulation and fp32 output [N, M], where lo is the int32
// bit pattern of the row's k-th largest value, found by the same 31-step
// binary search over [0, 0x7F800000) as the TPU kernel (non-negative
// floats order like their int32 bits).  Ties at the k-th value are all
// kept; a row with fewer than k positive entries ends at lo = 0 and
// keeps every entry.
//
// What bounds it on the H100: at the flagship shape (N = 36*201 = 7236,
// D = 1024, M = 4096) the product is 2*N*D*M = 60.7 GFLOP of bf16, 61 us
// at the 989 TFLOP/s data-sheet peak, against 165 MB that must move
// (x and W_enc read once as fp32, the fp32 codes written once), 49 us at
// 3.35 TB/s: the operations bound it.
//
// Design: the TPU kernel keeps all of W_enc and a 4096-wide fp32 row
// tile in VMEM; a 128-row tile of that is 2 MB, and a Hopper block gets
// at most 227 KB.  So the work is split in two kernels behind one entry:
//  (a) a tiled tensor-core GEMM: 128x128 output tiles, K stepped by 32
//      through shared memory, mma.sync m16n8k16 bf16 with fp32
//      accumulators in registers.  The fp32 -> bf16 casts and the b_dec
//      centring happen while a tile is stored to shared memory, so the
//      inputs are read as the caller holds them (fp32) and nothing is
//      staged in device memory.  The next K tile is loaded into
//      registers while the current one is multiplied.  Bias and ReLU are
//      applied in the epilogue; the dense activations go to `out`.
//  (b) a row select: one block per row copies the row's bit patterns to
//      shared memory, runs the 31 halvings with block-wide counts (warp
//      shuffles, then one sum over the warps), and rewrites the row in
//      place with every entry below the threshold zeroed.  The same
//      select, out of place, is the second entry topk_sparsify_launch.
// The dense activations make one extra round trip through device memory
// between (a) and (b); a fused select epilogue, wgmma and TMA are the
// later work that removes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // output rows per block
constexpr int BN = 128;           // output columns per block
constexpr int BK = 32;            // contraction step per shared tile
constexpr int A_LD = BK + 8;      // padded row of As: conflict-free ldmatrix
constexpr int B_LD = BN + 8;      // padded row of Bs: conflict-free ldmatrix.trans
constexpr int GEMM_THREADS = 256; // 8 warps: 2 (rows) x 4 (columns), 64x32 each
constexpr int SELECT_THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values packed low-first, as a 32-bit word
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(f32(bf16(x)) - b): the TPU kernel's centring of a bf16 input
__device__ __forceinline__ float centre(float x, float b) {
  return __bfloat162float(__float2bfloat16_rn(x)) - b;
}

__global__ void __launch_bounds__(GEMM_THREADS)
encode_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b_enc,
                   const float* __restrict__ b_dec, float* __restrict__ out,
                   int N, int D, int M) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK * B_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1 -> rows warp_m*64
  const int warp_n = warp & 3;   // 0..3 -> columns warp_n*32
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // per-thread slices of one K step: A is 128x32 fp32 (8 float4 a row),
  // B is 32x128 fp32 (32 float4 a row); 4 float4 of each per thread
  float4 ra[4], rd[4], rb[4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx >> 3, c = (idx & 7) * 4;
      const int gr = row0 + r;
      ra[i] = gr < N ? *reinterpret_cast<const float4*>(x + (size_t)gr * D + k0 + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      rd[i] = *reinterpret_cast<const float4*>(b_dec + k0 + c);
      const int kr = idx >> 5, n = (idx & 31) * 4;
      rb[i] = *reinterpret_cast<const float4*>(w + (size_t)(k0 + kr) * M + col0 + n);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx >> 3, c = (idx & 7) * 4;
      uint2 a;
      a.x = pack_bf16(centre(ra[i].x, rd[i].x), centre(ra[i].y, rd[i].y));
      a.y = pack_bf16(centre(ra[i].z, rd[i].z), centre(ra[i].w, rd[i].w));
      *reinterpret_cast<uint2*>(&As[r * A_LD + c]) = a;
      const int kr = idx >> 5, n = (idx & 31) * 4;
      uint2 b;
      b.x = pack_bf16(rb[i].x, rb[i].y);
      b.y = pack_bf16(rb[i].z, rb[i].w);
      *reinterpret_cast<uint2*>(&Bs[kr * B_LD + n]) = b;
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < D) load_tile(k0 + BK);  // in flight during the MMAs

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = warp_m * 64 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[mi], smem_addr(&As[r * A_LD + c]));
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int kr = kk + (lane & 15);
        const int n = warp_n * 32 + ni * 8;
        ldmatrix_x2_trans(bfr[ni], smem_addr(&Bs[kr * B_LD + n]));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  // epilogue: fragment (g, 2t..2t+1) and (g+8, 2t..2t+1) of each 16x8 tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = col0 + warp_n * 32 + ni * 8 + t * 2;
    const float2 be = *reinterpret_cast<const float2*>(b_enc + col);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = row0 + warp_m * 64 + mi * 16 + g;
      if (r < N) {
        float2 v = make_float2(fmaxf(acc[mi][ni][0] + be.x, 0.f),
                               fmaxf(acc[mi][ni][1] + be.y, 0.f));
        *reinterpret_cast<float2*>(out + (size_t)r * M + col) = v;
      }
      if (r + 8 < N) {
        float2 v = make_float2(fmaxf(acc[mi][ni][2] + be.x, 0.f),
                               fmaxf(acc[mi][ni][3] + be.y, 0.f));
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * M + col) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(SELECT_THREADS)
topk_select_kernel(const float* in, float* out, int M, int k) {
  // in and out may be the same rows: each row is read whole into shared
  // memory before any of it is written
  extern __shared__ int bits[];  // the row's M bit patterns
  __shared__ int warp_count[SELECT_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* row_in = in + (size_t)blockIdx.x * M;
  float* row_out = out + (size_t)blockIdx.x * M;

  for (int j = tid; j < M; j += SELECT_THREADS) bits[j] = __float_as_int(row_in[j]);
  __syncthreads();

  int lo = 0, hi = 0x7F800000;  // +inf bits
  for (int it = 0; it < 31; ++it) {
    const int mid = lo + ((hi - lo) >> 1);
    int c = 0;
    for (int j = tid; j < M; j += SELECT_THREADS) c += bits[j] >= mid;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
    if (lane == 0) warp_count[warp] = c;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w8 = 0; w8 < SELECT_THREADS / 32; ++w8) total += warp_count[w8];
    __syncthreads();  // every thread has read warp_count before it is reused
    if (total >= k) lo = mid; else hi = mid;
  }
  for (int j = tid; j < M; j += SELECT_THREADS)
    row_out[j] = bits[j] >= lo ? __int_as_float(bits[j]) : 0.f;
}

// the select's dynamic shared memory: one int per column
cudaError_t set_select_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(topk_select_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// x [N, D], w_enc [D, M], b_enc [M], b_dec [D], out [N, M]: fp32,
// contiguous, 16-byte aligned.  D % 32 == 0, M % 128 == 0, N >= 1.
extern "C" int sae_encode_topk_launch(const void* x, const void* w_enc,
                                      const void* b_enc, const void* b_dec,
                                      void* out, int N, int D, int M, int k,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(M / BN, (N + BM - 1) / BM);
  encode_gemm_kernel<<<grid, GEMM_THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_enc),
      static_cast<const float*>(b_enc), static_cast<const float*>(b_dec),
      static_cast<float*>(out), N, D, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(M) * sizeof(int);
  err = set_select_smem(smem);
  if (err != cudaSuccess) return err;
  float* acts = static_cast<float*>(out);
  topk_select_kernel<<<N, SELECT_THREADS, smem, s>>>(acts, acts, M, k);
  return cudaGetLastError();
}

// The exact row top-k alone (replaces sae_kernels.py::topk_sparsify_pallas,
// lines 232-259, kernel body _topk_mask_kernel, 225-229): out = in where
// bits(in) >= the row's k-th value's bits, else 0.  in, out [N, M] fp32,
// non-negative, contiguous; N >= 1.  Bytes bound it: one read of in and
// one write of out; the 31 halvings run on the shared-memory copy.
extern "C" int topk_sparsify_launch(const void* in, void* out, int N, int M,
                                    int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(M) * sizeof(int);
  cudaError_t err = set_select_smem(smem);
  if (err != cudaSuccess) return err;
  topk_select_kernel<<<N, SELECT_THREADS, smem, s>>>(
      static_cast<const float*>(in), static_cast<float*>(out), M, k);
  return cudaGetLastError();
}
