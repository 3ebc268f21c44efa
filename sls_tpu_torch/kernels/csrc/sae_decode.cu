// SAE decode for Hopper (sm_90a): out = codes @ W_dec + b_dec, fp32.
//
// Replaces: sls_tpu/kernels/sae_kernels.py::sae_decode_fused (lines
// 440-494), whose TPU kernel streams dense [256, 1024] code tiles and
// [1024, D] weight tiles through the MXU with an accumulating fp32
// output block.
//
// What bounds it on the H100: the codes come out of the top-k encode
// with k of M entries nonzero (k/M = 128/4096, about 3 %).  The product
// these inputs need is 2*nnz*D operations: at the flagship shape
// (N = 7236, M = 4096, D = 1024, nnz ~ N*k) 1.9 GFLOP of fp32, 28 us at
// the 67 TFLOP/s non-tensor fp32 peak, while the bytes that must move
// (codes 119 MB and W_dec 17 MB read once, out 30 MB written once) take
// 49 us at 3.35 TB/s: memory bounds it.  A dense product would be 60.7
// GFLOP of fp32, 0.9 ms at that peak, so the design skips the zeros.
//
// Design: one block per row.  The block reads the row of codes once,
// coalesced, and compacts its nonzero (index, value) pairs into shared
// memory in ascending index order (warp ballots and a prefix over the
// warps: deterministic, no atomics).  Then each thread owns four output
// columns and walks the list, reading one 16-byte slice of each selected
// W_dec row; a warp's reads of one row are contiguous, and W_dec (16 MB)
// stays in the 50 MB L2 across rows.  Sums are fp32 in index order, then
// the bias is added, as in codes @ W_dec + b_dec.  No TF32.  Rows share
// no work, so each selected W_dec row is read from L2 once per row that
// selects it; batching rows that share atoms is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ codes, const float* __restrict__ w,
              const float* __restrict__ b, float* __restrict__ out, int M,
              int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* nz_idx = reinterpret_cast<int*>(smem);      // [M]
  float* nz_val = reinterpret_cast<float*>(nz_idx + M);  // [M]
  __shared__ int warp_total[THREADS / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* crow = codes + row * M;

  int nnz = 0;  // the same in every thread
  for (int j0 = 0; j0 < M; j0 += THREADS) {
    const int j = j0 + tid;
    const float v = j < M ? crow[j] : 0.f;
    const bool keep = v != 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = nnz, chunk = 0;
#pragma unroll
    for (int w8 = 0; w8 < THREADS / 32; ++w8) {
      chunk += warp_total[w8];
      if (w8 < warp) before += warp_total[w8];
    }
    if (keep) {
      const int slot = before + __popc(ballot & ((1u << lane) - 1u));
      nz_idx[slot] = j;
      nz_val[slot] = v;
    }
    __syncthreads();  // warp_total is rewritten by the next chunk
    nnz += chunk;
  }

  const int d4_count = D / 4;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4* o4 = reinterpret_cast<float4*>(out + row * D);
  for (int d4 = tid; d4 < d4_count; d4 += THREADS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < nnz; ++i) {
      const float c = nz_val[i];
      const float4 wv = __ldg(w4 + (size_t)nz_idx[i] * d4_count + d4);
      acc.x = fmaf(c, wv.x, acc.x);
      acc.y = fmaf(c, wv.y, acc.y);
      acc.z = fmaf(c, wv.z, acc.z);
      acc.w = fmaf(c, wv.w, acc.w);
    }
    const float4 bb = b4[d4];
    o4[d4] = make_float4(acc.x + bb.x, acc.y + bb.y, acc.z + bb.z, acc.w + bb.w);
  }
}

}  // namespace

// codes [N, M], w_dec [M, D], b_dec [D], out [N, D]: fp32, contiguous,
// 16-byte aligned.  D % 4 == 0, N >= 1.
extern "C" int sae_decode_launch(const void* codes, const void* w_dec,
                                 const void* b_dec, void* out, int N, int M,
                                 int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(M) * (sizeof(int) + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_kernel<<<N, THREADS, smem, s>>>(
      static_cast<const float*>(codes), static_cast<const float*>(w_dec),
      static_cast<const float*>(b_dec), static_cast<float*>(out), M, D);
  return cudaGetLastError();
}
