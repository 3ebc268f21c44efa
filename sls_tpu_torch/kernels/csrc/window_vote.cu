// Overlap-window vote merge for Hopper (sm_90a), in the TPU kernel's bf16
// arithmetic.
//
// Replaces: sls_tpu/kernels/sae_kernels.py::window_vote_fused (lines
// 330-367; kernel body _window_vote_kernel, 262-327).  For each
// utterance of acts [B, T, M] (post-ReLU fp32), with stride = window / 2,
// frames zero-padded to n_chunks * stride and num_windows windows of two
// chunks each:
//
//   a       = bf16(acts)
//   chunk_j = fp32 sum of the stride frames of chunk j, in frame order
//   wsum_i  = bf16(chunk_i + chunk_{i+1})
//   mask_i  = bits(wsum_i) >= kth_i     (15-step search on the int16 bits)
//   cover_j = mask_{j-1} + mask_j       (valid windows only)
//   votes_t = a_t * cover_{t / stride}  (exact: cover is 0, 1 or 2)
//   out_t   = bits(votes_t) >= kth_t && votes_t > 0 ? a_t : 0   (as fp32)
//
// Non-negative bf16 values order like their int16 bit patterns, so the
// 15 halvings of [0, 0x7F80) find each row's k-th value exactly at bf16
// granularity; every entry >= it is kept, and a row with fewer than k
// positive entries keeps all of them.
//
// What bounds it on the H100: at the flagship shape (B 36, T 201, M 4096,
// window 8: 49 windows) the function must read acts once and write out
// once, 237 MB in fp32, 71 us at 3.35 TB/s; its arithmetic (chunk and
// window sums, 15 compare-and-count passes over 49 + 201 rows per
// utterance) is a few GOP, well under that at the card's rates: bytes
// bound it.
//
// Design: the TPU kernel holds a whole utterance (204 x 4096 bf16, 1.7
// MB) in VMEM; a Hopper block gets 227 KB.  So the work is split in two
// launches behind one entry, each block holding one M-wide row in shared
// memory:
//  (a) window_mask_kernel, one block per (window, utterance): reads the
//      window's two chunks of fp32 frames (coalesced along M), casts each
//      value to bf16 on the load (padding frames read as zero), forms the
//      bf16 window sum row in shared memory, runs the 15 halvings with
//      block-wide counts as the top-k select does, and writes the 0/1
//      window mask as bytes, [B, num_windows, M].
//  (b) frame_vote_kernel, one block per (frame, utterance), frames < T
//      only: reads its frame and the two covering windows' masks, forms
//      the bf16 vote row, runs the 15 halvings and writes the output row.
// Every frame is read by two windows in (a) and once in (b), so acts
// cross device memory three times instead of once; a fused version
// would keep a stripe of chunk sums on chip and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// int16 bit pattern of a value that is already bf16-exact, sign-extended
__device__ __forceinline__ int bf16_bits(float v) {
  return static_cast<int>(static_cast<int16_t>(__float_as_uint(v) >> 16));
}

// the row's k-th value's bit pattern: 15 halvings of [0, 0x7F80) with
// block-wide counts; every thread returns the same lo
__device__ int kth_bits(const int* bits, int M, int k, int* warp_count) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int lo = 0, hi = 0x7F80;  // bf16 +inf bits
  for (int it = 0; it < 15; ++it) {
    const int mid = lo + ((hi - lo) >> 1);
    int c = 0;
    for (int j = tid; j < M; j += THREADS) c += bits[j] >= mid;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
    if (lane == 0) warp_count[warp] = c;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w8 = 0; w8 < THREADS / 32; ++w8) total += warp_count[w8];
    __syncthreads();  // every thread has read warp_count before it is reused
    if (total >= k) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
window_mask_kernel(const float* __restrict__ acts, uint8_t* __restrict__ mask,
                   int T, int M, int k, int stride, int num_windows) {
  extern __shared__ int bits[];  // the window sum row's M bit patterns
  __shared__ int warp_count[THREADS / 32];
  const int win = blockIdx.x, b = blockIdx.y;
  const float* base = acts + (size_t)b * T * M;

  for (int j = threadIdx.x; j < M; j += THREADS) {
    float chunk[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t0 = (win + h) * stride;
      float s = 0.f;
      for (int r = 0; r < stride; ++r) {
        const int t = t0 + r;
        s += t < T ? to_bf16(base[(size_t)t * M + j]) : 0.f;
      }
      chunk[h] = s;
    }
    bits[j] = bf16_bits(to_bf16(chunk[0] + chunk[1]));
  }
  __syncthreads();
  const int lo = kth_bits(bits, M, k, warp_count);
  uint8_t* out = mask + ((size_t)b * num_windows + win) * M;
  for (int j = threadIdx.x; j < M; j += THREADS) out[j] = bits[j] >= lo;
}

__global__ void __launch_bounds__(THREADS)
frame_vote_kernel(const float* __restrict__ acts, const uint8_t* __restrict__ mask,
                  float* __restrict__ out, int T, int M, int k, int stride,
                  int num_windows) {
  extern __shared__ int bits[];  // the vote row's M bit patterns
  __shared__ int warp_count[THREADS / 32];
  const int t = blockIdx.x, b = blockIdx.y;
  const size_t row = (size_t)b * T + t;
  const int chunk = t / stride;
  // windows chunk - 1 and chunk cover this frame, where they exist
  const uint8_t* m_prev = chunk >= 1 && chunk - 1 < num_windows
      ? mask + ((size_t)b * num_windows + chunk - 1) * M : nullptr;
  const uint8_t* m_this = chunk < num_windows
      ? mask + ((size_t)b * num_windows + chunk) * M : nullptr;

  for (int j = threadIdx.x; j < M; j += THREADS) {
    const int cover = (m_prev ? m_prev[j] : 0) + (m_this ? m_this[j] : 0);
    bits[j] = bf16_bits(to_bf16(acts[row * M + j]) * static_cast<float>(cover));
  }
  __syncthreads();
  const int lo = kth_bits(bits, M, k, warp_count);
  float* o = out + row * M;
  for (int j = threadIdx.x; j < M; j += THREADS) {
    const int v = bits[j];
    o[j] = v >= lo && v > 0 ? to_bf16(acts[row * M + j]) : 0.f;
  }
}

}  // namespace

// acts [B, T, M] fp32 post-ReLU, out [B, T, M] fp32, mask scratch
// [B, num_windows, M] bytes; contiguous.  stride = window / 2 >= 1,
// num_windows >= 1, B, T >= 1.
extern "C" int window_vote_launch(const void* acts, void* mask, void* out,
                                  int B, int T, int M, int k, int stride,
                                  int num_windows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(M) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(frame_vote_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float* a = static_cast<const float*>(acts);
  uint8_t* m = static_cast<uint8_t*>(mask);
  window_mask_kernel<<<dim3(num_windows, B), THREADS, smem, s>>>(
      a, m, T, M, k, stride, num_windows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  frame_vote_kernel<<<dim3(T, B), THREADS, smem, s>>>(
      a, m, static_cast<float*>(out), T, M, k, stride, num_windows);
  return cudaGetLastError();
}
