// Attention softmax(q k^T) v per head for Hopper (sm_90a): one kernel
// behind three entries.
//
// Replaces three TPU kernels that compute the same function with other
// layouts and grids:
//   sls_tpu/kernels/flash_attention.py::flash_attention_long (lines 52-109;
//     kernel body _flash_kernel, 34-46): one 256-row q block against the
//     whole K/V strip of its (batch, head) held in VMEM;
//   sls_tpu/kernels/attention.py::fused_attention (117-152; _attn_kernel,
//     105-113): one grid cell per (batch, head), the whole T;
//   sls_tpu/kernels/attention.py::fused_attention_heads (56-102;
//     _attn_heads_kernel, 38-52): h_blk heads per cell as lane slices.
// Each computes, per (batch b, head h), with q pre-scaled by Dh^-0.5:
//
//     s = q_h . k_h^T                 (fp32 sums of exact products)
//     p = softmax(s) over the keys    (fp32)
//     o = f32(dtype(p)) . v_h         (p rounded to v's dtype, fp32 sums)
//
// and writes o in q's dtype.  q is [B, Tq, H*Dh], k and v [B, Tkv, H*Dh],
// read in place: head h is the column offset h*Dh with row stride H*Dh,
// so no [B*H, T, Dh] relayout happens on either side ([B, T, H, Dh] of
// fused_attention is the same memory).
//
// What bounds it on the H100: at the long-T bucket (B 1, T 5120, H 16,
// Dh 64) the function is 4*B*T^2*C = 107 GFLOP of bf16 products against
// 42 MB of q, k, v and o, so the operations bound it (0.109 ms at the
// 989 TFLOP/s data-sheet peak).  At the short-T flagship shape
// [36, 201, 16, 64] it is 5.96 GFLOP against 59 MB: bytes (0.018 ms).
//
// Design.  The TPU kernel's whole-strip softmax cannot be repeated: at
// T = 5120 the fp32 score strip of even 64 queries is 1.3 MB and a
// Hopper block gets at most 227 KB of shared memory.  So K and V stream
// through shared memory in 64-key tiles (cp.async, two buffers: the next
// tile loads while the current one is multiplied), and the softmax takes
// two passes over them, which keeps the reference's rounding point:
//   pass 1: s = q k^T on the tensor cores, each thread's running row max
//           and sum of exp, merged over the four threads of a row at the
//           end;
//   pass 2: s again (the same products in the same order, so the same
//           bits), p = exp(s - max) / sum, p rounded to bf16 straight from
//           the score fragments into A fragments, and o += p v.
// A one-pass online softmax would round the unnormalised p instead,
// which at bf16 is another function; the second pass costs 1.5x the
// function's operations.  The exponentials are ex2.approx of s*log2(e)
// less max*log2(e) (one FFMA and one MUFU op a score) and p is scaled by
// 1/sum: both are within a few fp32 ulps of exp(s - max) / sum, far
// below the bf16 rounding of p that follows.  Grid: one block per
// (128-query tile, head, batch); 8 warps, each owning 16 query rows,
// mma.sync m16n8k16 bf16 with fp32 accumulators (the fragment code of
// sae_encode_topk.cu).
// Keys past Tkv are masked to -inf and their rows zero-filled; query
// rows past Tq are computed on zeros and not written (ragged T = 201).
// fp32 operands (the reference's fp32 tests) take a SIMT kernel: one
// query row a thread, K/V tiles broadcast from shared memory.  wgmma,
// TMA and a warp-specialised pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DH = 64;               // head dim the kernels take
constexpr int BQ = 128;              // query rows per block (bf16)
constexpr int BKV = 64;              // keys per shared-memory tile
constexpr int LD = DH + 8;           // padded bf16 row: conflict-free ldmatrix
constexpr int THREADS = 256;         // 8 warps x 16 query rows
constexpr int TILE = BKV * LD;       // elements of one K or V tile
static_assert(BQ * LD <= 2 * TILE, "the q tile is staged in the two K buffers");

constexpr int F32_BQ = 64;           // fp32: query rows per block, one a thread
constexpr int F32_BKV = 32;          // fp32: keys per shared-memory tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

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

// rows [row0, row0 + R) of one head's [T, DH] slab (row stride C) into a
// padded shared tile [R][LD]; rows at or past n_rows are zero-filled
template <int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int n_rows, int C, int tid) {
  constexpr int CHUNKS = R * (DH / 8);  // 16-byte chunks
  static_assert(CHUNKS % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < CHUNKS / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i >> 3, c = (i & 7) * 8;
    const bool valid = row0 + r < n_rows;
    const bf16* g = src + (size_t)(valid ? row0 + r : 0) * C + c;
    cp_async16(dst + r * LD + c, g, valid);
  }
}

// s = q k^T for this warp's 16 rows against a 64-key tile: 8 fragments of
// 16x8; keys at or past n_keys (counted from the tile's first) are -inf
__device__ __forceinline__ void tile_scores(float (&s)[8][4], uint32_t (&qf)[4][4],
                                            const bf16* kt, int lane, int n_keys) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      // B fragments of key tiles 2jp and 2jp+1: matrices (keys, dh) at
      // (+0, +0), (+0, +8), (+8, +0), (+8, +8)
      uint32_t bk[4];
      const int key = jp * 16 + (lane >> 4) * 8 + (lane & 7);
      const int col = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(bk, smem_addr(&kt[key * LD + col]));
      mma_16816(s[2 * jp], qf[kk], bk);
      mma_16816(s[2 * jp + 1], qf[kk], bk + 2);
    }
  }
  if (n_keys < BKV) {
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j * 8 + 2 * t + (c & 1) >= n_keys) s[j][c] = -INFINITY;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int Tq, int Tkv, int C) {
  __shared__ __align__(16) bf16 smem[4 * TILE];
  bf16* k_buf = smem;             // two K tiles
  bf16* v_buf = smem + 2 * TILE;  // two V tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * DH;
  const size_t b = blockIdx.z;
  const bf16* qg = q + b * Tq * C + head;
  const bf16* kg = k + b * Tkv * C + head;
  const bf16* vg = v + b * Tkv * C + head;

  // the q tile, staged in the K buffers, into A fragments held all along
  load_rows<BQ>(smem, qg, q0, Tq, C, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(&smem[(warp * 16 + (lane & 15)) * LD + kk * 16 +
                                        (lane >> 4) * 8]));
  __syncthreads();

  const int n_tiles = (Tkv + BKV - 1) / BKV;
  float s[8][4];

  // pass 1: this thread's running max and sum of exp for rows g (r = 0)
  // and g + 8 (r = 1), over its two columns of every 8-key fragment
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  load_rows<BKV>(k_buf, kg, 0, Tkv, C, tid);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_rows<BKV>(k_buf + ((it + 1) & 1) * TILE, kg, (it + 1) * BKV, Tkv, C, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_scores(s, qf, k_buf + (it & 1) * TILE, lane, Tkv - it * BKV);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      if (mx != -INFINITY) {  // else every key this thread has seen is masked
        const float mx2 = mx * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += ex2(fmaf(s[j][2 * r], LOG2E, -mx2)) + ex2(fmaf(s[j][2 * r + 1], LOG2E, -mx2));
        l[r] = l[r] * ex2((m[r] - mx) * LOG2E) + sum;
        m[r] = mx;
      }
    }
    __syncthreads();  // the buffer is free before the next prefetch lands in it
  }
  // merge the four threads (t = 0..3) that share each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = m[r];
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    float lr = m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mr) * LOG2E);
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    m[r] = mr * LOG2E;  // from here on: the row max in log2 units
    l[r] = 1.f / lr;    // and the reciprocal of the row sum
  }

  // pass 2: p = 2^(s log2 e - max log2 e) / sum rounded to bf16, o += p v
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  load_rows<BKV>(k_buf, kg, 0, Tkv, C, tid);
  load_rows<BKV>(v_buf, vg, 0, Tkv, C, tid);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      load_rows<BKV>(k_buf + nb * TILE, kg, (it + 1) * BKV, Tkv, C, tid);
      load_rows<BKV>(v_buf + nb * TILE, vg, (it + 1) * BKV, Tkv, C, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_scores(s, qf, k_buf + (it & 1) * TILE, lane, Tkv - it * BKV);
    // the score fragments of key tiles 2kk, 2kk+1 are the A fragment of
    // key step kk: (g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float* sj = s[2 * kk + h2];
        pf[kk][2 * h2] = pack_bf16(ex2(fmaf(sj[0], LOG2E, -m[0])) * l[0],
                                   ex2(fmaf(sj[1], LOG2E, -m[0])) * l[0]);
        pf[kk][2 * h2 + 1] = pack_bf16(ex2(fmaf(sj[2], LOG2E, -m[1])) * l[1],
                                       ex2(fmaf(sj[3], LOG2E, -m[1])) * l[1]);
      }
    }
    const bf16* vt = v_buf + (it & 1) * TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // B fragments of dh tiles 2nj and 2nj+1 from V [key][dh], transposed
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(&vt[(kk * 16 + (lane & 15)) * LD + nj * 16 +
                                            (lane >> 4) * 8]));
        mma_16816(o[2 * nj], pf[kk], bv);
        mma_16816(o[2 * nj + 1], pf[kk], bv + 2);
      }
    }
    __syncthreads();
  }

  // epilogue: fragment (g, 2t..2t+1) and (g+8, 2t..2t+1) of each 16x8 tile
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + warp * 16 + g;
  bf16* og = out + b * Tq * C + head;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row < Tq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * C + col) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
    if (row + 8 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)(row + 8) * C + col) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

__global__ void __launch_bounds__(F32_BQ)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Tq, int Tkv, int C) {
  __shared__ __align__(16) float ks[F32_BKV * DH];
  __shared__ __align__(16) float vs[F32_BKV * DH];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * F32_BQ + tid;
  const size_t head = (size_t)blockIdx.y * DH;
  const size_t b = blockIdx.z;
  const float* kg = k + b * Tkv * C + head;
  const float* vg = v + b * Tkv * C + head;

  float qr[DH];
  {
    const float* qg = q + (b * Tq + (row < Tq ? row : 0)) * C + head;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qg + d);
      qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    }
  }
  // one K (and V) tile into shared memory; rows past Tkv zero-filled
  auto load = [&](float* dst, const float* src, int key0) {
    for (int i = tid; i < F32_BKV * DH / 4; i += F32_BQ) {
      const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
      const float4 x = key0 + r < Tkv
                           ? *reinterpret_cast<const float4*>(src + (size_t)(key0 + r) * C + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * DH + c) = x;
    }
  };
  float sc[F32_BKV];
  auto scores = [&](int key0) {
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qr[d], ks[j * DH + d], acc);
      sc[j] = key0 + j < Tkv ? acc : -INFINITY;
    }
  };

  float m = -INFINITY, l = 0.f;
  for (int key0 = 0; key0 < Tkv; key0 += F32_BKV) {
    load(ks, kg, key0);
    __syncthreads();
    scores(key0);
    float mx = m;
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) mx = fmaxf(mx, sc[j]);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) sum += expf(sc[j] - mx);
    l = l * expf(m - mx) + sum;  // the first tile always holds a key: mx is finite
    m = mx;
    __syncthreads();
  }
  float o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] = 0.f;
  for (int key0 = 0; key0 < Tkv; key0 += F32_BKV) {
    load(ks, kg, key0);
    load(vs, vg, key0);
    __syncthreads();
    scores(key0);
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      const float p = expf(sc[j] - m) / l;
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(p, vs[j * DH + d], o[d]);
    }
    __syncthreads();
  }
  if (row < Tq) {
    float* og = out + (b * Tq + row) * C + head;
#pragma unroll
    for (int d = 0; d < DH; d += 4)
      *reinterpret_cast<float4*>(og + d) = make_float4(o[d], o[d + 1], o[d + 2], o[d + 3]);
  }
}

}  // namespace

// q [B, Tq, H*64], k and v [B, Tkv, H*64], out [B, Tq, H*64]: contiguous,
// 16-byte aligned, all bf16 (is_bf16 = 1) or all fp32 (is_bf16 = 0);
// q pre-scaled.  B, H, Tq, Tkv >= 1.
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* out,
                                int B, int Tq, int Tkv, int H, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * DH;
  if (is_bf16) {
    dim3 grid((Tq + BQ - 1) / BQ, H, B);
    attention_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), Tq, Tkv, C);
  } else {
    dim3 grid((Tq + F32_BQ - 1) / F32_BQ, H, B);
    attention_f32_kernel<<<grid, F32_BQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Tq, Tkv, C);
  }
  return cudaGetLastError();
}
