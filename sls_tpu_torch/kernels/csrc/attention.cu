// Attention softmax(q k^T) v per head for Hopper (sm_90a): wgmma, TMA and
// mbarriers, one C entry behind four wrappers.
//
// Replaces three TPU kernels that compute the same function with other
// layouts and grids:
//   sls_tpu/kernels/flash_attention.py::flash_attention_long (lines 52-109;
//     kernel body _flash_kernel, 34-46), also under sp_flash_attention_long
//     (123-174): one 256-row q block against the whole K/V strip of its
//     (batch, head) held in VMEM;
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
// 989 TFLOP/s data-sheet peak); its 16*5120^2 = 419 M exponentials on the
// special-function units (about 3.9 T/s) take about as long again unless
// they overlap the products.  At the short-T flagship shape
// [36, 201, 16, 64] it is 5.96 GFLOP against 59 MB: bytes (0.018 ms).
//
// Design.  Every bf16 operand arrives by TMA (a 3-D map {C, T, B} per
// tensor, box {64, rows, 1}: a box that runs past T is zero-filled rather
// than reading the next batch's rows) into shared memory with the 128-byte
// swizzle, one 128-byte row per key or query, and both products run on
// wgmma: s = q k^T with both operands in shared memory (K-major), and
// o += p v with p in registers (the fp32 score fragment converts to the
// A fragment in place) and v in shared memory (MN-major, the transpose
// bit).  Each consumer warpgroup owns 64 query rows.  Two forms, chosen
// by Tkv:
//
//   short (Tkv <= 256; the T 201 flagship): the TPU kernel's own design,
//     which fits on chip here.  One TMA load brings the whole of a
//     (b, h)'s K and V, Tkv padded to a multiple of 16 (208 for 201); the
//     warpgroup computes its whole 64 x Tkv score strip into registers,
//     takes the exact row max and sum, forms p = exp(s - max) * (1/sum),
//     rounds it to bf16 and runs p . v.  One exponential a score, one read
//     of every operand, and the reference's rounding point exactly.
//   long (Tkv > 256): one pass over K and V with an online softmax.  A
//     producer warp keeps a ring of 128-key K and V tiles filled by TMA
//     (full / empty mbarriers per stage); consumers run s = q k^T, keep a
//     running max m and sum l in fp32, form p~ = exp(s - m) rounded to
//     bf16 for p~ . v, rescale o by exp(m_old - m_new), and divide o by l
//     at the end.  Each warpgroup issues tile j's q k^T together with
//     tile j-1's p v, so its exponentials of tile j overlap its own p v;
//     with two consumer warpgroups a block they take turns at issuing
//     (named barriers), so one's exponentials overlap the other's
//     products, and setmaxnreg gives the consumers the producer's
//     registers.  Rounding point: this rounds the unnormalised p~ rather
//     than p = p~ / l.  Both are one bf16 rounding of the same real value
//     times a row constant, so the relative error bound is the same 2^-9
//     an element; kernels/attention.py::attention_online_emulated repeats
//     these roundings on the CPU.  A row's result depends on its q row
//     and on K and V alone, in a fixed tile order: not on Tq or on the
//     block's q tile, so a sequence-parallel strip is bit-equal to its
//     rows of the whole-sequence output.  A block holds 128 query rows at
//     every shape: a 64-row block (one consumer warpgroup, two blocks an
//     SM) leaves 128 registers a thread to share out, too few for the
//     wgmma pipeline, and measured slower even on the 640- and 1280-row
//     strips, which fill the card worst.
//
// Keys past Tkv are -inf whatever TMA's zero fill put there; query rows
// past Tq are computed on zeros and not written.  The exponentials are
// ex2.approx of s*log2(e) less max*log2(e): within a few fp32 ulps of
// exp(s - max), far below the bf16 rounding of p that follows.
// fp32 operands (the reference's fp32 tests; no path) take a SIMT kernel:
// one query row a thread, K/V tiles broadcast from shared memory.
//
// The biased long form, attention_long_relpos_kernel (a symbol of its own,
// so that a device trace tells it apart), replaces no TPU kernel: the JAX
// package runs no WavLM.  It computes WavLM's gated relative-position
// attention (unilm wavlm/modules.py at eval), self-attention at T = Tq =
// Tkv with, for each (b, h, i, j),
//
//     s = q_h . k_h^T + g[b, h, i] * t[h, j - i + T - 1]
//
// added in fp32 (one fmaf) before the running max; gate g [B, H, T] and
// bias-by-distance table t [H, 2T - 1] are fp32.  A materialized bias
// would be 16 * 5120^2 * 4 B = 1.68 GB a layer at T 5120; the table is
// 655 KB.  A block's 128 query rows meet one 128-key tile at 255
// distances, so the producer warp copies the 256 entries from j*128 - q0 -
// 128 on (cp.async, 8 a lane) into the K stage beside the K tile: its
// barrier counts the copies' 32 arrivals beside the tile's bytes, and
// frees the slice with the tile.  A thread's row
// g + 8 meets at column group jj the entries its row g met at jj - 1, so
// it reads 34 entries a tile for its 64 scores.  The bias adds T^2 H
// multiply-adds (419 M at T 5120) on the CUDA cores beside the softmax's
// as many exponentials, and on the critical path of each tile's softmax:
// that made the kernel 1.39x row 6's time at T 5120 (PERF.md).  Beyond
// max_distance (the caller's `flat`) a side of the table holds one value
// (the side's last bucket), so a tile whose distances all lie beyond it on
// one side adds a constant g * that value to each row: the online softmax
// takes it in the row's max instead of in each score (exp(s + c - m) =
// exp(s - (m - c))), and the tile reads no entry and adds nothing (about
// 60 % of the tiles at T 5120).  The fp32 kernel takes the same bias
// directly from global memory.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int DH = 64;                      // head dim the kernels take
constexpr int ROW_BYTES = DH * 2;           // one bf16 row: one 128-byte swizzle row
constexpr int QT = 64;                      // query rows per consumer warpgroup
constexpr int KT = 128;                     // keys per ring tile (long form)
constexpr int SHORT_KV = 256;               // Tkv at or below: the short form
constexpr int Q_BYTES = QT * ROW_BYTES;     // 8 KB
constexpr int KV_BYTES = KT * ROW_BYTES;    // 16 KB
constexpr float LOG2E = 1.4426950408889634f;

constexpr int TAB_N = 256;                  // table entries a tile's slice (biased form)
constexpr int TAB_BYTES = TAB_N * 4;
constexpr int F32_BQ = 64;           // fp32: query rows per block, one a thread
constexpr int F32_BKV = 32;          // fp32: keys per shared-memory tile

// B MN-major (v as [key][dh]): k-step kk of 16 keys starts 16 rows further;
// the 64 dh columns are one 128-byte row, 8-key groups 1024 bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + 16 * ROW_BYTES * kk, 1024, 1024);
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two bf16 values packed low-first, as a 32-bit word
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator fragment of m64nN: thread (warp w, lane g*4 + t) holds,
// for each 8-column group j, rows 16w + g (d[4j], d[4j+1]) and 16w + g + 8
// (d[4j+2], d[4j+3]) at columns 8j + 2t, 8j + 2t + 1.  The A fragment of
// a 16-deep k-step kk is the same thread's d[8kk..8kk+7], packed in pairs.

// -- wgmma -------------------------------------------------------------------

// d[0..64) += A (smem, K-major) . B (smem, K-major), m64n128k16 bf16 -> fp32
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
          "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
          "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
          "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..8) += A (smem, K-major) . B (smem, K-major), m64n16k16 bf16 -> fp32
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..32) += A (registers) . B (smem, MN-major: the transpose bit), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
          "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34,"
          "%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o = fragment rows (16w + g, 16w + g + 8) scaled and written to out
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float* o,
                                           const float* scale, int row, int Tq, size_t col0,
                                           int C, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= Tq) continue;
    bf16* dst = out + (size_t)(row + 8 * r) * C + col0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / scale[r], o[4 * j + 2 * r + 1] / scale[r]);
  }
}

// -- short form: Tkv <= 256, the whole strip in registers -------------------

__global__ void __launch_bounds__(128, 2)
attention_short_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                       int Tq, int Tkv, int C, int npad) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];  // q and k; v
  uint8_t* sq = align_smem(smem_raw);
  uint8_t* sk = sq + Q_BYTES;
  uint8_t* sv = sk + npad * ROW_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * QT;
  const int nch = npad / 16;  // 16-key chunks of the strip
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], Q_BYTES + npad * ROW_BYTES);
    tma_load_3d(sq, &tm_q, &bars[0], h * DH, q0, b);
    tma_load_3d(sk, &tm_k, &bars[0], h * DH, 0, b);
    mbar_expect_tx(&bars[1], npad * ROW_BYTES);
    tma_load_3d(sv, &tm_v, &bars[1], h * DH, 0, b);
  }

  // s = q k^T: 16 keys a wgmma (measured faster here than 64 a wgmma for
  // the whole 64-key blocks), chunk c into s[8c..8c+7]
  float s[8 * SHORT_KV / 16];
  const uint32_t q_addr = smem_u32(sq), k_addr = smem_u32(sk), v_addr = smem_u32(sv);
  mbar_wait(&bars[0], 0);
  wg_fence();
#pragma unroll
  for (int c = 0; c < SHORT_KV / 16; ++c) {
    if (c < nch) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n16(s + 8 * c, kmajor_desc(q_addr, kk),
                     kmajor_desc(k_addr + c * 16 * ROW_BYTES, kk), kk > 0);
    }
  }
  wg_commit();
  wg_wait<0>();
  pin<8 * SHORT_KV / 16>(s);

  // exact softmax over the row: keys past Tkv are -inf; e = 2^(s log2e -
  // max log2e) in place, then p = e * (1 / sum) rounded to bf16
  // (partial maxima and sums two a row, for independent chains)
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < SHORT_KV / 16; ++c) {
    if (c < nch) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 16 * c + 8 * (i >> 2) + 2 * tq + (i & 1);
        if (col >= Tkv) s[8 * c + i] = -INFINITY;
        mx[(i >> 1) & 3] = fmaxf(mx[(i >> 1) & 3], s[8 * c + i]);
      }
    }
  }
  mx[0] = quad_max(fmaxf(mx[0], mx[2])) * LOG2E;  // row g
  mx[1] = quad_max(fmaxf(mx[1], mx[3])) * LOG2E;  // row g + 8
#pragma unroll
  for (int c = 0; c < SHORT_KV / 16; ++c) {
    if (c < nch) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[8 * c + i] = ex2(fmaf(s[8 * c + i], LOG2E, -mx[(i >> 1) & 1]));
        sum[(i >> 1) & 3] += s[8 * c + i];
      }
    }
  }
  const float inv[2] = {1.f / quad_sum(sum[0] + sum[2]), 1.f / quad_sum(sum[1] + sum[3])};
  uint32_t p[4 * SHORT_KV / 16];
#pragma unroll
  for (int c = 0; c < SHORT_KV / 16; ++c) {
    if (c < nch) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[4 * c + i] = pack_bf16(s[8 * c + 2 * i] * inv[i & 1], s[8 * c + 2 * i + 1] * inv[i & 1]);
    }
  }

  // o = p v: 16 keys a k-step
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  mbar_wait(&bars[1], 0);
  wg_fence();
#pragma unroll
  for (int c = 0; c < SHORT_KV / 16; ++c)
    if (c < nch) wgmma_rs_n64_tb(o, p + 4 * c, mnmajor_desc(v_addr, c));
  wg_commit();
  wg_wait<0>();
  pin<32>(o);
  const float one[2] = {1.f, 1.f};
  store_rows(out + (size_t)b * Tq * C, o, one, q0 + warp * 16 + g, Tq, (size_t)h * DH, C, tq);
}

// -- long form: Tkv > 256, one pass over a ring of K and V tiles -------------

// 4 bytes of global memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have
// landed (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// s += g_r * t[j - i] over one tile from its staged slice: this thread's
// row g at column 8jj + 2tq + e reads tab[base + 8jj + e], row g + 8 the
// entry 8 lower, which row g read at jj - 1
__device__ __forceinline__ void add_relpos(float* s, const float* tab, int base, float g0,
                                           float g1) {
  float prev0 = tab[base - 8], prev1 = tab[base - 7];
#pragma unroll
  for (int jj = 0; jj < KT / 8; ++jj) {
    const float t0 = tab[base + 8 * jj], t1 = tab[base + 8 * jj + 1];
    s[4 * jj] = fmaf(g0, t0, s[4 * jj]);
    s[4 * jj + 1] = fmaf(g0, t1, s[4 * jj + 1]);
    s[4 * jj + 2] = fmaf(g1, prev0, s[4 * jj + 2]);
    s[4 * jj + 3] = fmaf(g1, prev1, s[4 * jj + 3]);
    prev0 = t0;
    prev1 = t1;
  }
}


// s = q k^T against one 128-key tile (four 16-deep k-steps): one commit group
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n128(s, kmajor_desc(q_tile, kk), kmajor_desc(k_tile, kk), kk > 0);
  wg_commit();
}

// o += p~ v over one 128-key tile: one commit group
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p, uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs_n64_tb(o, p + 4 * kk, mnmajor_desc(v_tile, kk));
  wg_commit();
}

// keys at or past n_valid of the tile to -inf; then per row (r = 0: g,
// r = 1: g + 8) the new max m, alpha = 2^((m_old - m) log2e), p~ =
// 2^(s log2e - m log2e) in place in fp32, and l = l alpha + this thread's
// share of the row's sum of p~.  With OFFSET the scores are s + c[r]
// (a row's constant over the tile) without adding it to each: the max of
// s is taken against m_old - c[r], and m = that max + c[r]
template <bool OFFSET>
__device__ __forceinline__ void online_softmax(float* s, float* m, float* l, float* alpha,
                                               int n_valid, int tq, const float* c) {
  if (n_valid < KT) {
#pragma unroll
    for (int i = 0; i < 2 * KT / 4; ++i)
      if (8 * (i >> 2) + 2 * tq + (i & 1) >= n_valid) s[i] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // four partial maxima and sums, for independent chains
    float mp[4] = {OFFSET ? m[r] - c[r] : m[r], -INFINITY, -INFINITY, -INFINITY};
    float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < KT / 8; ++jj)
      mp[jj & 3] = fmaxf(mp[jj & 3], fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
    const float mx = quad_max(fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3])));
    const float m_new = OFFSET ? mx + c[r] : mx;
    alpha[r] = ex2((m[r] - m_new) * LOG2E);
    m[r] = m_new;
    const float mb = -mx * LOG2E;
#pragma unroll
    for (int jj = 0; jj < KT / 8; ++jj) {
      s[4 * jj + 2 * r] = ex2(fmaf(s[4 * jj + 2 * r], LOG2E, mb));
      s[4 * jj + 2 * r + 1] = ex2(fmaf(s[4 * jj + 2 * r + 1], LOG2E, mb));
      sp[jj & 3] += s[4 * jj + 2 * r] + s[4 * jj + 2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + ((sp[0] + sp[1]) + (sp[2] + sp[3]));
  }
}

__device__ __forceinline__ void rescale(float* o, const float* alpha) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// p~ rounded to bf16, as the A fragments of the tile's eight k-steps
__device__ __forceinline__ void pack_tile(uint32_t* p, const float* s) {
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

constexpr int NCONS = 2;  // consumer warpgroups a block: 128 query rows
constexpr int BQ = NCONS * QT;

// whether the distances of a tile whose first key lies d0 from the
// block's first row (d0 - (BQ - 1) .. d0 + KT - 1) all lie beyond `flat`
// on one side
__device__ __forceinline__ bool far_tile(int d0, int flat) {
  return d0 - (BQ - 1) >= flat || d0 + KT - 1 <= -flat;
}

// the bias of such a tile: for a far tile each row's g times that side's
// far value as the row's offset c (online_softmax's OFFSET); else added to
// each score from the slice `tab`, c = 0
__device__ __forceinline__ void add_bias(float* s, float* c, const float* tab, int d0, int flat,
                                         int base, const float* gq, float far_neg,
                                         float far_pos) {
  if (far_tile(d0, flat)) {
    const float far = d0 > 0 ? far_pos : far_neg;
    c[0] = gq[0] * far;
    c[1] = gq[1] * far;
  } else {
    c[0] = c[1] = 0.f;
    add_relpos(s, tab, base, gq[0], gq[1]);
  }
}

constexpr int ST = 2;     // ring stages of K and of V
constexpr int LONG_SMEM = SWIZZLE_ALIGN + NCONS * Q_BYTES + 2 * ST * KV_BYTES;
constexpr int RELPOS_SMEM = LONG_SMEM + ST * TAB_BYTES;

// the biased form's inputs (unused by the plain form)
struct RelPos {
  const float* gate;   // [B, H, T]
  const float* table;  // [H, 2T - 1]
  int flat;            // from this distance on, each side of the table holds one value
};

// The long form's block: NCONS consumer warpgroups of QT query rows each,
// after one producer warpgroup (warp 0 of it issues every TMA load); one
// block an SM, launched at 168 registers a thread: the producer drops to
// 24 and the consumers take 240.  RELPOS adds the bias; the plain form
// compiles without it.
template <bool RELPOS>
__device__ __forceinline__ void long_form(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v, bf16* __restrict__ out,
                                          int Tq, int Tkv, int C, RelPos rp) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * ST];
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + ST;
  uint64_t* k_empty = bars + 1 + 2 * ST;
  uint64_t* v_empty = bars + 1 + 3 * ST;
  uint8_t* sq = align_smem(smem_raw);
  uint8_t* sk = sq + NCONS * Q_BYTES;
  uint8_t* sv = sk + ST * KV_BYTES;
  float* stab = reinterpret_cast<float*>(sv + ST * KV_BYTES);  // RELPOS: ST slices

  const int tid = threadIdx.x, wg = tid >> 7;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int n_tiles = (Tkv + KT - 1) / KT;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&k_full[i], RELPOS ? 1 + 32 : 1);  // RELPOS: the slice's copies too
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], 4 * NCONS);  // lane 0 of every consumer warp
      mbar_init(&v_empty[i], 4 * NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: thread 0 issues every TMA load; under RELPOS its warp also
    // copies each tile's slice of the table
    regs_dec<24>();
    if (RELPOS ? tid < 32 : tid == 0) {
      if (tid == 0) {
        mbar_expect_tx(q_full, NCONS * Q_BYTES);
        for (int c = 0; c < NCONS; ++c)
          tma_load_3d(sq + c * Q_BYTES, tm_q, q_full, h * DH, q0 + c * QT, b);
      }
      const int last = (int)gridDim.y * (2 * Tkv - 1) - 1;  // RELPOS: the table's last entry
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        const uint32_t ph = (j / ST) & 1;
        mbar_wait(&k_empty[st], ph ^ 1);
        if (tid == 0) {
          mbar_expect_tx(&k_full[st], KV_BYTES);
          tma_load_3d(sk + st * KV_BYTES, tm_k, &k_full[st], h * DH, j * KT, b);
        }
        if (RELPOS) {
          // distances j*KT - q0 - BQ + i of head h, i < TAB_N (an index
          // past the table, which no score of the tile reads, clamped);
          // none for a tile that add_bias reads no entry of
          const int d0 = j * KT - q0, first = h * (2 * Tkv - 1) + d0 - BQ + Tkv - 1;
          if (!far_tile(d0, rp.flat))
            for (int i = tid; i < TAB_N; i += 32)
              cp_async_4(stab + st * TAB_N + i, rp.table + min(max(first + i, 0), last));
          cp_async_arrive(&k_full[st]);
        }
        if (tid == 0) {
          mbar_wait(&v_empty[st], ph ^ 1);
          mbar_expect_tx(&v_full[st], KV_BYTES);
          tma_load_3d(sv + st * KV_BYTES, tm_v, &v_full[st], h * DH, j * KT, b);
        }
      }
    }
  } else {
    // consumers
    regs_inc<240>();
    const int cw = wg - 1;
    const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
    const uint32_t q_addr = smem_u32(sq + cw * Q_BYTES);
    const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);
    float s[2 * KT / 4];   // scores of this warpgroup's 64 rows against one tile
    uint32_t p[KT / 4];    // the previous tile's p~ as bf16 A fragments
    float o[32];           // 64 rows x 64 dh
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // RELPOS: this thread's rows' gates, the table's two far values, and
    // its place in a tile's slice (row g, column 2tq)
    float gq[2] = {0.f, 0.f}, far_neg = 0.f, far_pos = 0.f, c[2] = {0.f, 0.f};
    int base = 0;
    if (RELPOS) {
      const int row = q0 + cw * QT + warp * 16 + g;
      const float* gr = rp.gate + ((size_t)b * gridDim.y + h) * Tq;
      gq[0] = row < Tq ? gr[row] : 0.f;
      gq[1] = row + 8 < Tq ? gr[row + 8] : 0.f;
      const float* tr = rp.table + (size_t)h * (2 * Tkv - 1);
      far_neg = tr[0];
      far_pos = tr[2 * Tkv - 2];
      base = BQ - cw * QT - warp * 16 - g + 2 * tq;
    }
    if (cw == 1) bar_arrive(1, 256);  // warpgroup 0 issues first
    mbar_wait(q_full, 0);

    // Tile j's q k^T is issued together with tile j-1's p v, so that the
    // exponentials of tile j run while p v of tile j-1 is on the tensor
    // cores; the two warpgroups take turns at issuing (named barriers 1
    // and 2), so that one's exponentials run under the other's products.
    // The loop is peeled (tile 0; tiles 1 .. n-1; the last p v) so that
    // every wait in it completes a known commit group.
    auto turn = [&]() { bar_sync(1 + cw, 256); };
    auto next_turn = [&](bool last) {  // the second warpgroup's last turn frees no one
      if (!last || cw == 0) bar_arrive(2 - cw, 256);
    };
    turn();
    mbar_wait(&k_full[0], 0);
    wg_fence();
    issue_qk(s, q_addr, k_addr);
    next_turn(false);
    wg_wait<0>();
    pin<2 * KT / 4>(s);
    if (RELPOS) add_bias(s, c, stab, -q0, rp.flat, base, gq, far_neg, far_pos);
    if (lane == 0) mbar_arrive(&k_empty[0]);
    online_softmax<RELPOS>(s, m, l, alpha, Tkv, tq, c);
    pack_tile(p, s);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % ST, sp = (j - 1) % ST;
      turn();
      rescale(o, alpha);  // o: tiles < j-1 against tile j-2's max, now tile j-1's
      mbar_wait(&k_full[st], (j / ST) & 1);
      wg_fence();
      issue_qk(s, q_addr, k_addr + st * KV_BYTES);
      mbar_wait(&v_full[sp], ((j - 1) / ST) & 1);
      issue_pv(o, p, v_addr + sp * KV_BYTES);
      next_turn(false);
      wg_wait<1>();
      pin<2 * KT / 4>(s);
      if (RELPOS)
        add_bias(s, c, stab + st * TAB_N, j * KT - q0, rp.flat, base, gq, far_neg, far_pos);
      if (lane == 0) mbar_arrive(&k_empty[st]);
      online_softmax<RELPOS>(s, m, l, alpha, Tkv - j * KT, tq, c);
      wg_wait<0>();
      pin<32>(o);
      pin<KT / 4>(p);
      if (lane == 0) mbar_arrive(&v_empty[sp]);
      pack_tile(p, s);
    }
    const int sl = (n_tiles - 1) % ST;
    turn();
    rescale(o, alpha);
    mbar_wait(&v_full[sl], ((n_tiles - 1) / ST) & 1);
    wg_fence();
    issue_pv(o, p, v_addr + sl * KV_BYTES);
    next_turn(true);
    wg_wait<0>();
    pin<32>(o);
    const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
    store_rows(out + (size_t)b * Tq * C, o, lsum, q0 + cw * QT + warp * 16 + g, Tq,
               (size_t)h * DH, C, tq);
  }
}

__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
attention_long_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                      int Tq, int Tkv, int C) {
  long_form<false>(&tm_q, &tm_k, &tm_v, out, Tq, Tkv, C, RelPos{nullptr, nullptr, 0});
}

__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
attention_long_relpos_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                             int T, int C, const float* __restrict__ gate,
                             const float* __restrict__ table, int flat) {
  long_form<true>(&tm_q, &tm_k, &tm_v, out, T, T, C, RelPos{gate, table, flat});
}

// -- fp32 ----------------------------------------------------------------------

__global__ void __launch_bounds__(F32_BQ)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Tq, int Tkv, int C, const float* __restrict__ gate,
                     const float* __restrict__ table) {
  __shared__ __align__(16) float ks[F32_BKV * DH];
  __shared__ __align__(16) float vs[F32_BKV * DH];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * F32_BQ + tid;
  const size_t head = (size_t)blockIdx.y * DH;
  const size_t b = blockIdx.z;
  const float* kg = k + b * Tkv * C + head;
  const float* vg = v + b * Tkv * C + head;
  // the bias (gate non-null; Tq = Tkv): g of this row, and tr[key] = t[key - row]
  const int brow = row < Tq ? row : 0;
  const float gr = gate != nullptr ? gate[(b * gridDim.y + blockIdx.y) * Tq + brow] : 0.f;
  const float* tr = gate != nullptr
                        ? table + (size_t)blockIdx.y * (2 * Tkv - 1) + (Tkv - 1 - brow)
                        : nullptr;

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
      if (tr != nullptr && key0 + j < Tkv) acc = fmaf(gr, tr[key0 + j], acc);
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

// a bf16 [B, T, C] tensor as the 3-D map {C, T, B}, box {64, rows, 1},
// 128-byte swizzle; boxes past T or B read zeros
int make_qkv_map(CUtensorMap* map, const void* ptr, int B, int T, int C, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)DH, (cuuint32_t)rows, 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box);
}

int relpos_launch(const void* q, const void* k, const void* v, const float* gate,
                  const float* table, void* out, int B, int T, int H, int flat,
                  cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  const int C = H * DH;
  CUtensorMap tq, tk, tv;
  int res = make_qkv_map(&tq, q, B, T, C, QT);
  if (res == 0) res = make_qkv_map(&tk, k, B, T, C, KT);
  if (res == 0) res = make_qkv_map(&tv, v, B, T, C, KT);
  if (res != 0) return res;
  const cudaError_t err = allow_smem(attention_long_relpos_kernel, RELPOS_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_long_relpos_kernel<<<grid, 128 * (NCONS + 1), RELPOS_SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), T, C, gate, table, flat);
  return cudaGetLastError();
}

int bf16_launch(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tkv,
                int H, cudaStream_t stream) {
  static bool smem_set[2][MAX_DEVICES] = {};
  const int C = H * DH;
  const bool short_form = Tkv <= SHORT_KV;
  const int npad = (Tkv + 15) / 16 * 16;
  CUtensorMap tq, tk, tv;
  int res = make_qkv_map(&tq, q, B, Tq, C, QT);
  if (res == 0) res = make_qkv_map(&tk, k, B, Tkv, C, short_form ? npad : KT);
  if (res == 0) res = make_qkv_map(&tv, v, B, Tkv, C, short_form ? npad : KT);
  if (res != 0) return res;
  cudaError_t err;
  bf16* o = static_cast<bf16*>(out);
  if (short_form) {
    const int smem = SWIZZLE_ALIGN + Q_BYTES + 2 * npad * ROW_BYTES;
    err = allow_smem(attention_short_kernel, SWIZZLE_ALIGN + Q_BYTES + 2 * SHORT_KV * ROW_BYTES,
                     smem_set[0]);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + QT - 1) / QT, H, B);
    attention_short_kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, o, Tq, Tkv, C, npad);
  } else {
    err = allow_smem(attention_long_kernel, LONG_SMEM, smem_set[1]);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + NCONS * QT - 1) / (NCONS * QT), H, B);
    attention_long_kernel<<<grid, 128 * (NCONS + 1), LONG_SMEM, stream>>>(tq, tk, tv, o, Tq, Tkv,
                                                                          C);
  }
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H*64], k and v [B, Tkv, H*64], out [B, Tq, H*64]: contiguous,
// 16-byte aligned, all bf16 (is_bf16 = 1) or all fp32 (is_bf16 = 0);
// q pre-scaled.  B, H, Tq, Tkv >= 1.  Returns a cudaError_t, or 10000
// plus the CUresult when a tensor map cannot be made.
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* out,
                                int B, int Tq, int Tkv, int H, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return bf16_launch(q, k, v, out, B, Tq, Tkv, H, s);
  const int C = H * DH;
  dim3 grid((Tq + F32_BQ - 1) / F32_BQ, H, B);
  attention_f32_kernel<<<grid, F32_BQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tq, Tkv, C, nullptr, nullptr);
  return cudaGetLastError();
}

// The biased form: q, k, v and out [B, T, H*64] as above, gate [B, H, T]
// and table [H, 2T - 1] float32, contiguous and 16-byte aligned; from
// distance `flat` on, each side of the table holds one value (a larger
// `flat` than T - 1 promises nothing).  bf16 takes
// attention_long_relpos_kernel at every T, fp32 the SIMT kernel.  Returns
// as attention_launch.
extern "C" int attention_relpos_launch(const void* q, const void* k, const void* v,
                                       const void* gate, const void* table, void* out, int B,
                                       int T, int H, int flat, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gate);
  const float* t = static_cast<const float*>(table);
  if (is_bf16) return relpos_launch(q, k, v, g, t, out, B, T, H, flat, s);
  const int C = H * DH;
  dim3 grid((T + F32_BQ - 1) / F32_BQ, H, B);
  attention_f32_kernel<<<grid, F32_BQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), T, T, C, g, t);
  return cudaGetLastError();
}
