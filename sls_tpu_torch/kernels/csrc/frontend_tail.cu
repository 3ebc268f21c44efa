// The XLS-R conv front-end tail for Hopper (sm_90a): LN0 + GELU0, then
// conv layers 1..L-1, each a VALID strided conv with fp32 sums, fp32 bias,
// fp32 LayerNorm and fp32 GELU, rounded to the compute dtype per level.
//
// Replaces sls_tpu/kernels/frontend.py::frontend_tail_fused (lines
// 184-283; kernel body _make_kernel, 110-174), which walks ~4 MB time
// tiles with halos through VMEM, keeps all six tail layers' weights
// resident there (8.4 MB in bf16) and phase-decomposes the strided convs
// because Mosaic has no strided loads.  Per tail layer (k, s) and output
// frame t it computes, over C = 512 channels:
//
//     acc[t, :] = sum_{j<k} h[s t + j, :] . W[j]      (fp32 sums)
//     h'[t, :]  = dtype(gelu(LN(acc[t, :] + bias)))    (fp32 LN, GELU)
//
// What bounds it on the H100: at the flagship (batch 36, N0 12,919 frames)
// the six layers are 708 GFLOP of bf16 products against 476 MB of h0,
// 8.4 MB of weights and 7.4 MB of output, so the operations bound it
// (0.716 ms at 989 TFLOP/s; the bytes 0.147 ms).
//
// Design.  The TPU kernel's resident weights cannot be repeated: a Hopper
// block has 227 KB of shared memory.  So each layer is one launch of an
// implicit GEMM.  In the NWC layout output frame t reads input rows
// s t .. s t + k - 1, one contiguous span of k C values, so the layer is
// A . W with A [B N_out, k C] read in place (row (b, t) starts at
// h + (b N_in + s t) C; rows overlap, no im2col copy; tiles straddle
// utterances) and W the [k C, C] WIO weight.  Each block owns 64 output
// rows of all 512 channels (8 warps, each 64 rows x 64 channels of
// mma.sync m16n8k16 bf16 with 128 fp32 accumulators a thread), so the
// epilogue holds whole rows: bias, the fast-variance LayerNorm (row sums
// and sums of squares over the quads by shuffles and over the warps
// through shared memory, var = max(E[x^2] - E[x]^2, 0), rsqrt(var + eps)),
// GELU (see gelu() below), the bf16 rounding, and 16-byte stores staged
// through shared memory.  A and W stream through shared memory in K
// chunks of 64 with a three-stage cp.async pipeline (226 KB: one block
// an SM).  The TPU kernel also rounds every level to the compute dtype,
// so writing each level to device memory changes nothing in the
// function; it costs the levels' round trips (~0.94 GB at the flagship)
// and each block rereads W from L2.  LN0 + GELU0 is its own row-wise
// pass, which also reads conv 0's channels-first output through its
// strides and writes NWC.  fp32 operands (the reference's fp32 tests)
// take a SIMT kernel.  wgmma, TMA multicast of W across a cluster and a
// fused LN0 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 512;             // channels (XLS-R's conv width)
constexpr int THREADS = 256;       // 8 warps
constexpr int BM = 64;             // output rows per block (bf16)
constexpr int BK = 64;             // K chunk through shared memory
constexpr int STAGES = 3;          // cp.async pipeline depth
constexpr int LDA = BK + 8;        // padded rows: conflict-free ldmatrix
constexpr int LDB = C + 8;
constexpr int LDO = C + 8;         // output staging rows
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 16-byte A copies a thread per stage
static_assert(A_CHUNKS * 8 * THREADS == BM * BK, "the A tile splits evenly over the threads");
constexpr int A_TILE = BM * LDA;   // elements
constexpr int B_TILE = BK * LDB;
constexpr int STAGE = A_TILE + B_TILE;
constexpr int PIPE_BYTES = STAGES * STAGE * 2;
constexpr int RED_BYTES = 2 * 8 * BM * 4;  // row sums and sums of squares per warp
constexpr int CONV_SMEM = PIPE_BYTES + RED_BYTES;
static_assert(BM * LDO * 2 <= PIPE_BYTES, "the output tile is staged in the pipeline buffers");
static_assert(CONV_SMEM <= 232448, "a block's shared memory on sm_90 (227 KB)");

constexpr int LN_FRAMES = 32;      // LN0 pass: frames per block
constexpr int LN_SMEM = LN_FRAMES * (C + 1) * 4;

constexpr int F32_BM = 8;          // fp32 SIMT conv: rows per block
constexpr int F32_BK = 16;

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

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// GELU in fp32: the tanh form (approx) or the erf form.  The tanh form
// 0.5 x (1 + tanh u) is computed as x / (1 + exp(-2u)), the same value
// without the cancellation of 1 + tanh u at negative u; __expf and
// __fdividef keep it within a few fp32 ulps, far below the bf16 rounding
// that follows, at a fraction of tanhf's cost (the epilogue runs while
// the tensor cores idle: one block an SM).  Not tanh.approx (~2^-11).
__device__ __forceinline__ float gelu(float x, int approx) {
  if (approx) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return __fdividef(x, 1.f + __expf(-2.f * inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LN0 + GELU0: h0 [B, N0, C] at any strides -> out [B, N0, C] contiguous.
// A block loads LN_FRAMES frames x C channels into shared memory (fp32),
// coalesced along whichever of frames and channels is unit-stride, then
// each warp normalises 4 frames.
template <typename T>
__global__ void __launch_bounds__(THREADS)
frontend_ln0_kernel(const T* __restrict__ h0, T* __restrict__ out, int N0, long long sb,
                    long long sn, long long sc, const float* __restrict__ scale,
                    const float* __restrict__ shift, float eps, int approx) {
  extern __shared__ float tile[];  // [LN_FRAMES][C + 1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * LN_FRAMES;
  const size_t b = blockIdx.y;
  const T* src = h0 + b * sb;
  const bool frames_fast = sn == 1;
  for (int i = tid; i < LN_FRAMES * C; i += THREADS) {
    int n, c;
    if (frames_fast) {
      n = i % LN_FRAMES; c = i / LN_FRAMES;
    } else {
      c = i % C; n = i / C;
    }
    const float v = n0 + n < N0 ? to_f32(src[(long long)(n0 + n) * sn + (long long)c * sc]) : 0.f;
    tile[n * (C + 1) + c] = v;
  }
  __syncthreads();
  for (int f = 0; f < LN_FRAMES / 8; ++f) {
    const int n = warp * (LN_FRAMES / 8) + f;
    if (n0 + n >= N0) break;
    const float* row = tile + n * (C + 1);
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const float x = row[lane + 32 * j];
      s += x;
      q += x * x;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    const float mean = s / C;
    const float var = fmaxf(q / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    T* dst = out + (b * N0 + n0 + n) * C;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      dst[c] = from_f32<T>(gelu((row[c] - mean) * rstd * scale[c] + shift[c], approx));
    }
  }
}

// One tail layer, bf16: h [B, n_in, C] -> out [B, n_out, C], both
// contiguous; w [k C, C]; M = B n_out rows.
__global__ void __launch_bounds__(THREADS, 1)
frontend_conv_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                          const float* __restrict__ bias, const float* __restrict__ scale,
                          const float* __restrict__ shift, bf16* __restrict__ out, int M,
                          int n_in, int n_out, int k, int s, float eps, int approx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* red_s = reinterpret_cast<float*>(smem_raw + PIPE_BYTES);  // [8][BM]
  float* red_q = red_s + 8 * BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const int K = k * C;
  const int n_chunks = K / BK;

  // this thread's 16-byte chunks of the A tile, A_CHUNKS rows a stage
  const bf16* a_src[A_CHUNKS];
  int a_off[A_CHUNKS];
  bool a_valid[A_CHUNKS];
#pragma unroll
  for (int j = 0; j < A_CHUNKS; ++j) {
    const int i = tid + j * THREADS;
    const int row = i / (BK / 8), col = (i % (BK / 8)) * 8;
    const int r = row0 + row;
    a_valid[j] = r < M;
    a_off[j] = row * LDA + col;
    a_src[j] = h + col;
    if (a_valid[j]) {
      const int b = r / n_out, t = r - b * n_out;
      a_src[j] += ((size_t)b * n_in + (size_t)s * t) * C;
    }
  }

  auto load_stage = [&](int buf, int chunk) {
    bf16* sa = smem + buf * STAGE;
    bf16* sw = sa + A_TILE;
    const int k0 = chunk * BK;
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j)
      cp_async16(sa + a_off[j], a_src[j] + (a_valid[j] ? k0 : 0), a_valid[j]);
#pragma unroll
    for (int j = 0; j < BK * C / 8 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i >> 6, c = (i & 63) * 8;
      cp_async16(sw + r * LDB + c, w + (size_t)(k0 + r) * C + c, true);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks) load_stage(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk kc has landed; buffer (kc - 1) % STAGES is free
    const int next = kc + STAGES - 1;
    if (next < n_chunks) load_stage(next % STAGES, next);
    cp_async_commit();
    const bf16* sa = smem + (kc % STAGES) * STAGE;
    const bf16* sw = sa + A_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], smem_addr(&sa[(mt * 16 + (lane & 15)) * LDA + kk * 16 +
                                          (lane >> 4) * 8]));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // B fragments of n-tiles 2np and 2np+1 from W [k][n], transposed
        uint32_t bw[4];
        ldmatrix_x4_trans(bw, smem_addr(&sw[(kk * 16 + (lane & 15)) * LDB + warp * 64 +
                                            np * 16 + (lane >> 4) * 8]));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_16816(acc[mt][2 * np], af[mt], bw);
          mma_16816(acc[mt][2 * np + 1], af[mt], bw + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment (g, 2t..2t+1) and (g+8, 2t..2t+1) of each 16x8
  // tile; this thread's rows are mt*16 + hh*8 + g, its columns
  // warp*64 + nt*8 + 2t (+1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = warp * 64 + nt * 8 + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      acc[mt][nt][0] += b0; acc[mt][nt][1] += b1;
      acc[mt][nt][2] += b0; acc[mt][nt][3] += b1;
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float x0 = acc[mt][nt][2 * hh], x1 = acc[mt][nt][2 * hh + 1];
        sum += x0 + x1;
        sq += x0 * x0 + x1 * x1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if (t == 0) {
        red_s[warp * BM + mt * 16 + hh * 8 + g] = sum;
        red_q[warp * BM + mt * 16 + hh * 8 + g] = sq;
      }
    }
  }
  __syncthreads();  // also: every warp is done with the pipeline buffers

  float2 scv[8], shv[8];  // this thread's columns of the affine
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = warp * 64 + nt * 8 + 2 * t;
    scv[nt] = make_float2(scale[col], scale[col + 1]);
    shv[nt] = make_float2(shift[col], shift[col + 1]);
  }
  bf16* so = smem;  // [BM][LDO] staged output
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mt * 16 + hh * 8 + g;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int wi = 0; wi < 8; ++wi) {
        sum += red_s[wi * BM + r];
        sq += red_q[wi * BM + r];
      }
      const float mean = sum / C;
      const float var = fmaxf(sq / C - mean * mean, 0.f);
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = warp * 64 + nt * 8 + 2 * t;
        const float y0 = gelu((acc[mt][nt][2 * hh] - mean) * rstd * scv[nt].x + shv[nt].x,
                              approx);
        const float y1 = gelu((acc[mt][nt][2 * hh + 1] - mean) * rstd * scv[nt].y + shv[nt].y,
                              approx);
        *reinterpret_cast<__nv_bfloat162*>(so + r * LDO + col) = __floats2bfloat162_rn(y0, y1);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BM * C / 8 / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i >> 6, c = (i & 63) * 8;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(so + r * LDO + c);
  }
}

// One tail layer, fp32 (SIMT): F32_BM rows a block, each thread two
// channels (tid, tid + 256) of every row.
__global__ void __launch_bounds__(THREADS)
frontend_conv_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                         const float* __restrict__ bias, const float* __restrict__ scale,
                         const float* __restrict__ shift, float* __restrict__ out, int M,
                         int n_in, int n_out, int k, int s, float eps, int approx) {
  __shared__ float sa[F32_BM][F32_BK];
  __shared__ float sw[F32_BK][C];
  __shared__ float red[2][8][F32_BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * F32_BM;
  const int K = k * C;

  // loader of A: threads 0..127, one element of one row a chunk
  const int a_row = tid / F32_BK, a_k = tid % F32_BK;
  const bool a_valid = tid < F32_BM * F32_BK && row0 + a_row < M;
  const float* a_src = h;
  if (a_valid) {
    const int r = row0 + a_row;
    const int b = r / n_out, t = r - b * n_out;
    a_src = h + ((size_t)b * n_in + (size_t)s * t) * C;
  }

  float acc[F32_BM][2];
#pragma unroll
  for (int r = 0; r < F32_BM; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int k0 = 0; k0 < K; k0 += F32_BK) {
    if (tid < F32_BM * F32_BK) sa[a_row][a_k] = a_valid ? a_src[k0 + a_k] : 0.f;
#pragma unroll
    for (int j = 0; j < F32_BK * C / THREADS; ++j) {
      const int i = tid + j * THREADS;
      sw[i / C][i % C] = w[(size_t)(k0 + i / C) * C + i % C];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F32_BK; ++kk) {
      const float w0 = sw[kk][tid], w1 = sw[kk][tid + THREADS];
#pragma unroll
      for (int r = 0; r < F32_BM; ++r) {
        acc[r][0] = fmaf(sa[r][kk], w0, acc[r][0]);
        acc[r][1] = fmaf(sa[r][kk], w1, acc[r][1]);
      }
    }
    __syncthreads();
  }
  const int c0 = tid, c1 = tid + THREADS;
#pragma unroll
  for (int r = 0; r < F32_BM; ++r) {
    acc[r][0] += bias[c0];
    acc[r][1] += bias[c1];
    const float sum = warp_sum(acc[r][0] + acc[r][1]);
    const float sq = warp_sum(acc[r][0] * acc[r][0] + acc[r][1] * acc[r][1]);
    if (lane == 0) {
      red[0][warp][r] = sum;
      red[1][warp][r] = sq;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < F32_BM; ++r) {
    if (row0 + r >= M) break;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) {
      sum += red[0][wi][r];
      sq += red[1][wi][r];
    }
    const float mean = sum / C;
    const float var = fmaxf(sq / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    float* dst = out + (size_t)(row0 + r) * C;
    dst[c0] = gelu((acc[r][0] - mean) * rstd * scale[c0] + shift[c0], approx);
    dst[c1] = gelu((acc[r][1] - mean) * rstd * scale[c1] + shift[c1], approx);
  }
}

}  // namespace

// h0 [B, N0, 512] at strides (sb, sn, sc) in elements -> out [B, N0, 512]
// contiguous; bf16 (is_bf16 = 1) or fp32; scale, shift [512] fp32.
extern "C" int frontend_ln0_launch(const void* h0, void* out, int B, int N0, long long sb,
                                   long long sn, long long sc, const void* scale,
                                   const void* shift, float eps, int approx, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || N0 == 0) return cudaSuccess;
  dim3 grid((N0 + LN_FRAMES - 1) / LN_FRAMES, B);
  if (is_bf16) {
    cudaError_t e = cudaFuncSetAttribute(frontend_ln0_kernel<bf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, LN_SMEM);
    if (e != cudaSuccess) return e;
    frontend_ln0_kernel<bf16><<<grid, THREADS, LN_SMEM, st>>>(
        static_cast<const bf16*>(h0), static_cast<bf16*>(out), N0, sb, sn, sc,
        static_cast<const float*>(scale), static_cast<const float*>(shift), eps, approx);
  } else {
    cudaError_t e = cudaFuncSetAttribute(frontend_ln0_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, LN_SMEM);
    if (e != cudaSuccess) return e;
    frontend_ln0_kernel<float><<<grid, THREADS, LN_SMEM, st>>>(
        static_cast<const float*>(h0), static_cast<float*>(out), N0, sb, sn, sc,
        static_cast<const float*>(scale), static_cast<const float*>(shift), eps, approx);
  }
  return cudaGetLastError();
}

// One tail layer: h [B, n_in, 512] -> out [B, n_out, 512], both
// contiguous and 16-byte aligned; w [k * 512, 512] (WIO); bias, scale,
// shift [512] fp32; all bf16 (is_bf16 = 1) or all fp32.
extern "C" int frontend_conv_launch(const void* h, const void* w, const void* bias,
                                    const void* scale, const void* shift, void* out, int B,
                                    int n_in, int n_out, int k, int s, float eps, int approx,
                                    int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * n_out;
  if (M <= 0) return cudaSuccess;
  const float* fb = static_cast<const float*>(bias);
  const float* fs = static_cast<const float*>(scale);
  const float* fh = static_cast<const float*>(shift);
  if (is_bf16) {
    cudaError_t e = cudaFuncSetAttribute(frontend_conv_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CONV_SMEM);
    if (e != cudaSuccess) return e;
    frontend_conv_bf16_kernel<<<(M + BM - 1) / BM, THREADS, CONV_SMEM, st>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), fb, fs, fh,
        static_cast<bf16*>(out), M, n_in, n_out, k, s, eps, approx);
  } else {
    frontend_conv_f32_kernel<<<(M + F32_BM - 1) / F32_BM, THREADS, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), fb, fs, fh,
        static_cast<float*>(out), M, n_in, n_out, k, s, eps, approx);
  }
  return cudaGetLastError();
}
