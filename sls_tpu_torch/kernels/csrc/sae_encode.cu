// SAE encode without top-k for Hopper (sm_90a), fp32-accurate on the
// tensor cores:
//
//     out = relu((x - b_dec) @ W_enc + b_enc)      x [N, D] -> out [N, M]
//
// Replaces: sls_tpu/kernels/sae_kernels.py::sae_encode_fused (lines
// 74-116; kernel body _encode_kernel, 68-71).  Unlike the fused encode +
// top-k (sae_encode_topk.cu), the TPU kernel casts x, W_enc and both
// biases to fp32 and sums in fp32.
//
// Accuracy contract: within 1e-4 of the plain fp32 version, and a
// relative L2 error against an fp64 product on the same inputs at most
// 1.5x the plain fp32 version's own.  No product of a single TF32 pass
// (ten mantissa bits) is taken anywhere.  Each fp32 operand is written as
// a sum of two TF32 values, a = a_hi + a_lo with a_hi = rna(a) and a_lo =
// rna(a - a_hi) (cvt.rna.tf32.f32: the tensor core itself would truncate
// the low 13 bits), and the product as a_lo b_hi + a_hi b_lo + a_hi b_hi,
// summed in fp32 ("3xTF32").  The split keeps about 22 of fp32's 24
// bits, and the dropped a_lo b_lo term is ~2^-22 relative; over D = 1024
// the sum's own rounding (~sqrt(D) 2^-24 = 2^-19) is the larger error.
//
// What bounds it on the H100: at the window-overlap path's shape (N =
// 36*201 = 7236, D = 1024, M = 4096) the three products are 3 * 2NDM =
// 182 GFLOP of TF32, 0.368 ms at the 495 TFLOP/s TF32 peak; the split
// pass moves ~46 MB in and ~93 MB out (0.04 ms at 3.35 TB/s).  The fp32
// SIMT form this replaces was capped at 0.906 ms by the 67 TFLOP/s of
// the CUDA cores.
//
// Design.  A split pass (two small kernels) centres x by b_dec in fp32
// and writes x_hi, x_lo as [2, N, D], and W_enc's hi and lo transposed as
// [2, M, D]: TF32 wgmma takes K-major operands only (the transpose bits
// exist for 16-bit types).  The GEMM takes 128 x 128 output tiles, a
// block of two warpgroups each owning 64 rows x 128 columns; a ring of
// three stages is filled by TMA (32 fp32 of K a row, the 128-byte
// swizzle; a box past N reads zeros), thread 0 refilling a stage three
// chunks ahead once both warpgroups have released it.
// Per 8-deep k-step a warpgroup issues wgmma.m64n128k8.tf32 three times,
// small terms first (lo.hi, hi.lo, hi.hi), into a partial sum that
// starts afresh each k-step; the partial sums are added in fp32 in
// registers, a stage's four first, then into the accumulator (see the
// kernel).  The epilogue adds b_enc, applies ReLU and
// stores fp32 rows below N.  Scratch for the split operands comes from
// the wrapper (torch.empty); nothing is cached between calls.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                   // output rows per block: two warpgroups of 64
constexpr int BK = 32;                    // K a stage: 32 fp32 = one 128-byte swizzled row
constexpr int ROW_BYTES = BK * 4;
constexpr int A_BYTES = BM * ROW_BYTES;   // 16 KB: x_hi or x_lo of a stage
// two consumer warpgroups and no producer: thread 0 also issues the TMA
// loads.  ptxas gives a 384-thread block (a producer warpgroup) 168
// registers a thread, setmaxnreg or not, and at 256 threads up to 255:
// room for the three accumulator arrays (3 x 64)
constexpr int THREADS = 256;
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_LIMIT = 232448;        // a block's shared memory on sm_90 (227 KB)

constexpr int BN = 128;                   // output columns per block
constexpr int B_BYTES = BN * ROW_BYTES;   // 16 KB: W_hi or W_lo of a stage
constexpr int STAGE = 2 * A_BYTES + 2 * B_BYTES;
constexpr int STAGES = (SMEM_LIMIT - SWIZZLE_ALIGN - 256) / STAGE;  // 3
constexpr int SMEM = SWIZZLE_ALIGN + STAGES * STAGE;
constexpr int ACC = BN / 2;               // fp32 accumulators a thread: 64 x BN / 128

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// -- the split pass ---------------------------------------------------------

// x [N, D] - b_dec -> hi, lo [N, D]; n4 = N * D / 4 float4, d4 = D / 4
__global__ void __launch_bounds__(256)
split_x_kernel(const float4* __restrict__ x, const float4* __restrict__ b_dec,
               float4* __restrict__ hi, float4* __restrict__ lo, long long n4, int d4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    const float4 v = x[i], b = b_dec[i % d4];
    const float c[4] = {v.x - b.x, v.y - b.y, v.z - b.z, v.w - b.w};
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = tf32_rna(c[e]);
      l[e] = tf32_rna(c[e] - h[e]);  // exact in fp32, then rounded
    }
    hi[i] = make_float4(h[0], h[1], h[2], h[3]);
    lo[i] = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// w [D, M] -> hi, lo [M, D] (transposed through 32 x 32 shared tiles)
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ w, float* __restrict__ hi, float* __restrict__ lo,
               int D, int M) {
  __shared__ float t[32][33];
  const int m0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8) t[r][tx] = w[(size_t)(d0 + r) * M + m0 + tx];
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const float c = t[tx][r];  // w[d0 + tx][m0 + r]
    const float h = tf32_rna(c);
    const size_t o = (size_t)(m0 + r) * D + d0 + tx;
    hi[o] = h;
    lo[o] = tf32_rna(c - h);
  }
}

// -- wgmma: d += A (smem, K-major) . B (smem, K-major), m64nNk8 tf32 -> fp32 --

__device__ __forceinline__ void wgmma_tf32_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// -- the GEMM ------------------------------------------------------------------

// chunk i of K (x hi, x lo, W hi, W lo) into stage i % STAGES by TMA
__device__ __forceinline__ void load_chunk(uint8_t* ring, uint64_t* full, const CUtensorMap* tm_x,
                                           const CUtensorMap* tm_w, int i, int row0, int col0) {
  const int st = i % STAGES;
  uint8_t* s = ring + st * STAGE;
  mbar_expect_tx(&full[st], STAGE);
  tma_load_3d(s, tm_x, &full[st], i * BK, row0, 0);
  tma_load_3d(s + A_BYTES, tm_x, &full[st], i * BK, row0, 1);
  tma_load_3d(s + 2 * A_BYTES, tm_w, &full[st], i * BK, col0, 0);
  tma_load_3d(s + 2 * A_BYTES + B_BYTES, tm_w, &full[st], i * BK, col0, 1);
}

// tm_x: [2, N, D] (hi, lo) as the map {D, N, 2}, box {32, 128, 1};
// tm_w: [2, M, D] as {D, M, 2}, box {32, BN, 1}.  Block (x, y) owns
// columns [BN x, BN x + BN) of rows [128 y, 128 y + 128).  Each 8-deep
// k-step's three products go to a fresh partial sum that is then added
// to the accumulator in fp32, round to nearest: the tensor core's own
// fp32 accumulation does not round to nearest, and a chain of it over
// all of D was measured far outside the accuracy contract (one chain a
// 32-deep stage, just inside it at N = 7236 and outside it at N = 1,
// where cuBLAS's fp32 product is more accurate), so no chain inside the
// tensor core is longer than one k-step.  The k-steps' partial sums are
// then added in two levels: four of them (a stage) into a stage sum, and
// the stage sums into the accumulator.  One fp32 chain of 128 k-steps
// was measured past 1.5x the plain product's error at N = 1 for some
// inputs (cuBLAS's product there is at its most accurate); the two
// levels cut the chain's rounding about in half.  While one warpgroup
// adds its partial sums, the other's products run.
__global__ void __launch_bounds__(THREADS, 1)
encode_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ b_enc, float* __restrict__ out, int N, int D,
                     int M) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint8_t* ring = align_smem(smem_raw);

  const int tid = threadIdx.x, cw = tid >> 7;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int n_chunks = D / BK;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMER_WARPS);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid == 0)
    for (int i = 0; i < STAGES && i < n_chunks; ++i)
      load_chunk(ring, full, &tm_x, &tm_w, i, row0, col0);

  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  float acc[ACC], stage[ACC], part[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint32_t s = smem_u32(ring + st * STAGE);
    const uint32_t a_hi = s + cw * (A_BYTES / 2), a_lo = a_hi + A_BYTES;
    const uint32_t b_hi = s + 2 * A_BYTES, b_lo = b_hi + B_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wg_fence();
      wgmma_tf32_n128(part, kmajor_desc(a_lo, kk), kmajor_desc(b_hi, kk), 0);
      wgmma_tf32_n128(part, kmajor_desc(a_hi, kk), kmajor_desc(b_lo, kk), 1);
      wgmma_tf32_n128(part, kmajor_desc(a_hi, kk), kmajor_desc(b_hi, kk), 1);
      wg_commit();
      wg_wait<0>();
      pin<ACC>(part);
      if (kk == BK / 8 - 1 && lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int j = 0; j < ACC; ++j) stage[j] = kk == 0 ? part[j] : stage[j] + part[j];
    }
    // the chunk STAGES ahead goes into this stage once every consumer
    // warp has released it
    if (tid == 0 && i + STAGES < n_chunks) {
      mbar_wait(&empty[st], (i / STAGES) & 1);
      load_chunk(ring, full, &tm_x, &tm_w, i + STAGES, row0, col0);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] += stage[j];
  }

  // epilogue: thread (warp, g, tq) holds rows warp*16 + g (acc[4j],
  // acc[4j+1]) and + 8 (acc[4j+2], acc[4j+3]) at columns 8j + 2tq, +1
  const int r0 = row0 + cw * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * tq;
    const float2 be = *reinterpret_cast<const float2*>(b_enc + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < N)
        *reinterpret_cast<float2*>(out + (size_t)r * M + col) =
            make_float2(fmaxf(acc[4 * j + 2 * h] + be.x, 0.f),
                        fmaxf(acc[4 * j + 2 * h + 1] + be.y, 0.f));
    }
  }
}

int gemm_launch(const float* xs, const float* ws, const float* b_enc, float* out, int N, int D,
                int M, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[3] = {(cuuint64_t)D, (cuuint64_t)N, 2};
  const cuuint64_t x_strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4};
  const cuuint32_t x_box[3] = {BK, BM, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)D, (cuuint64_t)M, 2};
  const cuuint64_t w_strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)M * D * 4};
  const cuuint32_t w_box[3] = {BK, BN, 1};
  int res = make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, xs, x_dims, x_strides, x_box);
  if (res == 0)
    res = make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ws, w_dims, w_strides, w_box);
  if (res != 0) return res;
  const cudaError_t err = allow_smem(encode_tf32x3_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(M / BN, (N + BM - 1) / BM);
  encode_tf32x3_kernel<<<grid, THREADS, SMEM, stream>>>(tm_x, tm_w, b_enc, out, N, D, M);
  return cudaGetLastError();
}

int split_launch(const float* x, const float* w, const float* b_dec, float* scratch, int N,
                 int D, int M, cudaStream_t stream) {
  float* xs = scratch;
  float* ws = scratch + 2 * (size_t)N * D;
  const long long n4 = (long long)N * D / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  split_x_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(b_dec),
      reinterpret_cast<float4*>(xs), reinterpret_cast<float4*>(xs + (size_t)N * D), n4, D / 4);
  split_w_kernel<<<dim3(M / 32, D / 32), 256, 0, stream>>>(w, ws, ws + (size_t)M * D, D, M);
  return cudaGetLastError();
}

}  // namespace

// x [N, D], w_enc [D, M], b_enc [M], b_dec [D], out [N, M]: fp32,
// contiguous, 16-byte aligned; scratch holds 2 (N + M) D fp32.  D % 32 ==
// 0, M % 128 == 0, N >= 1.  Returns a cudaError_t, or 10000 plus the
// CUresult when a tensor map cannot be made.
extern "C" int sae_encode_launch(const void* x, const void* w_enc, const void* b_enc,
                                 const void* b_dec, void* out, void* scratch, int N, int D,
                                 int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  int err = split_launch(static_cast<const float*>(x), static_cast<const float*>(w_enc),
                         static_cast<const float*>(b_dec), sc, N, D, M, s);
  if (err != 0) return err;
  return gemm_launch(sc, sc + 2 * (size_t)N * D, static_cast<const float*>(b_enc),
                                 static_cast<float*>(out), N, D, M, s);
}
