// Fused SAE encode + exact row top-k for Hopper (sm_90a): a cast pass, a
// bf16 wgmma GEMM fed by TMA, and a radix select.
//
// Replaces: sls_tpu/kernels/sae_kernels.py::sae_encode_topk_fused
// (lines 143-182; kernel body _encode_topk_kernel, 119-140; threshold
// search _topk_threshold_mask, 38-65).  It computes
//
//     acts  = relu(bf16(f32(bf16(x)) - b_dec) @ bf16(W_enc) + b_enc)
//     codes = where(bits(acts) >= lo, acts, 0)
//
// with fp32 accumulation and fp32 output [N, M], where lo is the int32
// bit pattern the TPU kernel's 31-step binary search over [0, 0x7F800000)
// ends at: lo = min(b_k, 0x7F7FFFFF), b_k the k-th largest non-negative
// pattern of the row (non-negative floats order like their int32 bits),
// and lo = 0 when fewer than k entries are positive.  Ties at the k-th
// value are all kept; negative patterns (-0.0 included) never are.
//
// What bounds it on the H100: at the flagship shape (N = 36*201 = 7236,
// D = 1024, M = 4096) the product is 2*N*D*M = 60.7 GFLOP of bf16, 61 us
// at the 989 TFLOP/s data-sheet peak, against 165 MB that must move
// (x and W_enc read once as fp32, the fp32 codes written once), 49 us at
// 3.35 TB/s: the operations bound it.
//
// Design.  The TPU kernel keeps all of W_enc and a 4096-wide fp32 row
// tile in VMEM; a 128-row tile of that is 2 MB, and a Hopper block gets
// at most 227 KB, so the work is three launches behind one entry:
//  (a) a cast pass writes bf16(f32(bf16(x)) - b_dec) as [N, D] and W_enc
//      as bf16 transposed, [M, D] (K-major: both wgmma operands then take
//      the same 128-byte swizzled layout), into scratch from the wrapper;
//      ~46 MB in, ~23 MB out.  Nothing is cached between calls.
//  (b) the GEMM: 128 x 256 output tiles, two consumer warpgroups each
//      owning 64 rows x 256 columns (wgmma m64n256k16, 128 fp32
//      accumulators a thread), a producer warpgroup whose one thread keeps
//      a ring of four 48 KB stages (K by 64) filled by TMA, a box past N
//      reading zeros.  Two column tiles of one row tile form a cluster,
//      each block loading half of the stage's rows into both by one TMA
//      multicast: L2 reads ~0.58 GB where the earlier mma.sync kernel's
//      fp32 128 x 128 tiles pulled ~1.87 GB.  (Pairing row tiles would
//      save a little more, but 7236 rows make 57 tiles: 464 cluster
//      tiles, where 456 fill seven rounds of the 66 clusters an H100
//      holds.)  A stage is
//      free again once every consumer warp of the cluster has released it
//      (mbar_arrive_cluster).  The grid is persistent, one cluster for
//      each that fits on the card, so the ring fills for the next tile
//      while the consumers store this one (faster than a block a tile on
//      the H100).  The epilogue adds b_enc, applies ReLU and stores fp32
//      rows below N.
//  (c) the select: one block a row copies the row's patterns to shared
//      memory and finds b_k by a radix select over the 31 bits of the
//      positive patterns in four digit passes (bits 30-23, 22-15, 14-7,
//      6-0), each a shared-memory histogram of the candidates (atomics)
//      and one suffix scan by warp 0: 9 block barriers a row where the 31
//      halvings took 62.  It rewrites the row in place with every entry
//      below lo zeroed.  The same select, out of place, is the second
//      entry topk_sparsify_launch.
// The dense activations still make one round trip through device memory
// between (b) and (c); a select fused into the GEMM's epilogue (a cluster
// spanning M, row counts over distributed shared memory) is later work.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                   // output rows per block: two warpgroups of 64
constexpr int BN = 256;                   // output columns per block
constexpr int BK = 64;                    // K a stage: 64 bf16 = one 128-byte swizzled row
constexpr int ROW_BYTES = BK * 2;
constexpr int A_BYTES = BM * ROW_BYTES;   // 16 KB of centred x
constexpr int B_BYTES = BN * ROW_BYTES;   // 32 KB of W_enc^T
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr int GEMM_SMEM = SWIZZLE_ALIGN + STAGES * STAGE;
constexpr int CLUSTER = 2;                // column tiles sharing each box of rows
constexpr int GEMM_THREADS = 384;         // two consumer warpgroups and a producer
constexpr int CONSUMER_WARPS = 8;

constexpr int SELECT_THREADS = 256;
constexpr int BINS = 256;                 // one a thread
constexpr int PASSES = 4;

// two bf16 values packed low-first, as a 32-bit word
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f32(bf16(x)) - b: the TPU kernel's centring of a bf16 input, before the
// second rounding to bf16
__device__ __forceinline__ float centre(float x, float b) {
  return __bfloat162float(__float2bfloat16_rn(x)) - b;
}

// -- (a) the cast pass ------------------------------------------------------

// x [N, D] -> bf16(f32(bf16(x)) - b_dec) [N, D]; n4 = N * D / 4, d4 = D / 4
__global__ void __launch_bounds__(256)
cast_x_bf16_kernel(const float4* __restrict__ x, const float4* __restrict__ b_dec,
                   uint2* __restrict__ xc, long long n4, int d4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    const float4 v = x[i], b = b_dec[i % d4];
    xc[i] = make_uint2(pack_bf16(centre(v.x, b.x), centre(v.y, b.y)),
                       pack_bf16(centre(v.z, b.z), centre(v.w, b.w)));
  }
}

// w [D, M] -> bf16 [M, D] (transposed through 32 x 32 shared tiles)
__global__ void __launch_bounds__(256)
cast_w_bf16_kernel(const float* __restrict__ w, bf16* __restrict__ wt, int D, int M) {
  __shared__ float t[32][33];
  const int m0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8) t[r][tx] = w[(size_t)(d0 + r) * M + m0 + tx];
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    wt[(size_t)(m0 + r) * D + d0 + tx] = __float2bfloat16_rn(t[tx][r]);
}

// -- (b) the GEMM -------------------------------------------------------------

// tm_a: centred x [N, D] bf16 as {D, N}, box {64, 64} (half a row tile);
// tm_b: W_enc^T [M, D] bf16 as {D, M}, box {64, 256}.  Persistent: the
// cluster in slot x (blocks (x, 0) and (x, 1)) walks tiles t = x, x +
// gridDim.x, ...: rows [BM r, BM r + BM) with r = t % row_tiles, and
// columns [BN c, BN c + BN) with c = CLUSTER (t / row_tiles) + crank.
// The two blocks share the rows, block `crank` loading rows [BM r + BM /
// 2 crank, + BM / 2) into both, and each loads its own W_enc^T.  The
// ring's phases run on from tile to tile, so the producer fills the next
// tile's stages while the consumers store this one.
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(GEMM_THREADS, 1)
encode_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b,
                         const float* __restrict__ b_enc, float* __restrict__ out, int N, int D,
                         int M) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint8_t* ring = align_smem(smem_raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t crank = cluster_rank();
  const int row_tiles = (N + BM - 1) / BM;
  const int tiles = row_tiles * ((M + CLUSTER * BN - 1) / (CLUSTER * BN));
  const int n_chunks = (D + BK - 1) / BK;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMER_WARPS * CLUSTER);  // every consumer warp of the cluster
    }
    mbar_fence_init();
  }
  cluster_sync();  // every block's barriers exist before a multicast or a remote arrive

  if (wg == 2) {
    // producer: one thread issues its half of the rows and this block's W_enc^T
    regs_dec<40>();
    if (tid == 256) {
      int g = 0;  // chunks issued over all tiles: the ring's position and phase
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t % row_tiles) * BM;
        const int col0 = ((t / row_tiles) * CLUSTER + (int)crank) * BN;
        for (int i = 0; i < n_chunks; ++i, ++g) {
          const int st = g % STAGES;
          mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);
          uint8_t* s = ring + st * STAGE;
          mbar_expect_tx(&full[st], STAGE);  // both halves of the rows and its W_enc^T
          tma_load_2d_multicast(s + crank * (A_BYTES / CLUSTER), &tm_a, &full[st], i * BK,
                                row0 + (int)crank * (BM / CLUSTER), (1 << CLUSTER) - 1);
          tma_load_2d(s + A_BYTES, &tm_b, &full[st], i * BK, col0);
        }
      }
    }
    cluster_sync();  // as the consumers'
  } else {
    regs_inc<232>();
    const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
    float acc[128];  // rows 64 wg + 16 warp + g (+8) of columns col0 + 8j + 2tq (+1)
    int c = 0;  // chunks consumed over all tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile % row_tiles) * BM;
      const int col0 = ((tile / row_tiles) * CLUSTER + (int)crank) * BN;
      for (int i = 0; i < n_chunks; ++i, ++c) {
        const int st = c % STAGES;
        mbar_wait(&full[st], (c / STAGES) & 1);
        const uint32_t a = smem_u32(ring + st * STAGE) + wg * (A_BYTES / 2);
        const uint32_t b = smem_u32(ring + st * STAGE) + A_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_bf16_n256(acc, kmajor_desc(a, kk), kmajor_desc(b, kk), i > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();
        pin<128>(acc);
        if (i > 0 && lane == 0)  // the chunk before this one is read
          for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(&empty[(c - 1) % STAGES], r);
      }
      wg_wait<0>();
      pin<128>(acc);
      if (lane == 0)  // the tile's last chunk, before the stores
        for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(&empty[(c - 1) % STAGES], r);

      // epilogue: bias, ReLU, fp32 stores of rows below N and columns below M
      const int r0 = row0 + 64 * wg + 16 * warp + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j + 2 * tq;
        if (col >= M) continue;
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
    cluster_sync();  // no remote arrive or multicast still targets a block that has left
  }
}

// -- (c) the select -----------------------------------------------------------

// The radix select's digits, high to low: (shift, width) of pass p
__device__ __forceinline__ int pass_shift(int p) { return p < 3 ? 23 - 8 * p : 0; }
__device__ __forceinline__ int pass_width(int p) { return p < 3 ? 8 : 7; }

__global__ void __launch_bounds__(SELECT_THREADS)
topk_radix_select_kernel(const float* in, float* out, int M, int k) {
  // in and out may be the same rows: each row is read whole into shared
  // memory before any of it is written
  extern __shared__ __align__(16) int bits[];  // the row's M patterns
  __shared__ uint32_t hist[2][BINS];
  __shared__ int s_prefix, s_rank, s_short;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row_in = in + (size_t)blockIdx.x * M;
  float* row_out = out + (size_t)blockIdx.x * M;
  const bool vec = (M & 3) == 0;  // rows of whole 16-byte words

  hist[0][tid] = 0;
  hist[1][tid] = 0;
  if (tid == 0) s_short = 0;
  if (vec) {
#pragma unroll 4
    for (int j = tid; j < M / 4; j += SELECT_THREADS)
      reinterpret_cast<float4*>(bits)[j] = reinterpret_cast<const float4*>(row_in)[j];
  } else {
#pragma unroll 4
    for (int j = tid; j < M; j += SELECT_THREADS) bits[j] = __float_as_int(row_in[j]);
  }
  __syncthreads();

  int prefix = 0, rank = k;  // b_k's bits found so far; its rank among the candidates
  for (int p = 0; p < PASSES; ++p) {
    const int shift = pass_shift(p), hi = shift + pass_width(p);
    uint32_t* h = hist[p & 1];
    // candidates: positive patterns whose bits above `hi` are b_k's (all
    // positive patterns in pass 0, where hi = 31)
    for (int j = tid; j < M; j += SELECT_THREADS) {
      const int b = bits[j];
      if (b > 0 && (b >> hi) == (prefix >> hi))
        atomicAdd(&h[(b >> shift) & ((1 << pass_width(p)) - 1)], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins [8l, 8l + 8); S = the candidates in bins >= 8l
      uint32_t c[8], s = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = h[8 * lane + b];
        s += c[b];
        hist[(p + 1) & 1][8 * lane + b] = 0;  // the next pass's histogram
      }
      uint32_t S = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_down_sync(0xffffffffu, S, off);
        if (lane + off < 32) S += v;
      }
      const uint32_t total = __shfl_sync(0xffffffffu, S, 0);
      uint32_t above = S - s;  // candidates in bins above this lane's
      if (p == 0 && total < (uint32_t)rank) {
        if (lane == 0) s_short = 1;  // fewer than k positives: lo = 0
      } else if (above < (uint32_t)rank && S >= (uint32_t)rank) {
#pragma unroll
        for (int b = 7; b >= 0; --b) {
          if (above + c[b] >= (uint32_t)rank) {
            s_prefix = prefix | ((8 * lane + b) << shift);
            s_rank = rank - (int)above;
            break;
          }
          above += c[b];
        }
      }
    }
    __syncthreads();
    if (s_short) break;
    prefix = s_prefix;
    rank = s_rank;
  }
  const int lo = s_short ? 0 : min(prefix, 0x7F7FFFFF);
  if (vec) {
    for (int j = tid; j < M / 4; j += SELECT_THREADS) {
      const int4 b = reinterpret_cast<const int4*>(bits)[j];
      reinterpret_cast<float4*>(row_out)[j] =
          make_float4(b.x >= lo ? __int_as_float(b.x) : 0.f, b.y >= lo ? __int_as_float(b.y) : 0.f,
                      b.z >= lo ? __int_as_float(b.z) : 0.f, b.w >= lo ? __int_as_float(b.w) : 0.f);
    }
  } else {
    for (int j = tid; j < M; j += SELECT_THREADS)
      row_out[j] = bits[j] >= lo ? __int_as_float(bits[j]) : 0.f;
  }
}

// the select's dynamic shared memory: one int per column
int select_launch(const float* in, float* out, int N, int M, int k, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  const int smem = M * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(topk_radix_select_kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
  }
  topk_radix_select_kernel<<<N, SELECT_THREADS, smem, stream>>>(in, out, M, k);
  return cudaGetLastError();
}

int gemm_launch(const bf16* xc, const bf16* wt, const float* b_enc, float* out, int N, int D,
                int M, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  CUtensorMap tm_a, tm_b;
  const cuuint64_t a_dims[2] = {(cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t b_dims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t a_box[2] = {BK, BM / CLUSTER};
  const cuuint32_t b_box[2] = {BK, BN};
  int res = make_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xc, a_dims, strides, a_box);
  if (res == 0)
    res = make_map(&tm_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wt, b_dims, strides, b_box);
  if (res != 0) return res;
  cudaError_t err = allow_smem(encode_bf16_wgmma_kernel, GEMM_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  // one slot for each cluster that fits on the card at once, found once
  // a process and device
  static int slots[MAX_DEVICES] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n_slots = dev < MAX_DEVICES ? slots[dev] : 0;
  if (n_slots == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, CLUSTER, 1);
    cfg.blockDim = dim3(GEMM_THREADS, 1, 1);
    cfg.dynamicSmemBytes = GEMM_SMEM;
    err = cudaOccupancyMaxActiveClusters(&n_slots, encode_bf16_wgmma_kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n_slots < 1) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) slots[dev] = n_slots;
  }
  const int tiles = (N + BM - 1) / BM * ((M + CLUSTER * BN - 1) / (CLUSTER * BN));
  dim3 grid(tiles < n_slots ? tiles : n_slots, CLUSTER);
  encode_bf16_wgmma_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(tm_a, tm_b, b_enc, out,
                                                                      N, D, M);
  return cudaGetLastError();
}

}  // namespace

// x [N, D], w_enc [D, M], b_enc [M], b_dec [D], out [N, M]: fp32,
// contiguous, 16-byte aligned; scratch holds (N + M) D bf16, 16-byte
// aligned.  D % 32 == 0, M % 128 == 0, N >= 1, 1 <= k <= M.  Returns a
// cudaError_t, or 10000 plus the CUresult when a tensor map cannot be made.
extern "C" int sae_encode_topk_launch(const void* x, const void* w_enc, const void* b_enc,
                                      const void* b_dec, void* out, void* scratch, int N,
                                      int D, int M, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* xc = static_cast<bf16*>(scratch);
  bf16* wt = xc + (size_t)N * D;
  const long long n4 = (long long)N * D / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  cast_x_bf16_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(b_dec),
      reinterpret_cast<uint2*>(xc), n4, D / 4);
  cast_w_bf16_kernel<<<dim3(M / 32, D / 32), 256, 0, s>>>(static_cast<const float*>(w_enc), wt,
                                                          D, M);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* acts = static_cast<float*>(out);
  err = gemm_launch(xc, wt, static_cast<const float*>(b_enc), acts, N, D, M, s);
  if (err != 0) return err;
  return select_launch(acts, acts, N, M, k, s);
}

// The exact row top-k alone (replaces sae_kernels.py::topk_sparsify_pallas,
// lines 232-259, kernel body _topk_mask_kernel, 225-229): out = in where
// bits(in) >= lo, else 0, lo as above.  in, out [N, M] fp32, contiguous;
// N >= 1.  Bytes bound it: one read of in and one write of out; the
// radix passes run on the shared-memory copy.
extern "C" int topk_sparsify_launch(const void* in, void* out, int N, int M, int k,
                                    void* stream) {
  return select_launch(static_cast<const float*>(in), static_cast<float*>(out), N, M, k,
                       static_cast<cudaStream_t>(stream));
}
