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
// implicit GEMM, and every level goes through device memory (the TPU
// kernel rounds every level to the compute dtype too, so this changes
// nothing in the function; it costs the levels' round trips, ~0.94 GB at
// the flagship).
//
// bf16 layers (frontend_conv_wgmma_kernel).  Output frame t reads input
// rows s t .. s t + k - 1, one contiguous span of k C values, read in
// place: the wrapper stores every level with an even frame pitch, so a
// level is also the grouped view [B, pitch / s, s C] (rows of s frames,
// no overlap), and the K chunk kc of output rows t .. t + 63 is one TMA
// box of that view at row t + kc / (s C), column kc % (s C).  Tiles stop
// at an utterance's end (a box past it reads the next frames or zeros;
// those rows are not stored).  W arrives K-major ([C_out, k C], the
// wrapper's transposed copy).  The LayerNorm needs whole 512-channel
// rows, and a block's accumulators hold 64 rows x 512 channels at most
// (two consumer warpgroups at 128 fp32 registers a thread), for which it
// must take 72 KB into shared memory every 4.2 MFLOP (the old design's
// blocks, 64 rows each, also reread all of W from L2: ~10.8 GB a batch
// against 0.94 GB of levels).  So a tile is 128 rows x 512 channels,
// split by channels over a cluster of two blocks: each block's two
// consumer warpgroups own 64 rows x its 256 channels (wgmma m64n256k16,
// 128 fp32 accumulators a thread), and a producer thread keeps a ring of
// four stages (K by 64: the tile's 128 rows, 16 KB, and the block's half
// of W, 32 KB) filled by TMA: 48 KB a block for the same 4.2 MFLOP, and
// W read once a tile, not twice.  Both blocks need the same rows, so each
// loads half of them into both by one TMA multicast; a stage is free
// again only when every consumer warp of the cluster has released it
// (a remote mbarrier arrive; see mbar_arrive_cluster).  The epilogue adds
// the bias, takes each row's sum and sum of squares over the block's
// channels, exchanges them with the other block through distributed
// shared memory for the fast-variance LayerNorm (var = max(E[x^2] -
// E[x]^2, 0), rsqrt(var + eps)), applies GELU (gelu() below), rounds to
// bf16 and stores its half of each row.  The epilogue does not overlap
// the next tile's loads (one block an SM); a persistent schedule is
// later work.
//
// LN0 + GELU0 reads conv 0's output and writes the padded NWC level.  The
// encoder's conv 0 leaves each frame's 512 channels contiguous (cuDNN
// takes its one-channel input as channels-last), and
// frontend_ln0_rows_bf16_kernel reads those rows with 16-byte loads, a
// warp a frame.  Any other strides (a channels-first tensor's transposed
// view: frames unit-stride, rows of odd length, so only 2-byte loads are
// aligned) take frontend_ln0_bf16_kernel: a block takes LN_FRAMES frames
// of all channels, each thread keeps 32 loads in flight, two channels
// packed a word into a shared tile whose word index is XORed with the
// frame (conflict-free both along frames and along channels), then a
// warp normalises a frame at a time and stores 128-byte rows.
//
// fp32 operands (the reference's fp32 tests; no path) take SIMT kernels
// and unpadded levels.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int C = 512;                    // channels (XLS-R's conv width)
constexpr int BM = 128;                   // output rows of a cluster's tile (and of a block)
constexpr int BN = 256;                   // output channels of a block: half of C
constexpr int BK = 64;                    // K a stage: 64 bf16 = one 128-byte swizzled row
constexpr int ROW_BYTES = BK * 2;
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * ROW_BYTES;   // 16 KB: the tile's rows, half from each block
constexpr int W_BYTES = BN * ROW_BYTES;   // 32 KB: this block's output channels
constexpr int STAGE = A_BYTES + W_BYTES;
constexpr int CONV_THREADS = 384;         // two consumer warpgroups, then a producer warpgroup
constexpr int CONSUMER_WARPS = 8;
constexpr int CLUSTER = C / BN;           // 2: the blocks that share a tile's rows
constexpr int CONV_SMEM = SWIZZLE_ALIGN + STAGES * STAGE;
static_assert(CONV_SMEM + 2 * BM * 4 + 64 <= 232448, "a block's shared memory on sm_90 (227 KB)");

constexpr int LN_FRAMES = 128;            // bf16 LN0 pass: frames a block
constexpr int LN_THREADS = 512;
constexpr int LN_SMEM = LN_FRAMES * C * 2;
constexpr int ROWS_THREADS = 256;         // bf16 LN0 pass on rows: a warp a frame at a time
constexpr int ROWS_FRAMES = 4;            // frames a warp, all loaded before any is normalised

constexpr int THREADS = 256;              // fp32 kernels
constexpr int F32_LN_FRAMES = 32;
constexpr int F32_LN_SMEM = F32_LN_FRAMES * (C + 1) * 4;
constexpr int F32_BM = 8;                 // fp32 SIMT conv: rows per block
constexpr int F32_BK = 16;

// GELU in fp32: the tanh form (approx) or the erf form.  The tanh form
// 0.5 x (1 + tanh u) is computed as x / (1 + exp(-2u)), the same value
// without the cancellation of 1 + tanh u at negative u; __expf and
// __fdividef keep it within a few fp32 ulps, far below the bf16 rounding
// that follows, at a fraction of tanhf's cost.  Not tanh.approx (~2^-11).
__device__ __forceinline__ float gelu(float x, int approx) {
  if (approx) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return __fdividef(x, 1.f + __expf(-2.f * inner));
  }
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}


__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// LN0 + GELU0, bf16: h0 [B, N0, C] at any strides -> out rows (b, n) at
// b * pitch + n, contiguous channels.  Block (x, b) takes frames
// [LN_FRAMES x, LN_FRAMES x + LN_FRAMES).  The tile holds word w (channels
// 2w, 2w + 1) of frame f at f * C/2 + (w ^ (f & 31)).
__global__ void __launch_bounds__(LN_THREADS)
frontend_ln0_bf16_kernel(const bf16* __restrict__ h0, bf16* __restrict__ out, int N0,
                         int pitch, long long sb, long long sn, long long sc,
                         const float* __restrict__ scale, const float* __restrict__ shift,
                         float eps, int approx) {
  extern __shared__ uint32_t tile[];
  constexpr int WORDS = C / 2;
  constexpr int PER_THREAD = LN_FRAMES * WORDS / LN_THREADS;
  constexpr int BATCH = 16;  // words (two loads each) in flight a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * LN_FRAMES;
  const size_t b = blockIdx.y;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(h0) + b * sb;
  const bool frames_fast = sn == 1;
  auto where = [&](int i, int& f, int& w) {
    if (frames_fast) {  // a warp reads 32 consecutive frames of two channels
      f = i % LN_FRAMES;
      w = i / LN_FRAMES;
    } else {            // a warp reads 64 consecutive channels of a frame
      w = i % WORDS;
      f = i / WORDS;
    }
  };
  for (int it = 0; it < PER_THREAD; it += BATCH) {
    uint32_t v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      int f, w;
      where(tid + (it + u) * LN_THREADS, f, w);
      uint32_t lo = 0, hi = 0;
      if (n0 + f < N0) {
        const unsigned short* p = src + (long long)(n0 + f) * sn + (long long)(2 * w) * sc;
        lo = p[0];
        hi = p[sc];
      }
      v[u] = lo | (hi << 16);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      int f, w;
      where(tid + (it + u) * LN_THREADS, f, w);
      tile[f * WORDS + (w ^ (f & 31))] = v[u];
    }
  }
  __syncthreads();

  // lane holds words lane + 32 j: channels 2 (lane + 32 j) + {0, 1}
  float2 sc2[WORDS / 32], sh2[WORDS / 32];
#pragma unroll
  for (int j = 0; j < WORDS / 32; ++j) {
    sc2[j] = reinterpret_cast<const float2*>(scale)[lane + 32 * j];
    sh2[j] = reinterpret_cast<const float2*>(shift)[lane + 32 * j];
  }
  for (int f = warp; f < LN_FRAMES && n0 + f < N0; f += LN_THREADS / 32) {
    float x[2 * WORDS / 32];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < WORDS / 32; ++j) {
      const uint32_t u = tile[f * WORDS + ((lane + 32 * j) ^ (f & 31))];
      x[2 * j] = bf16_lo(u);
      x[2 * j + 1] = bf16_hi(u);
      s += x[2 * j] + x[2 * j + 1];
      q += x[2 * j] * x[2 * j] + x[2 * j + 1] * x[2 * j + 1];
    }
    s = warp_sum(s);
    q = warp_sum(q);
    const float mean = s / C;
    const float var = fmaxf(q / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (b * pitch + n0 + f) * C);
#pragma unroll
    for (int j = 0; j < WORDS / 32; ++j)
      dst[lane + 32 * j] = __floats2bfloat162_rn(
          gelu((x[2 * j] - mean) * rstd * sc2[j].x + sh2[j].x, approx),
          gelu((x[2 * j + 1] - mean) * rstd * sc2[j].y + sh2[j].y, approx));
  }
}

// LN0 + GELU0, bf16, on rows: h0 [B, N0, C] with each frame's C channels
// contiguous (sc == 1, sn == C), 16-byte aligned, as the encoder's conv 0
// leaves it (cuDNN takes its one-channel input as channels-last).  A warp
// takes ROWS_FRAMES frames, loading all of them (two 16-byte loads a lane
// a frame: lane l holds channels 8 l .. 8 l + 7 and 256 + 8 l .. 263 + 8 l)
// before it normalises any, and stores each frame in two 16-byte stores.
__global__ void __launch_bounds__(ROWS_THREADS)
frontend_ln0_rows_bf16_kernel(const bf16* __restrict__ h0, bf16* __restrict__ out, int N0,
                              long long frames, int pitch, long long sb,
                              const float* __restrict__ scale, const float* __restrict__ shift,
                              float eps, int approx) {
  const int lane = threadIdx.x & 31;
  const long long f0 = (((long long)blockIdx.x * ROWS_THREADS + threadIdx.x) >> 5) * ROWS_FRAMES;
  uint4 v[ROWS_FRAMES][2];
#pragma unroll
  for (int i = 0; i < ROWS_FRAMES; ++i) {
    const long long f = f0 + i;
    if (f < frames) {
      const long long b = f / N0, n = f - b * N0;
      const uint4* src = reinterpret_cast<const uint4*>(h0 + b * sb + n * C);
      v[i][0] = src[lane];
      v[i][1] = src[lane + 32];
    }
  }
  float sc[16], sh[16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 a = reinterpret_cast<const float4*>(scale)[(256 * h + 8 * lane) / 4 + q];
      const float4 z = reinterpret_cast<const float4*>(shift)[(256 * h + 8 * lane) / 4 + q];
      const int j = 8 * h + 4 * q;
      sc[j] = a.x, sc[j + 1] = a.y, sc[j + 2] = a.z, sc[j + 3] = a.w;
      sh[j] = z.x, sh[j + 1] = z.y, sh[j + 2] = z.z, sh[j + 3] = z.w;
    }
#pragma unroll
  for (int i = 0; i < ROWS_FRAMES; ++i) {
    const long long f = f0 + i;
    if (f >= frames) break;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(v[i]);
    float x[16];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[2 * j] = bf16_lo(w[j]);
      x[2 * j + 1] = bf16_hi(w[j]);
      s += x[2 * j] + x[2 * j + 1];
      q += x[2 * j] * x[2 * j] + x[2 * j + 1] * x[2 * j + 1];
    }
    s = warp_sum(s);
    q = warp_sum(q);
    const float mean = s / C;
    const float var = fmaxf(q / C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    uint4 o[2];
    uint32_t* ow = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 r = __floats2bfloat162_rn(
          gelu((x[2 * j] - mean) * rstd * sc[2 * j] + sh[2 * j], approx),
          gelu((x[2 * j + 1] - mean) * rstd * sc[2 * j + 1] + sh[2 * j + 1], approx));
      ow[j] = *reinterpret_cast<const uint32_t*>(&r);
    }
    const long long b = f / N0, n = f - b * N0;
    uint4* dst = reinterpret_cast<uint4*>(out + (b * pitch + n) * C);
    dst[lane] = o[0];
    dst[lane + 32] = o[1];
  }
}

// LN0 + GELU0, fp32: h0 [B, N0, C] at any strides -> out [B, N0, C]
// contiguous.  A block loads F32_LN_FRAMES frames x C channels into
// shared memory, coalesced along whichever of frames and channels is
// unit-stride, then each warp normalises 4 frames.
__global__ void __launch_bounds__(THREADS)
frontend_ln0_f32_kernel(const float* __restrict__ h0, float* __restrict__ out, int N0,
                        long long sb, long long sn, long long sc,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        float eps, int approx) {
  extern __shared__ float ftile[];  // [F32_LN_FRAMES][C + 1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * F32_LN_FRAMES;
  const size_t b = blockIdx.y;
  const float* src = h0 + b * sb;
  const bool frames_fast = sn == 1;
  for (int i = tid; i < F32_LN_FRAMES * C; i += THREADS) {
    int n, c;
    if (frames_fast) {
      n = i % F32_LN_FRAMES; c = i / F32_LN_FRAMES;
    } else {
      c = i % C; n = i / C;
    }
    ftile[n * (C + 1) + c] =
        n0 + n < N0 ? src[(long long)(n0 + n) * sn + (long long)c * sc] : 0.f;
  }
  __syncthreads();
  for (int f = 0; f < F32_LN_FRAMES / 8; ++f) {
    const int n = warp * (F32_LN_FRAMES / 8) + f;
    if (n0 + n >= N0) break;
    const float* row = ftile + n * (C + 1);
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
    float* dst = out + (b * N0 + n0 + n) * C;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int c = lane + 32 * j;
      dst[c] = gelu((row[c] - mean) * rstd * scale[c] + shift[c], approx);
    }
  }
}

// -- one tail layer, bf16: wgmma, TMA, a tile over a cluster of two ---------

// the value at `red`'s offset in the shared memory of the cluster's block
// `peer`
__device__ __forceinline__ float peer_red(const float* red, uint32_t peer) {
  float v;
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [ra];\n}\n"
      : "=f"(v) : "r"(smem_u32(red)), "r"(peer) : "memory");
  return v;
}

// tm_a: the input level [B, pitch_in, C] as the grouped map {s C, pitch_in
// / s, B}, box {64, 64, 1}; tm_w: W^T [C, k C] as {k C, C}, box {64, 256}.
// Cluster (x, b) owns output frames [128 x, 128 x + 128) of utterance b;
// its block `crank` computes output channels [256 crank, 256 crank + 256)
// of them.  Each block loads 64 of the tile's 128 rows for both blocks
// (multicast) and its own half of W.  Out rows (b, t) at b * pitch_out + t.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(CONV_THREADS, 1)
frontend_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                           const __grid_constant__ CUtensorMap tm_w,
                           const float* __restrict__ bias, const float* __restrict__ scale,
                           const float* __restrict__ shift, bf16* __restrict__ out, int n_out,
                           int pitch_out, int k, int s, float eps, int approx) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  __shared__ float red[2][BM];  // this block's row sums and sums of squares
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint8_t* ring = align_smem(smem_raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t crank = cluster_rank();
  const int b = blockIdx.y, t0 = (blockIdx.x / CLUSTER) * BM;
  const int group = s * C;            // K values in one row of the grouped view
  const int n_chunks = k * C / BK;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMER_WARPS * CLUSTER);  // every consumer warp of the cluster
    }
    mbar_fence_init();
  }
  cluster_sync();  // every block's barriers exist before a multicast or a remote arrive

  if (wg == 2) {
    // producer: one thread issues this block's half of A and its W
    regs_dec<40>();
    if (tid == 256) {
      for (int i = 0; i < n_chunks; ++i) {
        const int st = i % STAGES;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        uint8_t* sa = ring + st * STAGE;
        mbar_expect_tx(&full[st], STAGE);  // all of A (both halves) and this block's W
        const int kc = i * BK;
        tma_load_3d_multicast(sa + crank * (A_BYTES / 2), &tm_a, &full[st], kc % group,
                              t0 + (int)crank * (BM / 2) + kc / group, b, (1 << CLUSTER) - 1);
        tma_load_2d(sa + A_BYTES, &tm_w, &full[st], kc, (int)crank * BN);
      }
    }
    cluster_sync();  // as the consumers' two
    cluster_sync();
  } else {
    regs_inc<232>();
    const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
    const int col0 = (int)crank * BN + 2 * tq;  // + 8j: this thread's channels
    float acc[128];  // rows 64 wg + 16 warp + g (+8) of channels col0 + 8j (+1)
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % STAGES;
      mbar_wait(&full[st], (i / STAGES) & 1);
      const uint32_t a = smem_u32(ring + st * STAGE) + wg * (A_BYTES / 2);
      const uint32_t w = smem_u32(ring + st * STAGE) + A_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16_n256(acc, kmajor_desc(a, kk), kmajor_desc(w, kk), i > 0 || kk > 0);
      wg_commit();
      wg_wait<1>();
      pin<128>(acc);
      if (i > 0 && lane == 0)
        for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(&empty[(i - 1) % STAGES], r);
    }
    wg_wait<0>();
    pin<128>(acc);

    // epilogue: bias, then this block's row sums and sums of squares
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + col0 + 8 * j);
      acc[4 * j] += bv.x; acc[4 * j + 1] += bv.y;
      acc[4 * j + 2] += bv.x; acc[4 * j + 3] += bv.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        sum += x0 + x1;
        sq += x0 * x0 + x1 * x1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if (tq == 0) {
        red[0][64 * wg + 16 * warp + 8 * h + g] = sum;
        red[1][64 * wg + 16 * warp + 8 * h + g] = sq;
      }
    }
    cluster_sync();  // both blocks' row sums are in
    // LN over both blocks' channels, GELU, bf16 stores of this block's half
    const uint32_t peer = crank ^ 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * warp + 8 * h + g;
      const float mean = (red[0][r] + peer_red(&red[0][r], peer)) / C;
      const float var =
          fmaxf((red[1][r] + peer_red(&red[1][r], peer)) / C - mean * mean, 0.f);
      const float rstd = rsqrtf(var + eps);
      if (t0 + r >= n_out) continue;
      bf16* dst = out + ((size_t)b * pitch_out + t0 + r) * C + col0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 sc2 = *reinterpret_cast<const float2*>(scale + col0 + 8 * j);
        const float2 sh2 = *reinterpret_cast<const float2*>(shift + col0 + 8 * j);
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            gelu((acc[4 * j + 2 * h] - mean) * rstd * sc2.x + sh2.x, approx),
            gelu((acc[4 * j + 2 * h + 1] - mean) * rstd * sc2.y + sh2.y, approx));
      }
    }
    cluster_sync();  // the peer has read this block's sums
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

// h0 [B, N0, 512] at strides (sb, sn, sc) in elements -> out rows (b, n)
// at b * pitch + n, 512 contiguous channels; bf16 (is_bf16 = 1) or fp32
// (then pitch == N0); scale, shift [512] fp32.
extern "C" int frontend_ln0_launch(const void* h0, void* out, int B, int N0, int pitch,
                                   long long sb, long long sn, long long sc, const void* scale,
                                   const void* shift, float eps, int approx, int is_bf16,
                                   void* stream) {
  static bool smem_set[2][MAX_DEVICES] = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || N0 == 0) return cudaSuccess;
  const float* fs = static_cast<const float*>(scale);
  const float* fh = static_cast<const float*>(shift);
  const bool rows = sc == 1 && sn == C && sb % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(scale) |
                     reinterpret_cast<uintptr_t>(shift)) % 16 == 0;
  if (is_bf16 && rows) {
    const long long frames = (long long)B * N0;
    const long long warps = (frames + ROWS_FRAMES - 1) / ROWS_FRAMES;
    const long long blocks = (warps * 32 + ROWS_THREADS - 1) / ROWS_THREADS;
    frontend_ln0_rows_bf16_kernel<<<(unsigned)blocks, ROWS_THREADS, 0, st>>>(
        static_cast<const bf16*>(h0), static_cast<bf16*>(out), N0, frames, pitch, sb, fs, fh,
        eps, approx);
  } else if (is_bf16) {
    const cudaError_t e = allow_smem(frontend_ln0_bf16_kernel, LN_SMEM, smem_set[0]);
    if (e != cudaSuccess) return e;
    dim3 grid((N0 + LN_FRAMES - 1) / LN_FRAMES, B);
    frontend_ln0_bf16_kernel<<<grid, LN_THREADS, LN_SMEM, st>>>(
        static_cast<const bf16*>(h0), static_cast<bf16*>(out), N0, pitch, sb, sn, sc, fs, fh,
        eps, approx);
  } else {
    if (pitch != N0) return cudaErrorInvalidValue;
    const cudaError_t e = allow_smem(frontend_ln0_f32_kernel, F32_LN_SMEM, smem_set[1]);
    if (e != cudaSuccess) return e;
    dim3 grid((N0 + F32_LN_FRAMES - 1) / F32_LN_FRAMES, B);
    frontend_ln0_f32_kernel<<<grid, THREADS, F32_LN_SMEM, st>>>(
        static_cast<const float*>(h0), static_cast<float*>(out), N0, sb, sn, sc, fs, fh, eps,
        approx);
  }
  return cudaGetLastError();
}

// One tail layer.  bf16 (is_bf16 = 1): h rows (b, n) at b * pitch_in + n
// with pitch_in % s == 0, w the transposed weight [512, k * 512] (rows:
// output channels; columns: (tap, input channel)), out rows at b *
// pitch_out + t.  fp32: h [B, n_in, 512] and out [B, n_out, 512]
// contiguous (pitches equal to the frame counts), w [k * 512, 512] (WIO).
// bias, scale, shift [512] fp32; every pointer 16-byte aligned.  Returns
// a cudaError_t, or 10000 plus the CUresult when a tensor map cannot be
// made.
extern "C" int frontend_conv_launch(const void* h, const void* w, const void* bias,
                                    const void* scale, const void* shift, void* out, int B,
                                    int n_in, int pitch_in, int n_out, int pitch_out, int k,
                                    int s, float eps, int approx, int is_bf16, void* stream) {
  static bool smem_set[MAX_DEVICES] = {};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || n_out <= 0) return cudaSuccess;
  const float* fb = static_cast<const float*>(bias);
  const float* fs = static_cast<const float*>(scale);
  const float* fh = static_cast<const float*>(shift);
  if (!is_bf16) {
    if (pitch_in != n_in || pitch_out != n_out) return cudaErrorInvalidValue;
    const int M = B * n_out;
    frontend_conv_f32_kernel<<<(M + F32_BM - 1) / F32_BM, THREADS, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), fb, fs, fh,
        static_cast<float*>(out), M, n_in, n_out, k, s, eps, approx);
    return cudaGetLastError();
  }
  if (pitch_in % s || (k * C) % BK || (s * C) % BK) return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_w;
  const cuuint64_t a_dims[3] = {(cuuint64_t)s * C, (cuuint64_t)(pitch_in / s), (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {(cuuint64_t)s * C * 2, (cuuint64_t)pitch_in * C * 2};
  const cuuint32_t a_box[3] = {BK, BM / CLUSTER, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)k * C, (cuuint64_t)C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)k * C * 2};
  const cuuint32_t w_box[2] = {BK, BN};
  int res = make_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, h, a_dims, a_strides, a_box);
  if (res == 0)
    res = make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, w_strides, w_box);
  if (res != 0) return res;
  const cudaError_t e = allow_smem(frontend_conv_wgmma_kernel, CONV_SMEM, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((n_out + BM - 1) / BM * CLUSTER, B);
  frontend_conv_wgmma_kernel<<<grid, CONV_THREADS, CONV_SMEM, st>>>(
      tm_a, tm_w, fb, fs, fh, static_cast<bf16*>(out), n_out, pitch_out, k, s, eps, approx);
  return cudaGetLastError();
}
