// SAE decode for Hopper (sm_90a): out = codes @ W_dec + b_dec, fp32,
// streaming W_dec once per row tile.
//
// Replaces: sls_tpu/kernels/sae_kernels.py::sae_decode_fused (lines
// 440-494), whose TPU kernel streams dense [256, 1024] code tiles and
// [1024, D] weight tiles through the MXU with an accumulating fp32
// output block.
//
// Contract: each row's sum is taken in fp32 over its nonzero codes in
// ascending atom index (one fmaf a term, from 0), then b_dec is added;
// zero codes are skipped, and no product is taken in TF32 (one TF32 pass
// would miss the 1e-4 tolerance at these magnitudes).  Any number of
// nonzeros a row works, up to all M.
//
// What bounds it on the H100: the codes come out of the top-k encode
// with k of M entries nonzero (k/M = 128/4096, about 3 %).  The product
// these inputs need is 2*nnz*D operations: at the flagship shape
// (N = 7236, M = 4096, D = 1024, nnz ~ N*k) 1.9 GFLOP of fp32, 28 us at
// the 67 TFLOP/s non-tensor fp32 peak, while the bytes that must move
// (codes 119 MB and W_dec 17 MB read once, out 30 MB written once) take
// 49 us at 3.35 TB/s: memory bounds it.
//
// Design.  The gather form of this kernel gave each row a block that
// gathered every selected W_dec row (4 KB) from L2: rows x nnz x D x 4 =
// 3.79 GB at the flagship, of the order of the L2's whole read bandwidth
// in its 0.52 ms on the H100.
// Random supports share little between a few rows, but a tile of 128
// rows selects nearly all of the 4096 atoms, so here a block owns 128
// rows x 256 columns of out and streams W_dec's [M, 256] slice through
// shared memory once, in windows of 32 atoms, beside the [128, 32] tile
// of codes of the same window: a ring of four 48 KB stages filled by TMA
// (no swizzle; boxes past N, M or D read zeros) by a producer warp.
// Sixteen consumer warps own 8 rows each, a lane 8 columns (64 fp32
// accumulators a thread).  For each window a warp reads its rows' 32
// codes, one a lane, takes a ballot of the nonzeros and walks them in
// ascending order, each lane adding the code (a shuffle) times its 8
// columns of the atom's W_dec row (two 16-byte shared loads).  Two row
// tiles of one D slice form a cluster, each block loading half of the
// window's W_dec box into both by one TMA multicast; a stage is free
// again once every consumer warp of the cluster has released it.  L2
// reads at the flagship: 58 tiles x 4 slices x 128 windows x (16 KB of
// codes + 16 KB of W_dec) = 0.97 GB; the four slices of a row tile are
// neighbours in the grid, so the codes come from device memory about
// once.  What bounds this design is shared memory: each nonzero's 1 KB
// slice of W_dec is read from it once per row (3.79 GB at the flagship)
// beside the TMA writes (1.46 GB), ~0.18 ms at the SMs' ~29.6 TB/s.
// On the H100 a producer warp and 16 warps of 8 rows ran about twice as
// fast as thread 0 refilling the ring between 8 warps of 16 rows, which
// was latency-bound.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                  // rows a block
constexpr int BN = 256;                  // columns of D a block: 8 a lane
constexpr int Q = BN / 128;              // a lane's float4 groups, 128 columns apart
constexpr int BK = 32;                   // atoms a window: one a lane
constexpr int CONSUMER_WARPS = 16;
constexpr int ROWS = BM / CONSUMER_WARPS;  // rows a consumer warp: 8
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);  // and a producer warp
constexpr int C_BYTES = BM * BK * 4;     // 16 KB: the window's codes
constexpr int W_BYTES = BK * BN * 4;     // 32 KB: the window's W_dec rows
constexpr int STAGE = C_BYTES + W_BYTES;
constexpr int STAGES = 4;
constexpr int SMEM = SWIZZLE_ALIGN + STAGES * STAGE;
constexpr int CLUSTER = 2;               // row tiles sharing each W_dec box

// tm_c: codes [N, M] as {M, N}, box {32, 128}; tm_w: W_dec [M, D] as
// {D, M}, box {256, 32 / CLUSTER}.  Cluster (x, y group) owns columns
// [BN x, BN x + BN) of CLUSTER neighbouring row tiles.
__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(THREADS, 1)
decode_stream_kernel(const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ b_dec, float* __restrict__ out, int N, int M,
                     int D) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint8_t* ring = align_smem(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t crank = cluster_rank();
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int n_chunks = (M + BK - 1) / BK;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMER_WARPS * CLUSTER);  // every consumer warp of the cluster
    }
    mbar_fence_init();
  }
  cluster_sync();  // every block's barriers exist before a multicast or a remote arrive

  if (warp == CONSUMER_WARPS) {
    // producer: window i into stage i % STAGES once the cluster has
    // released its last window: this block's codes, and its part of the
    // W_dec rows into every block of the cluster
    if (lane == 0) {
      for (int i = 0; i < n_chunks; ++i) {
        const int st = i % STAGES;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        uint8_t* s = ring + st * STAGE;
        mbar_expect_tx(&full[st], STAGE);
        tma_load_2d(s, &tm_c, &full[st], i * BK, row0);
        tma_load_2d_multicast(s + C_BYTES + crank * (W_BYTES / CLUSTER), &tm_w, &full[st], col0,
                              i * BK + (int)crank * (BK / CLUSTER), (1 << CLUSTER) - 1);
      }
    }
    cluster_sync();  // as the consumers'
    return;
  }

  float4 acc[ROWS][Q];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[r][q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < n_chunks; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const float* ct = reinterpret_cast<const float*>(ring + st * STAGE) + ROWS * warp * BK;
    const float* wt = reinterpret_cast<const float*>(ring + st * STAGE + C_BYTES) + 4 * lane;
    float cv[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) cv[r] = ct[r * BK + lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      uint32_t nz = __ballot_sync(0xffffffffu, cv[r] != 0.f);
      while (nz) {  // ascending atoms of this window
        const int a = __ffs(nz) - 1;
        nz &= nz - 1;
        const float c = __shfl_sync(0xffffffffu, cv[r], a);
        float4 w[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) w[q] = *reinterpret_cast<const float4*>(wt + a * BN + 128 * q);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          acc[r][q].x = fmaf(c, w[q].x, acc[r][q].x);
          acc[r][q].y = fmaf(c, w[q].y, acc[r][q].y);
          acc[r][q].z = fmaf(c, w[q].z, acc[r][q].z);
          acc[r][q].w = fmaf(c, w[q].w, acc[r][q].w);
        }
      }
    }
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(&empty[st], r);
  }

  // b_dec after the sums, rows below N and columns below D (D % 4 == 0)
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int col = col0 + 128 * q + 4 * lane;
    if (col >= D) continue;
    const float4 b = *reinterpret_cast<const float4*>(b_dec + col);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + ROWS * warp + r;
      if (row < N)
        *reinterpret_cast<float4*>(out + (size_t)row * D + col) =
            make_float4(acc[r][q].x + b.x, acc[r][q].y + b.y, acc[r][q].z + b.z,
                        acc[r][q].w + b.w);
    }
  }
  cluster_sync();  // no remote arrive or multicast still targets a block that has left
}

}  // namespace

// codes [N, M], w_dec [M, D], b_dec [D], out [N, D]: fp32, contiguous,
// 16-byte aligned.  M % 4 == 0, D % 4 == 0 (TMA's 16-byte row strides),
// N >= 1.  Returns a cudaError_t, or 10000 plus the CUresult when a
// tensor map cannot be made.
extern "C" int sae_decode_launch(const void* codes, const void* w_dec, const void* b_dec,
                                 void* out, int N, int M, int D, void* stream) {
  static bool smem_set[MAX_DEVICES] = {};
  CUtensorMap tm_c, tm_w;
  const cuuint64_t c_dims[2] = {(cuuint64_t)M, (cuuint64_t)N};
  const cuuint64_t c_strides[1] = {(cuuint64_t)M * 4};
  const cuuint32_t c_box[2] = {BK, BM};
  const cuuint64_t w_dims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t w_strides[1] = {(cuuint64_t)D * 4};
  const cuuint32_t w_box[2] = {BN, BK / CLUSTER};
  int res = make_map(&tm_c, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, codes, c_dims, c_strides, c_box,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (res == 0)
    res = make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, w_dec, w_dims, w_strides, w_box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (res != 0) return res;
  const cudaError_t err = allow_smem(decode_stream_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int row_tiles = (N + BM - 1) / BM;
  dim3 grid((D + BN - 1) / BN, (row_tiles + CLUSTER - 1) / CLUSTER * CLUSTER);
  decode_stream_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tm_c, tm_w, static_cast<const float*>(b_dec), static_cast<float*>(out), N, M, D);
  return cudaGetLastError();
}
