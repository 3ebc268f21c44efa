// Overlap-window vote merge for Hopper (sm_90a), in the TPU kernel's bf16
// arithmetic: one launch that reads each frame once.
//
// Replaces: sls_tpu/kernels/sae_kernels.py::window_vote_fused (line 330;
// kernel body _window_vote_kernel, 262-327).  For each utterance of acts
// [B, T, M] (post-ReLU fp32), with stride = window / 2, n_chunks chunks of
// stride frames (frames >= T count as zeros) and num_windows windows of
// two chunks each:
//
//   a       = bf16(acts)
//   chunk_j = fp32 sum of the chunk's frames, in frame order from 0.f
//   wsum_i  = bf16(chunk_i + chunk_{i+1})
//   mask_i  = bits(wsum_i) >= lo_i
//   cover_j = mask_{j-1} + mask_j       (valid windows only)
//   votes_t = bf16(a_t * cover_{t / stride})
//   out_t   = bits(votes_t) >= lo_t && bits(votes_t) > 0 ? a_t : 0  (fp32)
//
// where lo is the end point of the TPU kernel's 15 halvings of [0, 0x7F80)
// on the sign-extended int16 patterns: lo = min(b_k, 0x7F7F), b_k the k-th
// largest pattern >= 1, or 0 when fewer than k patterns are >= 1.  A radix
// select finds it in two digit passes over the 15 bits (bits 14-7, the
// exponent, in 256 bins; then bits 6-0 of the patterns in the chosen bin,
// in 128), counted in shared-memory histograms.  Frames after the last
// window's are written as zeros.
//
// What bounds it on the H100: at the flagship shape (B 36, T 201, M 4096,
// window 8: 49 windows, 51 chunks) the function reads acts once and writes
// out once, 237 MB in fp32, 71 us at 3.35 TB/s; its 9,000 selects over
// 4096 patterns are a few GOP of integer work: bytes bound it.
//
// Design: a persistent grid, one block an SM.  Block b takes a contiguous
// range of the B * n_chunks (utterance, chunk) pairs, so that every block
// has 13 or 14 chunks; the range's part in each utterance is a stripe
// [c0, c1).  A stripe also reads chunk c0 - 1 (for window c0 - 1) and
// chunk c1 (for window c1 - 1) where they exist, for their sums alone:
// the only frames read twice.  Three roles overlap across chunks:
//  - a producer warp copies each frame row (M * 4 bytes) into a ring of
//    shared-memory stages with a 1-D bulk copy on an mbarrier, as far
//    ahead as the ring allows; frames >= T are never read;
//  - team X (8 warps) casts chunk j's frames to bf16 into the chunk's slot
//    (three slots), adds the chunk sums in registers (fp32, in frame
//    order; 16 columns a thread at most), forms window j - 1's bf16 sums
//    while counting their exponents (the select's first pass), finishes
//    the select, writes the window's mask as bits and lists the columns
//    that chunk j - 1's frames have a window over (a small share of M);
//  - team Y (4 warps, a frame each) zeroes each output row with one bulk
//    store from a row of zeros, selects each frame of a listed chunk over
//    its listed columns only (a vote elsewhere is +-0 and never kept) and
//    writes the kept values.  A chunk holding an inf or NaN, whose vote is
//    NaN where no window covers it, is walked densely instead.
// Team X fills a slot once team Y has voted the chunk before in it, and
// marks each chunk ready once its list is built (mbarriers both ways).
// Where M > 4096, M % 8 != 0, or three chunks of bf16 frames and a ring
// of two stages do not fit in 227 KB (large M * stride), the same roles
// run in a streamed form that keeps only the window row, the masks, the
// lists, the chunk sums and the listed values on chip (6.5 M bytes and
// 56 KB beside the selects): no ring, chunk slots or bulk stores.  Team X
// reads each chunk's frames from global memory, four columns and eight
// frames a thread at a time, their loads in flight together, and carries
// its sums in shared memory to the next window; where they do not fit
// (M above about 25,700) it reads both chunks of each window instead.
// Team Y writes each row's zeros, then reads the frame's values (from L2)
// at the listed columns once, for both passes of its select and the kept
// values.  A list holds at most 4096 columns: a chunk covered on more is
// walked densely, as one holding an inf or NaN is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// Team X (cast and sum, window selects, lists) and team Y (frame selects
// and the output), and the producer warp
constexpr int X_WARPS = 8;
constexpr int Y_GROUPS = 4, GROUP_WARPS = 1;  // frame selects side by side
constexpr int X_THREADS = 32 * X_WARPS;
constexpr int GROUP_THREADS = 32 * GROUP_WARPS;
constexpr int Y_THREADS = Y_GROUPS * GROUP_THREADS;
constexpr int CONSUMERS = X_THREADS + Y_THREADS;
constexpr int THREADS = CONSUMERS + 32;
constexpr int BAR_X = 1, BAR_Y = 2;  // named barriers; frame group g uses 3 + g
constexpr int SLOTS = 3;             // chunks in flight between the teams
constexpr int MAX_STAGES = 8;
// the resident form keeps each thread's chunk sums in registers: QMAX
// float4 of columns, so M <= 4 * QMAX * X_THREADS
constexpr int QMAX = 4;
// the streamed form's chunk sums: columns and frames a thread loads at once
constexpr int XCOLS = 4, XFRAMES = 8;
// a slot's list holds at most this many columns (all of them in the
// resident form); a chunk with a longer one is walked densely
constexpr int LIST_CAP = 4096;
constexpr int SMEM_LIMIT = 232448;   // 227 KB of dynamic shared memory
constexpr int BINS_HI = 256, BINS_LO = 128;

// a compile-time flag passed to a generic lambda
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// one select's histograms and results
struct Sel {
  uint32_t hi[BINS_HI];
  uint32_t lo[BINS_LO];
  int bin, rank, few;
};

__device__ __forceinline__ int bf16_bits(float v) {  // sign-extended int16 pattern
  return static_cast<int>(__bfloat16_as_short(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

// four columns' window sums bf16(prev + cur), packed
__device__ __forceinline__ uint2 window_sums(float4 p, float4 c) {
  return make_uint2(pack_bf16(p.x + c.x, p.y + c.y), pack_bf16(p.z + c.z, p.w + c.w));
}

// bit 15 or 31 set where a half of a word of two bf16 values has an
// exponent of all ones (inf or NaN): its exponent bits plus one carry into
// the sign bit's place
__device__ __forceinline__ uint32_t nonfinite2(uint32_t w) {
  return ((w & 0x7F807F80u) + 0x00800080u) & 0x80008000u;
}

// eight sign-extended patterns of a uint4 of bf16 patterns
__device__ __forceinline__ void unpack8(uint4 u, int p[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[2 * i] = static_cast<int>(w[i] << 16) >> 16;
    p[2 * i + 1] = static_cast<int>(w[i]) >> 16;
  }
}

__device__ __forceinline__ void clear_sel(Sel* sel, int tid, int n) {
  for (int i = tid; i < BINS_HI + BINS_LO; i += n) {
    if (i < BINS_HI) sel->hi[i] = 0u;
    else sel->lo[i - BINS_HI] = 0u;
  }
}

// the select's two passes for one pattern: the candidates' high digit, then
// the low digit of the candidates whose high digit is `hi`
__device__ __forceinline__ void count_hi(Sel* sel, int p) {
  if (p > 0) atomicAdd(&sel->hi[p >> 7], 1u);
}

__device__ __forceinline__ void count_lo(Sel* sel, int p, int hi) {
  if (p > 0 && (p >> 7) == hi) atomicAdd(&sel->lo[p & 127], 1u);
}

// One warp finds the bin of NB that holds the `rank`-th largest candidate,
// and that candidate's rank within it.  Lane l reads bins NB - 1 - l - 32 r
// (no bank conflicts); each round's total is one warp reduction, so that
// one prefix scan, in the round that reaches `rank`, finds the bin.  On the
// first pass it also records whether there are fewer than `rank`
// candidates.
template <int NB>
__device__ void scan_bins(const uint32_t* h, uint32_t rank, int lane, Sel* sel, bool first) {
  constexpr int R = NB / 32;
  uint32_t c[R], tot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = h[NB - 1 - 32 * r - lane];
#pragma unroll
  for (int r = 0; r < R; ++r) tot[r] = __reduce_add_sync(0xffffffffu, c[r]);
  int round = -1;
  uint32_t above = 0, cr = 0, ab = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (round < 0 && above + tot[r] >= rank) {
      round = r;
      cr = c[r];
      ab = above;
    }
    above += tot[r];
  }
  if (round < 0) {
    if (first && lane == 0) sel->few = 1;
    return;
  }
  uint32_t S = cr;  // candidates in this round's bins from its top to this lane's
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, S, off);
    if (lane >= off) S += v;
  }
  const uint32_t at = ab + S;  // candidates in bins >= this lane's
  const uint32_t found = __ballot_sync(0xffffffffu, at >= rank);
  if (lane == __ffs(found) - 1) {
    sel->bin = NB - 1 - 32 * round - lane;
    sel->rank = static_cast<int>(rank - (at - cr));
  }
  if (first && lane == 0) sel->few = 0;
}

// The rest of a select after pass 1 (count_hi over every pattern of the
// row, on a cleared Sel): lo of the row, found by `n` threads (tid in [0,
// n)) on named barrier `bar`; pass2(hi) runs count_lo over the row again.
// Every thread returns lo.
template <class Pass2>
__device__ int finish_select(int k, int tid, int n, int bar, Sel* sel, const Pass2& pass2) {
  bar_sync(bar, n);
  if (tid < 32) scan_bins<BINS_HI>(sel->hi, static_cast<uint32_t>(k), tid, sel, true);
  bar_sync(bar, n);
  if (sel->few) return 0;
  const int hi = sel->bin;
  const uint32_t rank = static_cast<uint32_t>(sel->rank);
  pass2(hi);
  bar_sync(bar, n);
  if (tid < 32) scan_bins<BINS_LO>(sel->lo, rank, tid, sel, false);
  bar_sync(bar, n);
  return min((hi << 7) | sel->bin, 0x7F7F);
}

// A frame's vote row: its bf16 values (the chunk buffer's row, or the
// frame's fp32 row in global memory) times the cover of two window masks.
template <bool RESIDENT>
struct FrameRow {
  const uint4* a_s;
  const float* a_g;
  const uint8_t* m0;
  const uint8_t* m1;
  int M;
  __device__ float value(int c) const {
    if (RESIDENT)
      return __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(a_s)[c]) << 16);
    return bf16_round(__ldg(a_g + c));
  }
  __device__ int cover(int c) const {
    return ((m0[c >> 3] >> (c & 7)) & 1) + ((m1[c >> 3] >> (c & 7)) & 1);
  }
  // columns 8g .. 8g + 7: values (0 past M) and patterns (-1 past M)
  __device__ void get8(int g, float a[8], int p[8]) const {
    if (RESIDENT) {
      const uint4 u = a_s[g];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[2 * i] = __uint_as_float(w[i] << 16);
        a[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = 8 * g + e < M ? bf16_round(__ldg(a_g + 8 * g + e)) : 0.f;
    }
    const uint32_t b0 = m0[g], b1 = m1[g];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float cover = static_cast<float>(((b0 >> e) & 1u) + ((b1 >> e) & 1u));
      p[e] = RESIDENT || 8 * g + e < M ? bf16_bits(a[e] * cover) : -1;
    }
  }
};

// The columns whose bit is set in byte(g) (the bits of columns 8g ..
// 8g + 7), ascending, into `list`, the first `cap` of them, by team X;
// every thread of it returns their count.  byte(g) is called once for each
// g < n8.
template <class Byte>
__device__ int compact(const Byte& byte_of, int n8, uint16_t* list, int cap, int* wtot, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int g0 = 0; g0 < n8; g0 += X_THREADS) {
    const int g = g0 + tid;
    const uint32_t byte = g < n8 ? byte_of(g) : 0u;
    const int cnt = __popc(byte);
    int S = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, S, off);
      if (lane >= off) S += v;
    }
    if (lane == 31) wtot[warp] = S;
    bar_sync(BAR_X, X_THREADS);
    int before = base, total = 0;
#pragma unroll
    for (int w = 0; w < X_WARPS; ++w) {
      const int t = wtot[w];
      before += w < warp ? t : 0;
      total += t;
    }
    int pos = before + S - cnt;
    for (uint32_t b = byte; b; b &= b - 1, ++pos)
      if (pos < cap) list[pos] = static_cast<uint16_t>(8 * g + __ffs(b) - 1);
    base += total;
    bar_sync(BAR_X, X_THREADS);  // wtot is read before the next tile writes it
  }
  return base;
}

struct Geometry {
  int B, T, M, k, stride, num_windows, n_chunks, stages;
  int carry;  // the streamed form carries each chunk's sums to the next step
};

__host__ __device__ __forceinline__ long long up128(long long x) { return (x + 127) & ~127LL; }

__host__ __device__ __forceinline__ int list_cap(int M) { return M < LIST_CAP ? M : LIST_CAP; }

// the shared-memory layout of both forms, in bytes from the aligned base
struct Layout {
  long long bars, stage, cbuf, csum, vals, wrow, lists, masks, misc, zrow, sel, total;
  __host__ __device__ Layout(bool resident, bool carry, int M, int stride, int stages) {
    const long long n8 = (M + 7) / 8;
    long long o = 0;
    bars = o;  // full and empty of each stage, ready and done of each slot
    o += up128(8LL * (2 * stages + 2 * SLOTS));
    stage = o;
    o += resident ? 4LL * stages * M : 0;
    cbuf = o;  // a slot's chunk of bf16 frames
    o += resident ? 2LL * SLOTS * stride * M : 0;
    csum = o;  // the streamed form's carried chunk sums
    o += carry ? up128(4LL * M) : 0;
    vals = o;  // the streamed form's values at a frame group's listed columns
    o += resident ? 0 : Y_GROUPS * up128(2LL * list_cap(M));
    wrow = o;  // the window row's 8 n8 patterns, -1 past M
    o += up128(16 * n8);
    lists = o;  // a slot's list of covered columns
    o += SLOTS * up128(2LL * list_cap(M));
    masks = o;  // a slot's window mask, and zeros
    o += up128((SLOTS + 1) * n8);
    misc = o;  // non-finite flags and list lengths of the slots, warp totals
    o += 128;
    zrow = o;  // a row of zeros, the source of the output's bulk stores
    o += resident ? 4LL * M : 0;
    sel = o;  // team X's, then each frame group's
    o += (1 + Y_GROUPS) * static_cast<long long>(sizeof(Sel));
    total = o + 128;  // room to align the base
  }
};

// One block walks its range of (utterance, chunk) pairs stripe by stripe;
// its loaded chunks are numbered q = 0, 1, ... in order, and chunk q lives
// in slot q % SLOTS: its bf16 frames, the mask of its window (q, q + 1) and
// the list of the columns its frames are covered on.  Team X fills chunk
// q's slot once team Y has voted chunk q - SLOTS (done), and marks chunk q
// ready once its list is built, at the step of chunk q + 1 or at the
// stripe's last chunk; team Y votes each chunk when it is ready.
template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
window_vote_kernel(const float* __restrict__ acts, float* __restrict__ out, Geometry G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const Layout L(RESIDENT, G.carry, G.M, G.stride, G.stages);
  const int tid = threadIdx.x;
  const int M = G.M, T = G.T, S = G.stride, nw = G.num_windows, nc = G.n_chunks, k = G.k;
  const int n8 = (M + 7) / 8, n4 = M / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + G.stages;
  uint64_t* ready = empty + G.stages;
  uint64_t* done = ready + SLOTS;
  float* stages = reinterpret_cast<float*>(base + L.stage);
  uint4* cbuf = reinterpret_cast<uint4*>(base + L.cbuf);
  float* csum = reinterpret_cast<float*>(base + L.csum);
  uint16_t* vals = reinterpret_cast<uint16_t*>(base + L.vals);
  int16_t* wrow = reinterpret_cast<int16_t*>(base + L.wrow);
  uint16_t* lists = reinterpret_cast<uint16_t*>(base + L.lists);
  uint8_t* masks = base + L.masks;
  uint8_t* zeros = masks + SLOTS * n8;
  int* nonfinite = reinterpret_cast<int*>(base + L.misc);  // chunk q if it has an inf or NaN
  int* nlist = nonfinite + SLOTS;
  int* wtot = nlist + SLOTS;
  float* zrow = reinterpret_cast<float*>(base + L.zrow);
  Sel* sels = reinterpret_cast<Sel*>(base + L.sel);
  const int list_len = list_cap(M);
  const size_t chunk_len = static_cast<size_t>(S) * (M / 8);

  if (tid == CONSUMERS) {
    for (int i = 0; i < G.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], X_WARPS);
    }
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(&ready[i], 1);
      mbar_init(&done[i], 1);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < n8; i += THREADS) zeros[i] = 0;
  for (int c = M + tid; c < 8 * n8; c += THREADS) wrow[c] = -1;
  if (tid < SLOTS) nonfinite[tid] = -1;
  clear_sel(&sels[0], tid, THREADS);
  if (RESIDENT) {
    for (int i = tid; i < M; i += THREADS) zrow[i] = 0.f;
    fence_async_shared();
  }
  __syncthreads();

  const long long total = static_cast<long long>(G.B) * nc;
  const long long r0 = total * blockIdx.x / gridDim.x;
  const long long r1 = total * (blockIdx.x + 1) / gridDim.x;
  // stripe [c0, c1) of utterance u at r; advances r
  auto stripe = [&](long long& r, int& u, int& c0, int& c1) {
    u = static_cast<int>(r / nc);
    c0 = static_cast<int>(r % nc);
    c1 = static_cast<int>(r1 - r < nc - c0 ? c0 + (r1 - r) : nc);
    r += c1 - c0;
  };

  if (tid >= CONSUMERS) {  // the producer warp
    if (!RESIDENT || tid != CONSUMERS) return;
    uint32_t n = 0;
    for (long long r = r0; r < r1;) {
      int u, c0, c1;
      stripe(r, u, c0, c1);
      if (c0 > nw) continue;
      const int j0 = max(c0 - 1, 0), j1 = min(c1 + 1, nw + 1);
      const int t1 = min(j1 * S, T);
      for (int t = j0 * S; t < t1; ++t, ++n) {
        const int st = n % G.stages;
        if (n >= static_cast<uint32_t>(G.stages)) mbar_wait(&empty[st], ((n / G.stages) - 1) & 1);
        mbar_expect_tx(&full[st], M * 4);
        bulk_load(stages + static_cast<size_t>(st) * M,
                  acts + (static_cast<size_t>(u) * T + t) * M, M * 4, &full[st]);
      }
    }
    return;
  }

  const int lane = tid & 31;
  if (tid < X_THREADS) {  // team X
    Sel* sel = &sels[0];
    const uint4* wrow4 = reinterpret_cast<const uint4*>(wrow);
    float4 sum_cur[QMAX], sum_prev[QMAX];  // this thread's chunk sums (resident)
#pragma unroll
    for (int qq = 0; qq < QMAX; ++qq) sum_cur[qq] = sum_prev[qq] = make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t n = 0, q = 0;  // frames taken from the ring; chunks loaded
    for (long long r = r0; r < r1;) {
      int u, c0, c1;
      stripe(r, u, c0, c1);
      if (c0 > nw) continue;
      const float* a_u = acts + static_cast<size_t>(u) * T * M;
      const int j0 = max(c0 - 1, 0), j1 = min(c1 + 1, nw + 1);
      for (int j = j0; j < j1; ++j, ++q) {
        const bool window = j > j0;  // window j - 1 lies in this stripe
        const int nf = max(0, min(S, T - j * S));  // chunk j's frames below T
        const int slot = q % SLOTS, prev_slot = (q + SLOTS - 1) % SLOTS;
        if (q >= SLOTS) mbar_wait(&done[slot], (q / SLOTS - 1) & 1);  // chunk q - SLOTS voted

        // (A) chunk j: bf16 frames, chunk sums, window j - 1's sums and
        // pass 1 of its select (its Sel was cleared after the last select)
        auto window_out = [&](int i, float4 pv, float4 acc) {
          const uint2 w = window_sums(pv, acc);
          reinterpret_cast<uint2*>(wrow)[i] = w;
          count_hi(sel, static_cast<int>(w.x << 16) >> 16);
          count_hi(sel, static_cast<int>(w.x) >> 16);
          count_hi(sel, static_cast<int>(w.y << 16) >> 16);
          count_hi(sel, static_cast<int>(w.y) >> 16);
        };
        if (RESIDENT) {
          uint2* cb = reinterpret_cast<uint2*>(cbuf + slot * chunk_len);
          uint32_t odd = 0;  // nonzero: an inf or NaN among this thread's bf16 values
          // one frame's columns of this thread: cast, store, add in frame order
          auto cast = [&](const float4& x, int f, int i, float4& acc) {
            const uint2 b = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
            odd |= nonfinite2(b.x) | nonfinite2(b.y);
            cb[static_cast<size_t>(f) * n4 + i] = b;
            if (f == 0) acc = make_float4(0.f, 0.f, 0.f, 0.f);
            acc.x += __uint_as_float(b.x << 16);
            acc.y += __uint_as_float(b.x & 0xFFFF0000u);
            acc.z += __uint_as_float(b.y << 16);
            acc.w += __uint_as_float(b.y & 0xFFFF0000u);
          };
          for (int f = 0; f < nf; ++f, ++n) {
            const int st = n % G.stages;
            mbar_wait(&full[st], (n / G.stages) & 1);
            const float4* src = reinterpret_cast<const float4*>(stages) + static_cast<size_t>(st) * n4;
            const bool last = window && f == nf - 1;
            float4 x[QMAX];
#pragma unroll
            for (int qq = 0; qq < QMAX; ++qq)
              if (tid + qq * X_THREADS < n4) x[qq] = src[tid + qq * X_THREADS];
#pragma unroll
            for (int qq = 0; qq < QMAX; ++qq) {
              const int i = tid + qq * X_THREADS;
              if (i < n4) {
                cast(x[qq], f, i, sum_cur[qq]);
                if (last) window_out(i, sum_prev[qq], sum_cur[qq]);
              }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[st]);
          }
          if (odd) nonfinite[slot] = static_cast<int>(q);
          if (nf == 0) {  // a chunk of padding frames: its sum is zero
            const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int qq = 0; qq < QMAX; ++qq) {
              const int i = tid + qq * X_THREADS;
              sum_cur[qq] = zero;
              if (window && i < n4) window_out(i, sum_prev[qq], zero);
            }
          }
#pragma unroll
          for (int qq = 0; qq < QMAX; ++qq) sum_prev[qq] = sum_cur[qq];
        } else {
          // streamed: the sums of chunk j (and of chunk j - 1 where they are
          // not carried in shared memory from the last step) from their
          // frames in global memory, XCOLS columns a thread and XFRAMES
          // frames at a time, their loads issued together; window j - 1's
          // sums; and which of the chunks read hold an inf or NaN
          auto sums = [&](auto carry_flag) {
            constexpr bool CARRY = decltype(carry_flag)::value;
            const int first = CARRY ? j : j - 1;  // the first chunk read
            const float* a_r = a_u + static_cast<size_t>(first) * S * M;
            const int cnt = max(0, min(CARRY ? S : 2 * S, T - first * S));
            bool odd0 = false, odd1 = false;
            for (int c0 = tid; c0 < M; c0 += XCOLS * X_THREADS) {
              float sum0[XCOLS], sum1[XCOLS];  // chunks j - 1 and j
#pragma unroll
              for (int e = 0; e < XCOLS; ++e) sum0[e] = sum1[e] = 0.f;
              for (int f0 = 0; f0 < cnt; f0 += XFRAMES) {
                float v[XFRAMES][XCOLS];
#pragma unroll
                for (int fb = 0; fb < XFRAMES; ++fb)
#pragma unroll
                  for (int e = 0; e < XCOLS; ++e) {
                    const int c = c0 + e * X_THREADS;
                    v[fb][e] = f0 + fb < cnt && c < M
                                   ? __ldg(a_r + static_cast<size_t>(f0 + fb) * M + c) : 0.f;
                  }
#pragma unroll
                for (int fb = 0; fb < XFRAMES; ++fb) {
                  const int f = f0 + fb;
                  if (f < cnt) {
#pragma unroll
                    for (int e = 0; e < XCOLS; ++e) {  // in frame order, from 0.f
                      const float b = bf16_round(v[fb][e]);
                      if (!CARRY && f < S) {
                        odd0 |= !isfinite(b);
                        sum0[e] += b;
                      } else {
                        odd1 |= !isfinite(b);
                        sum1[e] += b;
                      }
                    }
                  }
                }
              }
#pragma unroll
              for (int e = 0; e < XCOLS; ++e) {
                const int c = c0 + e * X_THREADS;
                if (c < M) {
                  if (window) {
                    const int p = bf16_bits((CARRY ? csum[c] : sum0[e]) + sum1[e]);
                    wrow[c] = static_cast<int16_t>(p);
                    count_hi(sel, p);
                  }
                  if (CARRY) csum[c] = sum1[e];  // this thread's columns, read at the next step
                }
              }
            }
            if (odd0) nonfinite[prev_slot] = static_cast<int>(q - 1);
            if (odd1) nonfinite[slot] = static_cast<int>(q);
          };
          if (G.carry) sums(Flag<true>{});
          else if (window) sums(Flag<false>{});
        }

        // (B) window j - 1's lo and mask, and the list of chunk j - 1's
        // columns under a window (and chunk j's when it is the last
        // window's second chunk)
        if (window) {
          const int lo = finish_select(k, tid, X_THREADS, BAR_X, sel, [&](int hi) {
            for (int g = tid; g < n8; g += X_THREADS) {
              int p[8];
              unpack8(wrow4[g], p);
#pragma unroll
              for (int e = 0; e < 8; ++e) count_lo(sel, p[e], hi);
            }
          });
          // chunk j - 1 is covered by windows j - 2 and j - 1, chunk j = nw
          // by window j - 1 alone
          uint8_t* mask = masks + prev_slot * n8;
          const uint8_t* before = j - 1 > j0 ? masks + ((q + SLOTS - 2) % SLOTS) * n8 : zeros;
          const int len = compact([&](int g) {
            int p[8];
            unpack8(wrow4[g], p);
            uint32_t byte = 0;
#pragma unroll
            for (int e = 0; e < 8; ++e) byte |= static_cast<uint32_t>(p[e] >= lo) << e;
            mask[g] = static_cast<uint8_t>(byte);
            return byte | before[g];
          }, n8, lists + prev_slot * list_len, list_len, wtot, tid);
          if (tid == 0) nlist[prev_slot] = len;
          if (j == nw) {
            const int len_nw = compact([&](int g) { return static_cast<uint32_t>(mask[g]); }, n8,
                                       lists + slot * list_len, list_len, wtot, tid);
            if (tid == 0) nlist[slot] = len_nw;
          }
          clear_sel(sel, tid, X_THREADS);  // for the next window's pass 1
          bar_sync(BAR_X, X_THREADS);
          if (tid == 0) mbar_arrive(&ready[prev_slot]);
        } else {
          bar_sync(BAR_X, X_THREADS);  // the chunk's sums are whole before the next step's
        }
        if (j == j1 - 1 && tid == 0) mbar_arrive(&ready[slot]);
      }
    }
    return;
  }

  // team Y: each frame group votes its frames of each ready chunk.  In the
  // resident form a group first zeroes its output rows by bulk stores from
  // a row of zeros, then writes only the kept values of the listed
  // columns; the dense walk writes every column.
  const int ytid = tid - X_THREADS;
  const int group = ytid / GROUP_THREADS, gtid = ytid % GROUP_THREADS;
  const int bar = BAR_Y + 1 + group;
  Sel* gsel = &sels[1 + group];
  uint16_t* gval = vals + group * list_cap(M);
  // zero rows t0, t0 + 1, .. t1 - 1 of o_u that are this group's (every
  // Y_GROUPS-th from `first`)
  auto zero_rows = [&](float* o_u, int t0, int t1, int first) {
    if (RESIDENT && gtid == 0) {
      for (int t = t0 + first; t < t1; t += Y_GROUPS)
        bulk_store(o_u + static_cast<size_t>(t) * M, zrow, M * 4);
      bulk_commit();
    }
  };
  uint32_t q = 0;
  for (long long r = r0; r < r1;) {
    int u, c0, c1;
    stripe(r, u, c0, c1);
    const float* a_u = acts + static_cast<size_t>(u) * T * M;
    float* o_u = out + static_cast<size_t>(u) * T * M;
    if (c0 <= nw) {
      const int j0 = max(c0 - 1, 0), j1 = min(c1 + 1, nw + 1);
      for (int j = j0; j < j1; ++j, ++q) {
        const int slot = q % SLOTS;
        const int nf = j >= c0 && j < c1 ? max(0, min(S, T - j * S)) : 0;
        zero_rows(o_u, j * S, j * S + nf, group);
        mbar_wait(&ready[slot], (q / SLOTS) & 1);
        FrameRow<RESIDENT> row;
        // windows j - 1 and j: slots q - 1 and q, where they exist
        row.m0 = j > j0 ? masks + ((q + SLOTS - 1) % SLOTS) * n8 : zeros;
        row.m1 = j < nw ? masks + slot * n8 : zeros;
        row.M = M;
        const int nl = nlist[slot];
        const bool dense = nonfinite[slot] == static_cast<int>(q) || nl > list_len;
        const uint16_t* list = lists + slot * list_len;
        for (int f = group; f < nf; f += Y_GROUPS) {
          const int t = j * S + f;
          row.a_s = cbuf + slot * chunk_len + static_cast<size_t>(f) * (M / 8);
          row.a_g = a_u + static_cast<size_t>(t) * M;
          // the vote pattern at list entry i; the streamed form reads the
          // frame's value from global memory on the first pass and keeps it
          // in gval (entry i is this thread's on every pass)
          bool first_pass = true;
          auto listed_value = [&](int i, int c) {
            if (RESIDENT) return row.value(c);
            if (first_pass) {
              const float a = row.value(c);
              gval[i] = static_cast<uint16_t>(__float_as_uint(a) >> 16);
              return a;
            }
            return __uint_as_float(static_cast<uint32_t>(gval[i]) << 16);
          };
          auto listed_pattern = [&](int i) {
            const int c = list[i];
            return bf16_bits(listed_value(i, c) * static_cast<float>(row.cover(c)));
          };
          auto each = [&](auto&& fn) {
            if (dense) {
              for (int g = gtid; g < n8; g += GROUP_THREADS) {
                float a[8];
                int p[8];
                row.get8(g, a, p);
#pragma unroll
                for (int e = 0; e < 8; ++e) fn(p[e]);
              }
            } else {
              for (int i = gtid; i < nl; i += GROUP_THREADS) fn(listed_pattern(i));
            }
          };
          float* o = o_u + static_cast<size_t>(t) * M;
          // the streamed form's sparse walk writes the row's zeros first;
          // the select's barriers order them before the kept values
          if (!RESIDENT && !dense)
            for (int c = gtid; c < M; c += GROUP_THREADS) o[c] = 0.f;
          clear_sel(gsel, gtid, GROUP_THREADS);
          bar_sync(bar, GROUP_THREADS);
          each([&](int p) { count_hi(gsel, p); });
          first_pass = false;
          const int keep = max(1, finish_select(k, gtid, GROUP_THREADS, bar, gsel, [&](int hi) {
                                 each([&](int p) { count_lo(gsel, p, hi); });
                               }));
          if (RESIDENT) {  // the row's bulk-stored zeros land before its values
            if (gtid == 0) bulk_wait_all();
            bar_sync(bar, GROUP_THREADS);
          }
          if (!dense) {
            for (int i = gtid; i < nl; i += GROUP_THREADS)
              if (listed_pattern(i) >= keep) o[list[i]] = listed_value(i, list[i]);
            continue;
          }
          for (int g = gtid; g < n8; g += GROUP_THREADS) {
            float a[8], v[8];
            int p[8];
            row.get8(g, a, p);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = p[e] >= keep ? a[e] : 0.f;
            if (RESIDENT) {
              reinterpret_cast<float4*>(o)[2 * g] = make_float4(v[0], v[1], v[2], v[3]);
              reinterpret_cast<float4*>(o)[2 * g + 1] = make_float4(v[4], v[5], v[6], v[7]);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e)
                if (8 * g + e < M) o[8 * g + e] = v[e];
            }
          }
        }
        bar_sync(BAR_Y, Y_THREADS);  // every group is done with the slot
        if (ytid == 0) mbar_arrive(&done[slot]);
      }
    }

    // frames after the last window's: zeros
    const int tz0 = max(c0, nw + 1) * S, tz1 = min(c1 * S, T);
    if (RESIDENT) {
      zero_rows(o_u, tz0, tz1, group);
    } else {
      for (int t = tz0; t < tz1; ++t)
        for (int c = ytid; c < M; c += Y_THREADS) o_u[static_cast<size_t>(t) * M + c] = 0.f;
    }
  }
  if (RESIDENT && gtid == 0) bulk_wait_all();  // the zero row is read to the end
}

}  // namespace

// acts [B, T, M] fp32 post-ReLU and out [B, T, M] fp32, contiguous and
// 16-byte aligned; stride = window / 2 >= 1, num_windows >= 1, n_chunks =
// num_windows + 1 or + 2, 1 <= k <= M, M * 4 <= 227 KB, B, T >= 1.
extern "C" int window_vote_launch(const void* acts, void* out, int B, int T, int M, int k,
                                  int stride, int num_windows, int n_chunks, void* stream) {
  static bool smem_set[2][MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n_sms = dev < MAX_DEVICES ? sms[dev] : 0;
  if (n_sms == 0) {
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sms[dev] = n_sms;
  }
  // the resident form (M % 8 == 0, M <= 4 * QMAX * X_THREADS): as many
  // stages as fit beside the rest and their barriers, at least two
  int stages = 0;
  if (M % 8 == 0 && M / 4 <= QMAX * X_THREADS && 2LL * SLOTS * stride * M < SMEM_LIMIT) {
    const long long fit = (SMEM_LIMIT - Layout(true, false, M, stride, 0).total - 128) / (4LL * M);
    stages = static_cast<int>(fit < 2 ? 0 : fit < MAX_STAGES ? fit : MAX_STAGES);
  }
  const bool resident = stages > 0;
  // the streamed form carries the chunk sums where they fit (M below
  // about 25,700), else reads both chunks of each window
  const bool carry = !resident && Layout(false, true, M, stride, 0).total <= SMEM_LIMIT;
  const Geometry g{B, T, M, k, stride, num_windows, n_chunks, stages, carry ? 1 : 0};
  const int smem = static_cast<int>(Layout(resident, carry, M, stride, stages).total);
  const long long chunks = static_cast<long long>(B) * n_chunks;
  const int grid = static_cast<int>(chunks < n_sms ? chunks : n_sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acts);
  float* o = static_cast<float*>(out);
  if (resident) {
    err = allow_smem(window_vote_kernel<true>, SMEM_LIMIT, smem_set[0]);
    if (err != cudaSuccess) return err;
    window_vote_kernel<true><<<grid, THREADS, smem, s>>>(a, o, g);
  } else {
    err = allow_smem(window_vote_kernel<false>, SMEM_LIMIT, smem_set[1]);
    if (err != cudaSuccess) return err;
    window_vote_kernel<false><<<grid, THREADS, smem, s>>>(a, o, g);
  }
  return cudaGetLastError();
}
