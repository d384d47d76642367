// The AsyncFedED burst drain's two sweeps over B stacked arrivals, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/fedagg/fedagg.py::
// fedagg_norms_batched (_norms_batched_kernel) and ::fedagg_apply_batched
// (_apply_batched_kernel), and their int8 twins ::fedagg_norms_batched_q
// (_norms_batched_q_kernel) and ::fedagg_apply_batched_q
// (_apply_batched_q_kernel). Both are templates on the delta loader of
// fedagg_common.cuh, instantiated for f32, bf16 and int8 (per-1024 scaled)
// deltas. An int8 delta reads 1 byte per element where an f32 one reads 4,
// so its byte counts below drop from 4B to B (plus a scale per 1024).
//
// norms_batched: for x_t (n,), stales xs (B, n) and deltas D (B, n) it emits,
// with s_b = x_t - xs_b,
//   dist[b] = <s_b, s_b>, dn[b] = <D_b, D_b>, cross[b][k] = <s_b, D_k>,
//   gram[k][l] = <D_k, D_l>.
// It reads 4(B+1) + 4B bytes per element (4(B+1) + 2B with a bf16 delta)
// and does 3B^2 + 4B flops on them (fedagg.py::norms_batched_work): 3.3
// flop/byte at B = 8, 8.9 at B = 23, under the H100's f32 ridge of 20
// (67 TFLOP/s over 3.35 TB/s), so device memory bounds it; at the paper's
// lengths, where the inputs sit in L2, the dots' shared-memory reads and
// the latency of a short pipeline set the time (PERF.md).
//
// The design is a tall, skinny split-K product. cross and gram are one
// contraction, [S; D] D^T, a (2B x B) output over K = n (S holds the B
// drifts); dist is diag(S S^T) on top. The output is cut into panels of at
// most 64 x 64 (one panel up to B = 32); a block computes one panel over a
// contiguous K-range, and the grid, (K-ranges, panels), is set by (n, B)
// alone. In a block:
//   - Stages of kt4 float4 columns of the panel's rows (the drifts' and the
//     deltas' rows; the column rows are among them where the panel's rows
//     hold them) sit in shared memory, double-buffered. Each thread owns
//     fixed (row, column) pairs of a stage and copies them with cp.async:
//     x_stale and f32 deltas straight into their rows, bf16 and int8 deltas
//     as their raw bytes (and scales). The next stage's copies are in
//     flight, holding no register, while the tiles compute on the current
//     one; then each thread turns its pairs into x_t - x_stale and widened
//     deltas in place.
//   - Each thread owns a 4 x 4 register tile of the panel (rows rt + i RT,
//     columns ct + j CT: neighbouring threads read neighbouring rows, whose
//     16-byte reads fall in different banks with the one-float4 row pad)
//     and accumulates it over the float4 columns of its thread group: 2
//     fused multiply-adds per 32-bit shared-memory load, the 16 sums
//     interleaved. Up to 16 thread groups split each stage's columns when a
//     panel has fewer tiles than the block has threads (three at B = 23).
//     A stage's sums are added to the range's once per stage, so no chain
//     of rounded adds is longer than a stage's columns or the range's
//     stages. No shuffle and no shared-memory accumulator per stage.
//   - The threads that turn the drifts into x_t - x_stale add up dist.
//   - At the end the groups' tiles are added in a fixed pairwise tree
//     (shuffles where partners share a warp, else shared memory) and the
//     dist sums a warp per row, and the block writes its K-range's
//     partials: the product column by column, so neighbouring lanes store
//     to neighbouring addresses, then dist.
// A second launch, programmatic-dependent on the first, folds the partials
// in a fixed order: 32 neighbouring entries per block, 16 warps each
// summing a 16th of the K-ranges in order, then the 16 sums in order;
// dn is gram's diagonal and gram's lower half the mirror of its upper.
// No float atomics and a grid set by (n, B): the result is the same to the
// bit on every run. No tensor cores and no TF32: the contractions stay in
// f32, as the schedule needs.
//
// apply_batched: out = x_t + sum_b eta_b D_b. It reads x_t and the B deltas
// once and writes the new vector, 4(B + 2) bytes per f32 element (2B + 8
// with bf16 deltas, B + 8 and a scale per 1024 with int8 ones), for 2B
// flops (3B with int8; fedagg.py::apply_batched_work): device memory bounds
// it at model lengths; at the paper's lengths the inputs sit in L2 and the
// launch and the loads' latency set the time (PERF.md). A thread owns one
// slice of every row. It issues x_t's load, then every row load of a
// register chunk (8 rows of 16 bytes, 16 of 8, 32 of 4; 8 rows for B <= 8)
// before it sums them, and the next chunk's loads before that sum, so it
// waits about one round trip per chunk, not one per row. Blocks of 64
// threads; the grid is set by (n, B) and the delta form: 16 bytes of a row
// a thread where that still gives 528 blocks (4 per SM, the model-scale
// lengths), else one float4 group (16 bytes of f32, 8 of bf16, 4 of int8)
// or, for int8 bursts of at most 16, 8 bytes: fewer, wider threads pay
// while each dequantizes few values.
// An int8 byte becomes its float by a byte permute and a subtract (exact,
// no conversion instruction), and a block reads its B etas and B scales
// once into shared memory. Every element sums in the plain version's order,
// every multiply and add rounded on its own (acc = eta_0 D_0, acc = acc +
// eta_b D_b for b = 1..B-1, out = x_t + acc; an int8 value's q s rounded
// first), so the two agree to the bit whatever the grid. It writes a new
// vector: the ring GMIS keeps every past one.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include "fedagg_common.cuh"

namespace fedagg {
namespace {

constexpr int kMaxB = 128;          // largest burst either kernel takes
constexpr int kWarps = kThreads / 32;
constexpr int kGridBlocks = 264;    // two blocks per SM of an H100
constexpr int kPanel = 64;          // output rows and columns of a panel
constexpr int kStage4 = 1024;       // float4 groups of one stage (16 KB)
constexpr int kItems = kStage4 / kThreads;  // staged groups per thread
constexpr int kMaxKT4 = 128;        // float4 columns of a stage at most
constexpr int kMaxGroups = 16;      // thread groups splitting a stage
constexpr int kMaxRawBytes = 8;     // raw bytes of a delta's float4 group
constexpr int kFoldWarps = 16;      // warps of a fold block
constexpr int kApplyThreads = 64;   // threads of an apply block
constexpr int kApplyChunkBytes = 128;  // raw bytes a thread holds per chunk
constexpr int kApplyShortRows = 8;     // rows per chunk for B <= 8
constexpr int kApplyWideBlocks = 528;  // 16-byte rows from 4 blocks per SM
constexpr int kApplyMaxProducts = 128;  // int8 values a narrow thread widens

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int row_panels(int b) {
  return (2 * b + kPanel - 1) / kPanel;
}
__host__ __device__ inline int panels(int b) {
  return row_panels(b) * ((b + kPanel - 1) / kPanel);
}

// Panel y of the (2B x B) output: rows [ra, ra + r) of [S; D] against
// columns [ca, ca + c) of D, and how a block stages and tiles it.
struct Panel {
  int ra, r, ca, c;
  int rt, ct;     // 4 x 4 tiles down and across
  int groups;     // thread groups splitting a stage's columns
  int staged;     // rows copied per stage: the r rows, and the c column
                  // rows where the r rows do not hold them
  int colbase;    // shared-memory row of column 0
  int rows;       // shared-memory rows, the padding the tiles read included
  int kt4;        // float4 columns per stage, a power of two in [8, 128]
  int lkt4;       // log2(kt4)
  // one stage buffer, in float4s: the f32 rows (kt4 + 1 apart), x_t's
  // columns, the raw delta groups of the staged rows (kMaxRawBytes each)
  // and their int8 scales
  int xcol, rawcol, scalecol, size;
};

__host__ __device__ inline Panel panel_of(int b, int y) {
  Panel p;
  const int rp = row_panels(b);
  p.ra = (y % rp) * kPanel;
  p.ca = (y / rp) * kPanel;
  p.r = imin(kPanel, 2 * b - p.ra);
  p.c = imin(kPanel, b - p.ca);
  p.rt = (p.r + 3) / 4;
  p.ct = (p.c + 3) / 4;
  p.groups = imin(kMaxGroups, kThreads / (p.rt * p.ct));
  const int cb = b + p.ca - p.ra;  // column 0 among the panel's rows
  const bool held = cb >= 0 && cb + p.c <= p.r;
  p.staged = held ? p.r : p.r + p.c;
  p.colbase = held ? cb : 4 * p.rt;
  p.rows = imax(4 * p.rt, p.colbase + 4 * p.ct);
  p.kt4 = kMaxKT4;
  p.lkt4 = 7;
  for (; p.kt4 * p.staged > kStage4; p.kt4 >>= 1) --p.lkt4;
  p.xcol = p.rows * (p.kt4 + 1);
  p.rawcol = p.xcol + p.kt4;
  p.scalecol = p.rawcol + p.staged * p.kt4 * kMaxRawBytes / 16;
  p.size = p.scalecol + (p.staged + 3) / 4;
  return p;
}

// A K-range's partials: the (2B x B) product column by column (row r of
// [S; D] and column c of D at c * 2B + r, so a warp's neighbouring rows
// store to neighbouring addresses), then dist.
__host__ __device__ inline int partial_len(int b) { return 2 * b * b + b; }

// K-ranges: set by (n, B) alone; every range of every panel holds at least
// one stage.
int grid_k(int64_t n, int b) {
  int kt4 = 0;
  for (int y = 0; y < panels(b); ++y) kt4 = imax(kt4, panel_of(b, y).kt4);
  const int64_t stages = n / (4 * kt4);
  const int g = imax(1, kGridBlocks / panels(b));
  return (int)(g < stages ? g : stages);
}

size_t norms_smem_bytes(int b) {
  size_t most = 0;
  for (int y = 0; y < panels(b); ++y) {
    const Panel p = panel_of(b, y);
    const size_t stages = 2 * sizeof(float4) * p.size;
    const size_t fold = sizeof(float) *
        ((size_t)(p.groups + 1) / 2 * 16 * p.rt * p.ct + (size_t)p.r * p.kt4);
    if (stages > most) most = stages;
    if (fold > most) most = fold;
  }
  return most;
}

// Lets the fold, launched after this kernel on the stream, start
// (programmatic dependent launch): its blocks are then resident, waiting,
// when the partials end.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Waits until the kernel before this one on the stream has ended and its
// writes are visible.
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Copies of 16, 8 or 4 bytes from device memory to shared memory that leave
// no register busy; cp_wait() waits for this thread's.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One staged bf16 or int8 delta group (and its int8 scale) in f32.
template <typename L>
__device__ __forceinline__ float4 widen_staged(const void* raw, float scale) {
  if constexpr (L::kRawBytes == 8)
    return L::widen(*reinterpret_cast<const uint2*>(raw));
  else
    return L::widen(*reinterpret_cast<const char4*>(raw), scale);
}

// The fold, its own launch, programmatic-dependent on the tiles: block i
// takes partial entries [32 i, 32 i + 32), lane l entry 32 i + l; warp w
// of 16 sums the K-ranges [w gk / 16, (w + 1) gk / 16) in order, so each
// load of a warp reads 32 neighbouring floats, and warp 0 adds the 16
// warps' sums in order (16 warps measured faster than 8, PERF.md). Each
// entry's sum goes to the outputs it gives: a cross term; a Gram term
// k <= l to gram[k][l], gram[l][k] and, for k = l, dn[k] (so dn is gram's
// diagonal and gram symmetric, to the bit); a dist. The product's entries
// below gram's diagonal are dropped.
__global__ void __launch_bounds__(kFoldWarps * 32)
norms_batched_fold(const float* __restrict__ partial, int gk, int b,
                   float* __restrict__ out) {
  __shared__ float sums[kFoldWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int len = partial_len(b), e = blockIdx.x * 32 + lane;
  const int k0 = w * gk / kFoldWarps, k1 = (w + 1) * gk / kFoldWarps;
  wait_prerequisites();
  float s = 0.0f;
  if (e < len) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) s += partial[(int64_t)k * len + e];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || e >= len) return;
  for (int v = 1; v < kFoldWarps; ++v) s += sums[v][lane];
  const int r = e % (2 * b), c = e / (2 * b);
  if (e >= 2 * b * b) {
    out[e - 2 * b * b] = s;  // dist
  } else if (r < b) {
    out[2 * b + r * b + c] = s;  // cross[r][c]
  } else if (r - b <= c) {
    const int k = r - b;
    out[2 * b + b * b + k * b + c] = s;
    out[2 * b + b * b + c * b + k] = s;
    if (k == c) out[b + k] = s;
  }
}

// Block (k, y): panel y over K-range k; writes the panel's entries of
// K-range k's partials (and dist for its drift rows when it holds column
// 0).
template <typename L>
__global__ void __launch_bounds__(kThreads, 2)
norms_batched_tiles(const float* __restrict__ xt,
                    const float* __restrict__ xs, L d, int b, int64_t n,
                    float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  launch_dependents();
  const Panel p = panel_of(b, blockIdx.y);
  const int t = threadIdx.x, stride4 = p.kt4 + 1;
  const int tiles = p.rt * p.ct;
  const bool drifts = p.ra < b;  // the panel's rows start with drifts
  const bool dist_here = drifts && p.ca == 0;

  // staged (row, column) pairs of this thread: column k4, slots
  // slot0 + j * step; slot s is row p.ra + s of [S; D] for s < r, else
  // row b + ca + (s - r); shared-memory row s, else colbase + (s - r).
  // Rows the tiles read past them hold what they hold: the outputs they
  // feed are dropped.
  const int k4 = t & (p.kt4 - 1), slot0 = t >> p.lkt4;
  const int step = kThreads >> p.lkt4;
  float dacc[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) dacc[j] = 0.0f;

  // copies of stage st into the buffer at float4 `to`: the drifts' rows as
  // x_stale (and, by the threads of slot 0, x_t's columns), the deltas' as
  // their raw bytes, f32 ones straight into their rows
  auto issue = [&](int64_t st, int to) {
    const int64_t g4 = st * p.kt4 + k4;
    if (drifts && slot0 == 0)
      cp_async<16>(smem4 + to + p.xcol + k4, xt + 4 * g4);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = slot0 + j * step;
      if (s < p.staged) {
        const int row = s < p.r ? p.ra + s : b + p.ca + (s - p.r);
        const int m = s < p.r ? s : p.colbase + (s - p.r);
        float4* const dst = smem4 + to + m * stride4 + k4;
        if (row < b) {
          cp_async<16>(dst, xs + row * n + 4 * g4);
        } else {
          const L dr = d.row(row - b, n);
          if constexpr (L::kRawBytes == 16) {
            cp_async<16>(dst, dr.raw(g4));
          } else {
            char* const raw = reinterpret_cast<char*>(smem4 + to + p.rawcol);
            float* const scales =
                reinterpret_cast<float*>(smem4 + to + p.scalecol);
            cp_async<L::kRawBytes>(raw + (s * p.kt4 + k4) * kMaxRawBytes,
                                   dr.raw(g4));
            if constexpr (L::kRawBytes == 4) {
              if (k4 == 0) cp_async<4>(scales + s, dr.scale(g4));
            }
          }
        }
      }
    }
    cp_commit();
  };
  // after the copies of the buffer at `to` have landed: the drifts
  // x_t - x_stale in place (and their squares into dist), the deltas
  // widened into their rows
  auto convert = [&](int to) {
    const float4 x = drifts ? smem4[to + p.xcol + k4]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = slot0 + j * step;
      if (s < p.staged) {
        const int row = s < p.r ? p.ra + s : b + p.ca + (s - p.r);
        const int m = s < p.r ? s : p.colbase + (s - p.r);
        float4* const dst = smem4 + to + m * stride4 + k4;
        if (row < b) {
          const float4 o = *dst;
          const float4 v =
              make_float4(x.x - o.x, x.y - o.y, x.z - o.z, x.w - o.w);
          *dst = v;
          if (dist_here)
            dacc[j] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
        } else if constexpr (L::kRawBytes != 16) {
          const char* raw = reinterpret_cast<const char*>(smem4 + to +
                                                          p.rawcol);
          *dst = widen_staged<L>(
              raw + (s * p.kt4 + k4) * kMaxRawBytes,
              reinterpret_cast<const float*>(smem4 + to + p.scalecol)[s]);
        }
      }
    }
  };

  const int g = t / tiles, tt = t % tiles;
  const int rt = tt % p.rt, ct = tt / p.rt;
  const bool computes = g < p.groups;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int64_t nst = n / (4 * p.kt4);
  const int64_t s0 = nst * blockIdx.x / gridDim.x;
  const int64_t s1 = nst * (blockIdx.x + 1) / gridDim.x;
  // iteration st copies stage st + 1 into one buffer while the tiles
  // compute stage st from the other (the first iteration only copies)
  for (int64_t st = s0 - 1; st < s1; ++st) {
    const int nxt = ((st + 1 - s0) & 1) * p.size, cur = p.size - nxt;
    const bool more = st + 1 < s1;
    if (more) issue(st + 1, nxt);
    if (computes && st >= s0) {
      // the stage's sums, added to the range's once per stage: no chain of
      // rounded adds longer than a stage's columns or the range's stages
      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
      for (int c4 = g; c4 < p.kt4; c4 += p.groups) {
        float4 a[4], e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = smem4[cur + (rt + i * p.rt) * stride4 + c4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          e[j] = smem4[cur + (p.colbase + ct + j * p.ct) * stride4 + c4];
        // each sum takes x, y, z, w in turn; the 16 sums interleave
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(a[i].x, e[j].x, sacc[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(a[i].y, e[j].y, sacc[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(a[i].z, e[j].z, sacc[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(a[i].w, e[j].w, sacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sacc[i][j];
    }
    if (more) {
      cp_wait();
      __syncthreads();  // every thread's copies of the stage have landed
      convert(nxt);
    }
    __syncthreads();
  }

  // the groups' tiles, added pairwise in a fixed tree (group g takes group
  // g + h in the round of half-width h = 2^l): by a shuffle where the two
  // share a warp, else through shared memory; then the dist sums
  float* const red = reinterpret_cast<float*>(smem4);
  for (int l = 0; (1 << l) < p.groups; ++l) {
    const int h = 1 << l, pair = g >> (l + 1);
    const bool take =
        computes && (g & (2 * h - 1)) == 0 && g + h < p.groups;
    if (32 % tiles == 0 && h * tiles < 32) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float v =
            __shfl_down_sync(0xffffffffu, acc[e / 4][e % 4], h * tiles);
        if (take) acc[e / 4][e % 4] += v;
      }
      continue;
    }
    const int slots = (p.groups + 2 * h - 1) >> (l + 1);
    if (computes && (g & (2 * h - 1)) == h) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        red[(e * slots + pair) * tiles + tt] = acc[e / 4][e % 4];
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        acc[e / 4][e % 4] += red[(e * slots + pair) * tiles + tt];
    }
    __syncthreads();
  }
  float* const dred = red;
  if (dist_here) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = slot0 + j * step;
      if (s < p.r && p.ra + s < b) dred[s * p.kt4 + k4] = dacc[j];
    }
  }
  __syncthreads();
  float* const part = partial + (int64_t)blockIdx.x * partial_len(b);
  if (computes && g == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt + i * p.rt;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = ct + j * p.ct;
        if (r < p.r && c < p.c)
          part[(p.ca + c) * 2 * b + p.ra + r] = acc[i][j];
      }
    }
  }
  if (dist_here) {
    const int lane = t & 31;
    for (int s = t >> 5; s < p.r && p.ra + s < b; s += kWarps) {
      float v = 0.0f;
      for (int c4 = lane; c4 < p.kt4; c4 += 32) v += dred[s * p.kt4 + c4];
      v = warp_sum(v);
      if (lane == 0) part[2 * b * b + p.ra + s] = v;
    }
  }
}

// Loads kBytes (16, 8 or 4) raw bytes at p into 32-bit words, in one load.
template <int kBytes>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (kBytes == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
    static_assert(kBytes == 4, "a thread loads 16, 8 or 4 bytes a row");
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// A thread's slice of kChunk delta rows in registers: kBytes raw bytes of
// each, as 32-bit words.
template <typename L, int kBytes, int kChunk>
struct ApplyRows {
  uint32_t w[kChunk][kBytes / 4];

  // rows r0 .. r0 + kChunk - 1 (those below b) at this thread's byte offset
  __device__ __forceinline__ void load(const L& d, int r0, int b, int64_t n,
                                       int64_t t) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (r0 + j < b)
        load_words<kBytes>(
            static_cast<const char*>(d.row(r0 + j, n).raw(0)) + t * kBytes,
            w[j]);
    }
  }
};

// out = x_t + sum_b eta_b D_b. Thread t of the grid owns kBytes raw bytes
// of each delta row (kBytes / kRawBytes float4 groups): it loads its x_t
// first, then the rows in register chunks of kChunk, the next chunk's loads
// issued before the current chunk's chain. An int8 block's elements lie in
// one scale block, so the block stages the B etas and, for the int8 form,
// the B scales of its block in shared memory. Per element the chain is the
// plain version's: acc = -0 + eta_0 D_0 (an exact eta_0 D_0: adding -0
// changes no float), acc = acc + eta_b D_b for b = 1..B-1, out = x_t + acc,
// every multiply and add rounded on its own.
template <typename L, int kBytes, int kChunk>
__global__ void __launch_bounds__(kApplyThreads)
apply_batched(const float* __restrict__ xt, L d,
              const float* __restrict__ etas, int b, int64_t n,
              float* __restrict__ out) {
  constexpr int kGroups = kBytes / L::kRawBytes;
  constexpr int kWords = L::kRawBytes / 4;
  static_assert(L::kElemBytes != 1 || kApplyThreads * kBytes <= kQBlock,
                "an int8 block spans one scale block");
  __shared__ float se[kMaxB], ss[kMaxB];
  // thread t of the grid; t0 is the first of its block
  const int64_t t0 = (int64_t)blockIdx.x * kApplyThreads, t = t0 + threadIdx.x;
  const int64_t g0 = t * kGroups;  // first float4 group of this thread
  float4 x[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) x[k] = load_f32(xt, g0 + k);
  ApplyRows<L, kBytes, kChunk> cur;
  cur.load(d, 0, b, n, t);
  for (int r = threadIdx.x; r < b; r += kApplyThreads) {
    se[r] = __ldg(etas + r);
    if constexpr (L::kElemBytes == 1)
      ss[r] = __ldg(d.row(r, n).scale(t0 * kGroups));
  }
  __syncthreads();
  float4 acc[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k)
    acc[k] = make_float4(-0.0f, -0.0f, -0.0f, -0.0f);
  for (int c = 0; c < b; c += kChunk) {
    ApplyRows<L, kBytes, kChunk> nxt;
    if (c + kChunk < b) nxt.load(d, c + kChunk, b, n, t);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c + j < b) {
        const float e = se[c + j];
        const float s = L::kElemBytes == 1 ? ss[c + j] : 0.0f;
#pragma unroll
        for (int k = 0; k < kGroups; ++k) {
          const float4 v = L::widen_words(cur.w[j] + k * kWords, s);
          acc[k].x = __fadd_rn(acc[k].x, __fmul_rn(e, v.x));
          acc[k].y = __fadd_rn(acc[k].y, __fmul_rn(e, v.y));
          acc[k].z = __fadd_rn(acc[k].z, __fmul_rn(e, v.z));
          acc[k].w = __fadd_rn(acc[k].w, __fmul_rn(e, v.w));
        }
      }
    }
    cur = nxt;
  }
  float4* const o = reinterpret_cast<float4*>(out) + g0;
#pragma unroll
  for (int k = 0; k < kGroups; ++k)
    o[k] = make_float4(
        __fadd_rn(x[k].x, acc[k].x), __fadd_rn(x[k].y, acc[k].y),
        __fadd_rn(x[k].z, acc[k].z), __fadd_rn(x[k].w, acc[k].w));
}

template <typename L>
int launch_norms_batched(const float* xt, const float* xs, L d, int b,
                         int64_t n, float* partial, float* out,
                         cudaStream_t stream) {
  if (b < 1 || b > kMaxB) return (int)cudaErrorInvalidValue;
  const int gk = grid_k(n, b);
  norms_batched_tiles<L><<<dim3(gk, panels(b)), kThreads,
                           norms_smem_bytes(b), stream>>>(xt, xs, d, b, n,
                                                          partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((partial_len(b) + 31) / 32);
  cfg.blockDim = dim3(kFoldWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, norms_batched_fold, (const float*)partial, gk,
                         b, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One thread per kBytes of a delta row (n is a multiple of 65,536, so the
// grid covers it exactly), in chunks of kApplyChunkBytes of raw rows, or of
// kApplyShortRows rows for a burst no longer than that.
template <int kBytes, typename L>
int launch_apply_width(const float* xt, L d, const float* etas, int b,
                       int64_t n, float* out, cudaStream_t stream) {
  constexpr int kRows = kApplyChunkBytes / kBytes;
  const int64_t per_block = (int64_t)kApplyThreads * kBytes / L::kElemBytes;
  if (b < 1 || b > kMaxB || n % per_block != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(n / per_block);
  if constexpr (kRows > kApplyShortRows) {
    if (b <= kApplyShortRows) {
      apply_batched<L, kBytes, kApplyShortRows>
          <<<grid, kApplyThreads, 0, stream>>>(xt, d, etas, b, n, out);
      return (int)cudaGetLastError();
    }
  }
  apply_batched<L, kBytes, kRows><<<grid, kApplyThreads, 0, stream>>>(
      xt, d, etas, b, n, out);
  return (int)cudaGetLastError();
}

// The row bytes a thread owns, set by (n, B) and the delta form: 16 where
// that still gives the grid kApplyWideBlocks blocks; below that, one float4
// group (16 bytes of f32, 8 of bf16, 4 of int8), or 8 bytes of int8 while a
// thread dequantizes no more than kApplyMaxProducts values (B <= 16).
template <typename L>
int launch_apply_batched(const float* xt, L d, const float* etas, int b,
                         int64_t n, float* out, cudaStream_t stream) {
  if (n * L::kElemBytes / (16 * kApplyThreads) >= kApplyWideBlocks)
    return launch_apply_width<16>(xt, d, etas, b, n, out, stream);
  if constexpr (L::kElemBytes == 1) {
    if (8 * b <= kApplyMaxProducts)
      return launch_apply_width<8>(xt, d, etas, b, n, out, stream);
  }
  return launch_apply_width<L::kRawBytes>(xt, d, etas, b, n, out, stream);
}

}  // namespace
}  // namespace fedagg

using namespace fedagg;

extern "C" {

// Lets the norms kernel use the shared memory of its largest panel (about
// 70 KB, past the 48 KB default). Called once, when the library is loaded,
// so that no launch makes this call (a launch may be captured in a CUDA
// graph).
int fedagg_batched_init(void) {
  size_t most = 0;
  for (int b = 1; b <= kMaxB; ++b)
    most = norms_smem_bytes(b) > most ? norms_smem_bytes(b) : most;
  cudaError_t err = cudaFuncSetAttribute(
      norms_batched_tiles<F32Delta>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(norms_batched_tiles<BF16Delta>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(norms_batched_tiles<I8Delta>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
  return (int)err;
}

// Largest B the batched kernels take.
int fedagg_batched_max_b(void) { return kMaxB; }

// Floats of partials the norms-batched scratch must hold for (n, B): one
// per product entry and dist, per K-range.
int64_t fedagg_norms_batched_scratch(int64_t n, int b) {
  return (int64_t)grid_k(n, b) * partial_len(b);
}

// n is a multiple of 65536, 1 <= B <= kMaxB, and every pointer is 16-byte
// aligned (the wrapper checks all three). out holds 2B + 2B^2 floats.
int fedagg_norms_batched_f32(const void* xt, const void* xs, const void* d,
                             int b, int64_t n, void* partial, void* out,
                             void* stream) {
  return launch_norms_batched((const float*)xt, (const float*)xs,
                              F32Delta{(const float*)d}, b, n,
                              (float*)partial, (float*)out,
                              (cudaStream_t)stream);
}

int fedagg_norms_batched_bf16(const void* xt, const void* xs, const void* d,
                              int b, int64_t n, void* partial, void* out,
                              void* stream) {
  return launch_norms_batched((const float*)xt, (const float*)xs,
                              BF16Delta{(const uint16_t*)d}, b, n,
                              (float*)partial, (float*)out,
                              (cudaStream_t)stream);
}

// The int8 wire form: q (B, n) int8 and s (B, n / 1024) f32 scales.
int fedagg_norms_batched_int8(const void* xt, const void* xs, const void* q,
                              const void* s, int b, int64_t n, void* partial,
                              void* out, void* stream) {
  return launch_norms_batched((const float*)xt, (const float*)xs,
                              I8Delta{(const int8_t*)q, (const float*)s}, b,
                              n, (float*)partial, (float*)out,
                              (cudaStream_t)stream);
}

int fedagg_apply_batched_f32(const void* xt, const void* d, const void* etas,
                             int b, int64_t n, void* out, void* stream) {
  return launch_apply_batched(
      (const float*)xt, F32Delta{(const float*)d}, (const float*)etas, b, n,
      (float*)out, (cudaStream_t)stream);
}

int fedagg_apply_batched_bf16(const void* xt, const void* d, const void* etas,
                              int b, int64_t n, void* out, void* stream) {
  return launch_apply_batched(
      (const float*)xt, BF16Delta{(const uint16_t*)d}, (const float*)etas, b,
      n, (float*)out, (cudaStream_t)stream);
}

int fedagg_apply_batched_int8(const void* xt, const void* q, const void* s,
                              const void* etas, int b, int64_t n, void* out,
                              void* stream) {
  return launch_apply_batched(
      (const float*)xt, I8Delta{(const int8_t*)q, (const float*)s},
      (const float*)etas, b, n, (float*)out, (cudaStream_t)stream);
}

}  // extern "C"
