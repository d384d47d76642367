// Decode attention over a ring-buffer KV cache, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/swa_attn/swa_attn.py::
// swa_decode_attention (_swa_decode_kernel): one query token per sequence
// attends over a cache (B, S, KV, D) whose slots at or past valid_len[b] are
// masked, with an optional tanh softcap, and query head h reads kv head
// h / (H / KV) (GQA, and MQA: any number of query heads per kv head).
//
// Bound: device memory. The valid slots of K and V are read once (2 * valid
// * KV * D elements per sequence) for 4 flops per element and query head
// sharing it. At the RecurrentGemma-2B serve shape (B 4, S 2048, KV 1, D
// 256, H 10, f32) that is 16.8 MB and 84 MFLOP: 5.0 us of bytes against
// 1.3 us of f32 arithmetic. To reach the byte rate, an SM must keep tens of
// KB of loads in flight.
//
// Design. The cache is cut along S into pieces of `split` slots, one block
// per (piece, b, kv head). The caller picks `split` (a power of two, 8..64)
// from S and the SM count so that the grid fills the card: 64-slot pieces
// and 128 blocks at S = 2048, 8-slot pieces at S = 48.
//
//  1. Every byte requested up front: a block reads valid_len[b] and exits
//     at once if its piece lies wholly at or past it (the merge never reads
//     it). Otherwise its first group of queries (step 2) and the valid K
//     rows of its piece, then the
//     valid V rows, go to shared memory as cp.async copies of 16 bytes (8
//     bytes for bf16 rows that are not a multiple of 16 bytes) in two commit
//     groups, issued before any arithmetic: 128 KB per block at the serve
//     shape. Rows are padded in shared memory so that neighbouring slots
//     fall in other banks.
//  2. The rep = H / KV query heads of the block's kv head go in groups of
//     at most kHeadGroup (16): steps 2-4 run once per group while the
//     piece stays in shared memory, so K and V are read from device memory
//     once per (piece, b, kv head) whatever rep is (granite-34b: 48 heads
//     on one kv head, three groups). A later group's queries are copied
//     over the earlier group's once every thread is done with them.
//     Scores once K has landed, as a small product held in registers: a
//     tile of 4 slots x 4 query heads (16 sums) is shared by up to 32 lanes,
//     each taking every dp-th float4 of D, so each K and q element read from
//     shared memory serves four products, and one shuffle tree per tile
//     (log2 dp steps over 16 independent sums) finishes the dots: no thread
//     waits on a chain of warp reductions.
//  3. Softmax of the piece: 16 lanes per query head, the group's heads at
//     once.
//  4. P.V once V has landed: thread t owns a float4 of output columns and
//     four heads, reading one V float4 and the four heads' p (one float4)
//     per slot.
//  5. A second launch merges the live pieces of each (b, h), started as a
//     programmatic dependent of the first so that its blocks wait resident:
//     one expf per piece, not per column, its first loads issued together,
//     and four groups of threads each summing a quarter of the pieces, added
//     in a fixed order. No atomics: the same bits on every run.
//
// Masked slots are skipped. With at least one valid slot their weight in the
// plain version, exp(-1e30 - m), is exactly 0, so skipping them is the same
// function. With valid_len <= 0 every slot scores -1e30 and the softmax is
// uniform over the S slots, as in the plain version: K is not used.
//
// Two designs. f32 inputs take the one above (swa_partial, swa_merge),
// written for the serve path's batch of 4 and its 2048-slot ring, where the
// card needs many small pieces to fill it. It stays so because f32 has no
// tensor-core route here: the port keeps TF32 off, and the batch-4 serve
// path keeps its bits and its times.
//
// bf16 inputs take the second design, swa_tc, written for decode at large
// batch (the step programs' decode_32k: 128 sequences, 2048 to 32,768 slots,
// 1 to 8 kv heads of 10 to 48 query heads). Its bound is the same: bytes,
// the valid slots of K and V read once, 2 * valid * KV * D * 2 bytes per
// sequence (2.15 GB at granite-34b's 128 x 32,768 slots x 1 kv head x D 128:
// 0.64 ms at 3.35 TB/s). There B * KV pairs alone nearly fill the card, and
// the work per slot is a small matrix product (up to 48 query heads on one
// K row), not a dot product. So:
//
//  1. Few splits. One block per (b, kv head, split of S, group of heads);
//     the caller picks the splits (tc_plan in swa_attn.py): 1 at
//     decode_32k, whose 128 or 1024 pairs about fill the card, 16 at
//     long_500k's batch 1. A block loops over tiles of 64 slots (128 where
//     a block has several m-tiles). With one split it normalises and writes
//     the output itself; with more, its partial (m, l, acc) goes to scratch
//     and swa_merge folds them as above.
//  2. A ring of 2 to 4 stages of K and V tiles in shared memory, filled by
//     cp.async (16 bytes a copy; 8 where a row is not a multiple of 16
//     bytes) by every warp of the block while earlier tiles are scored.
//     Rows past valid_len or past S are zero-filled, not read. A block has
//     at least 8 warps: with rep <= 16, four of them only copy (measured:
//     fewer warps keep too few copies in flight to stream at the rate the
//     bound assumes).
//  3. Scores on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out): the
//     rep = H / KV query heads are the M rows, 16 per m-tile (rep = 10 and 4
//     padded, rep = 48 three m-tiles over the same K tile), slots the N
//     side, D the k dimension zero-padded to a multiple of 16. Four warps
//     share an m-tile, each taking 16 slots of every tile; a product of two
//     bf16 values is exact in f32, so only the order of the sums differs
//     from the plain version.
//  4. An online softmax in registers per warp (f32 m and l per head row;
//     the scale, the softcap and the mask on the f32 scores before the
//     max), then P.V on the tensor cores from the same registers, P split
//     into hi = bf16(p) and lo = bf16(p - hi), two products into one f32
//     accumulator: P keeps about 16 bits, so the result is the plain
//     version's f32 function up to the order of the sums.
//  5. The four warps of an m-tile fold their partials through shared memory
//     in a fixed order. No atomics anywhere: the same bits on every call.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace swa {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinSplit = 8;    // cache slots per block, at least
constexpr int kMaxSplit = 64;   // and at most
constexpr int kHeadGroup = 16;  // query heads scored per pass over a piece
constexpr int kMaxD = 256;      // head dim
constexpr int kSpStride = kHeadGroup + 4;  // floats per slot of scores
constexpr int kMergeThreads = 256;
constexpr int kMergeParts = kMergeThreads / (kMaxD / 4);  // pieces in parallel
constexpr int kMergePrefetch = 8;  // pieces per part loaded before the wait

// Elements 4c .. 4c+3 of a row in shared memory, as f32.
__device__ __forceinline__ float4 row4(const float* row, int c) {
  return reinterpret_cast<const float4*>(row)[c];
}
__device__ __forceinline__ float4 row4(const __nv_bfloat16* row, int c) {
  const uint2 u = reinterpret_cast<const uint2*>(row)[c];
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Asynchronous copy of kBytes (16 or 8) from device to shared memory.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's commit groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// rows rows of row_bytes each, from src (rows src_stride bytes apart) to
// dst (dst_stride apart), in kBytes copies: a warp per row, a lane per copy.
template <int kBytes>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride,
                                          const unsigned char* src,
                                          size_t src_stride, int rows,
                                          int row_bytes) {
  const int per_row = row_bytes / kBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps)
    for (int c = lane; c < per_row; c += 32)
      copy_async<kBytes>(dst + r * dst_stride + c * kBytes,
                         src + r * src_stride + (size_t)c * kBytes);
}

// bytes contiguous bytes from src to dst, in kBytes copies.
template <int kBytes>
__device__ __forceinline__ void copy_span(unsigned char* dst,
                                          const unsigned char* src,
                                          int bytes) {
  for (int i = threadIdx.x; i < bytes / kBytes; i += kThreads)
    copy_async<kBytes>(dst + i * kBytes, src + (size_t)i * kBytes);
}

// Bytes between two cached rows in shared memory: the row padded by 8 to 23
// bytes to a multiple of 16, so that slot j + 1 starts in other banks than
// slot j and every row stays 16-byte aligned.
__host__ __device__ __forceinline__ int smem_stride(int row_bytes) {
  return (row_bytes + 8 + 15) / 16 * 16;
}

// Bytes of one group of queries (at most kHeadGroup heads of the rep that
// share a kv head), padded to a multiple of 16.
__host__ __device__ __forceinline__ int query_bytes(int rep, int D,
                                                   int esize) {
  return ((rep < kHeadGroup ? rep : kHeadGroup) * D * esize + 15) / 16 * 16;
}

// Dynamic shared memory of one partial block: K and V pieces, one group of
// queries and its scores (one row of kSpStride floats per slot).
__host__ __device__ __forceinline__ int partial_smem(int split, int D,
                                                    int rep, int esize) {
  return 2 * split * smem_stride(D * esize) + query_bytes(rep, D, esize) +
         4 * split * kSpStride;
}

// Lets the kernel launched after this one on the stream start (programmatic
// dependent launch): the merge's blocks are then resident, waiting, when the
// partials end.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Waits until the kernel before this one on the stream has ended and its
// writes are visible.
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x += p * v.x;
  acc.y += p * v.y;
  acc.z += p * v.z;
  acc.w += p * v.w;
}

// Partial (m, l, acc) of one piece of split slots for the rep query heads
// of one (b, kv head), kHeadGroup heads at a time. Partials are laid out
// [b][h][piece] (acc: [.][D]).
template <typename T, int kCopy>
__global__ void __launch_bounds__(kThreads)
swa_partial(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ valid_len,
            int H, int S, int KV, int D, int split, float scale,
            float softcap, int npieces, float* __restrict__ pacc,
            float* __restrict__ pm, float* __restrict__ pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  launch_dependents();
  const int piece = blockIdx.x, b = blockIdx.y, kvh = blockIdx.z;
  const int rep = H / KV, D4 = D / 4;
  const int row_bytes = D * (int)sizeof(T);
  const int stride = smem_stride(row_bytes);
  const int s0 = piece * split;
  unsigned char* sk = smem;
  unsigned char* sv = smem + split * stride;
  unsigned char* sqb = sv + split * stride;
  const T* sq = reinterpret_cast<const T*>(sqb);
  float* sp = reinterpret_cast<float*>(sqb + query_bytes(rep, D, sizeof(T)));

  // 1. valid_len first: a piece wholly at or past it exits before it
  // copies anything, and a live piece copies only its valid rows (K not at
  // all when every slot is masked). Then every copy is issued before any
  // arithmetic: the queries and K in the first group, V in the second.
  const int vl = valid_len[b];
  const bool none = vl <= 0;             // every slot masked: uniform
  const int nvalid = none ? S : min(vl, S);
  if (s0 >= nvalid) return;              // wholly masked: never merged
  const int ns = min(split, nvalid - s0);
  const size_t src_stride = (size_t)KV * row_bytes;
  const size_t off = (((size_t)b * S + s0) * KV + kvh) * (size_t)row_bytes;
  const unsigned char* qsrc = reinterpret_cast<const unsigned char*>(
      q + ((size_t)b * H + (size_t)kvh * rep) * D);
  copy_span<kCopy>(sqb, qsrc, min(rep, kHeadGroup) * row_bytes);
  if (!none)
    copy_rows<kCopy>(sk, stride, reinterpret_cast<const unsigned char*>(k) +
                     off, src_stride, ns, row_bytes);
  commit_copies();
  copy_rows<kCopy>(sv, stride, reinterpret_cast<const unsigned char*>(v) +
                   off, src_stride, ns, row_bytes);
  commit_copies();
  wait_copies<1>();                      // this thread's queries and K
  __syncthreads();                       // everyone's

  for (int g0 = 0; g0 < rep; g0 += kHeadGroup) {
    const int grp = min(kHeadGroup, rep - g0);
    const size_t head0 = (size_t)b * H + (size_t)kvh * rep + g0;
    if (g0) {
      // every thread is done with the last group's queries and scores
      __syncthreads();
      copy_span<kCopy>(sqb, qsrc + (size_t)g0 * row_bytes, grp * row_bytes);
      commit_copies();
      wait_copies<0>();
      __syncthreads();
    }

    // 2. scores. A tile of 4 slots x 4 heads is shared by dp lanes, each
    // taking every dp-th float4 of D; the dp partial dots are summed by a
    // shuffle tree, and the tile's first lane writes the 16 scores.
    {
      const int nj = (ns + 3) / 4, ng = (grp + 3) / 4, nt = nj * ng;
      int dp = 1;
      while (dp < 32 && 2 * dp <= D4 && 2 * dp * nt <= kThreads) dp *= 2;
      const int tile = threadIdx.x / dp, lane = threadIdx.x % dp;
      const int jt = tile % nj, gt = tile / nj;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
      if (tile < nt && !none) {
        const T* kr[4];
        const T* qr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kr[i] = reinterpret_cast<const T*>(
              sk + min(4 * jt + i, ns - 1) * stride);
          qr[i] = sq + min(4 * gt + i, grp - 1) * D;
        }
#pragma unroll 2
        for (int c = lane; c < D4; c += dp) {
          float4 kk[4], qq[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kk[i] = row4(kr[i], c);
            qq[i] = row4(qr[i], c);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[i][u] += dot4(qq[u], kk[i]);
        }
      }
      for (int o = dp >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[i][u] += __shfl_xor_sync(0xffffffffu, acc[i][u], o);
      if (lane == 0 && tile < nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 4 * jt + i, g = 4 * gt + u;
            if (j < ns && g < grp) {
              float sc = -1e30f;
              if (!none) {
                sc = acc[i][u] * scale;
                if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
              }
              sp[j * kSpStride + g] = sc;
            }
          }
      }
    }
    __syncthreads();

    // per query head (16 lanes each, the group's heads at once), the
    // piece's max and sum of exp; p in place
    {
      const int g = threadIdx.x >> 4, lane = threadIdx.x & 15;
      const bool mine = g < grp;
      float m = -1e30f;
      if (mine)
        for (int j = lane; j < ns; j += 16)
          m = fmaxf(m, sp[j * kSpStride + g]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.0f;
      if (mine)
        for (int j = lane; j < ns; j += 16) {
          const float p = expf(sp[j * kSpStride + g] - m);
          sp[j * kSpStride + g] = p;
          l += p;
        }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (mine && lane == 0) {
        const size_t i = (head0 + g) * npieces + piece;
        pm[i] = m;
        pl[i] = l;
      }
    }
    wait_copies<0>();                    // this thread's V copies
    __syncthreads();

    // 3. acc[g][4c..4c+3] = sum_j p[g][j] v[j][4c..4c+3], j in order:
    // thread t owns column group c = t % D4 and heads 4 (t / D4) .. + 3,
    // reading the four p of a slot as one float4
    const int ng = (grp + 3) / 4;
    if (threadIdx.x < ng * D4) {
      const int c = threadIdx.x % D4, gt = threadIdx.x / D4;
      float4 acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int j = 0; j < ns; ++j) {
        const float4 vv =
            row4(reinterpret_cast<const T*>(sv + j * stride), c);
        const float4 p = row4(sp + j * kSpStride + 4 * gt, 0);
        fma4(acc[0], p.x, vv);
        fma4(acc[1], p.y, vv);
        fma4(acc[2], p.z, vv);
        fma4(acc[3], p.w, vv);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = 4 * gt + u;
        if (g < grp)
          store4(pacc + ((head0 + g) * npieces + piece) * D + 4 * c, acc[u]);
      }
    }
  }
}

// One block per (b, h): merges the live pieces. Thread t weighs piece t of
// each chunk of kMergeThreads pieces, owns output columns 4c .. 4c+3 (c = t % 64)
// and sums the pieces of its part (t / 64: the pieces i with i % 4 ==
// part); the four parts are added in part order. The order is fixed, so
// the bits repeat. Launched as a programmatic dependent of the partials, it
// reads valid_len before it waits for them, and then issues the loads of
// its first pieces all at once.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
swa_merge(const float* __restrict__ pacc, const float* __restrict__ pm,
          const float* __restrict__ pl, const int* __restrict__ valid_len,
          int H, int S, int D, int split, int npieces, T* __restrict__ out) {
  __shared__ float sw[kMergeThreads], swl[kMergeThreads];
  __shared__ float smax[kMergeThreads / 32];
  __shared__ float4 spart[kMergeParts][kMaxD / 4];
  const int bh = blockIdx.x, b = bh / H, t = threadIdx.x;
  const int vl = valid_len[b];
  const int nvalid = vl <= 0 ? S : min(vl, S);
  const int live = (nvalid + split - 1) / split;
  const float* m = pm + (size_t)bh * npieces;
  const float* l = pl + (size_t)bh * npieces;
  const float* a = pacc + (size_t)bh * npieces * D;
  const int D4 = D / 4, c = t % (kMaxD / 4), part = t / (kMaxD / 4);
  wait_prerequisites();

  float mi = -1e30f, li = 0.0f;
  if (t < live) {
    mi = m[t];
    li = l[t];
  }
  float4 pre[kMergePrefetch];
#pragma unroll
  for (int u = 0; u < kMergePrefetch; ++u) {
    const int i = part + kMergeParts * u;
    pre[u] = c < D4 && i < live ? row4(a + (size_t)i * D, c)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float mx = mi;
  for (int i = t + kMergeThreads; i < live; i += kMergeThreads)
    mx = fmaxf(mx, m[i]);
  mx = warp_max(mx);
  if ((t & 31) == 0) smax[t >> 5] = mx;
  __syncthreads();
  mx = smax[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, smax[w]);

  float den = 0.0f;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = 0; base < live; base += kMergeThreads) {
    const int n = min(kMergeThreads, live - base), i = base + t;
    float w = 0.0f, wl = 0.0f;
    if (i < live) {
      w = expf((base ? m[i] : mi) - mx);
      wl = (base ? l[i] : li) * w;
    }
    sw[t] = w;
    swl[t] = wl;
    __syncthreads();
    for (int j = 0; j < n; ++j) den += swl[j];
    if (c < D4) {
      int j = part;
      if (base == 0) {
#pragma unroll
        for (int u = 0; u < kMergePrefetch; ++u, j += kMergeParts)
          if (j < n) fma4(acc, sw[j], pre[u]);
      }
      for (; j < n; j += kMergeParts)
        fma4(acc, sw[j], row4(a + (size_t)(base + j) * D, c));
    }
    __syncthreads();
  }
  spart[part][c] = acc;
  __syncthreads();
  if (part == 0 && c < D4) {
#pragma unroll
    for (int p = 1; p < kMergeParts; ++p) {
      const float4 x = spart[p][c];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store4(out + (size_t)bh * D + 4 * c,
           make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den));
  }
}

// ---- The bf16 design: tensor-core scoring, few splits (swa_tc) ----

constexpr int kTcGrain = 64;      // a split is a whole number of these slots
constexpr int kTcLanes = 4;       // warps per m-tile, each on its own slots
constexpr int kTcMinMG = 2;       // m-tiles' warps a block has at least
constexpr int kTcMaxStages = 4;
constexpr int kTcMinStages = 2;
constexpr int kTcSmemMax = 232448;  // dynamic shared memory a block may take

// kKS = k-steps of 16 over the padded head dim. Blocks hold up to kMG
// m-tiles of 16 query heads (fewer where D is large, to keep the registers
// of a block's accumulators in the SM's file); the queries stay in
// registers for the whole loop where D <= 128. A warp takes kWS groups of
// 16 slots of every tile of kTile slots: 2 where blocks of several m-tiles
// are short of tensor issue rather than bytes (tc_ws), else 1.
template <int kKS, int kWS>
struct TcShape {
  static constexpr int kDp = 16 * kKS;
  static constexpr int kMG = kKS > 12 ? 2 : 3;
  static constexpr int kMaxThreads = 32 * kTcLanes * kMG;
  static constexpr bool kQReg = kKS <= 8;
  static constexpr int kTile = kTcLanes * 16 * kWS;
};

// Groups of 16 slots a warp takes per tile for a block of mg m-tiles at
// kKS k-steps: two (fewer barriers, rescales and loop steps per slot) where
// the block has several m-tiles and its registers allow.
constexpr int tc_ws(int kKS, int mg) { return kKS <= 8 && mg > 1 ? 2 : 1; }

// Bytes between two rows (slots or query heads) in shared memory: the padded
// head dim plus 16, so that the 8 rows an ldmatrix reads fall in 8 different
// groups of 4 banks.
__host__ __device__ __forceinline__ int tc_row_bytes(int Dp) {
  return 2 * Dp + 16;
}

// Floats between two rows of a warp's partial output in shared memory.
__host__ __device__ __forceinline__ int tc_out_stride(int Dp) {
  return Dp + 8;
}

// Dynamic shared memory of the fold after the loop: every warp's partial
// output (16 x Dp), its (m, l) per row, then per head row the four lanes'
// weights, the max and the sum.
__host__ __device__ __forceinline__ int tc_fold_bytes(int warps, int mg,
                                                     int Dp) {
  return 4 * (warps * 16 * tc_out_stride(Dp) + warps * 16 * 2 +
              mg * 16 * (kTcLanes + 2));
}

// cp.async of kBytes (16 or 8) that reads src_bytes (kBytes or 0) from src
// and zero-fills the rest.
template <int kBytes>
__device__ __forceinline__ void copy_async_fill(void* dst, const void* src,
                                                int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void wait_copies_upto(int pending) {
  if (pending >= 2)
    wait_copies<2>();
  else if (pending == 1)
    wait_copies<1>();
  else
    wait_copies<0>();
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of row
// i % 8 of matrix i / 8. kTrans hands each thread a column pair instead.
template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
// Registers only, so not volatile: the compiler may interleave products.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as a bf16 pair hi and the pair of what hi leaves out, lo.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Rows [0, tile) of a K tile and of a V tile, from kg and vg (slot 0 of the
// tile; slots src_stride bytes apart) into st (K rows, then V rows, rs bytes
// apart), in kBytes copies spread over the block. Rows at or past rows_valid
// are zero-filled.
template <int kBytes>
__device__ __forceinline__ void tc_load_tile(unsigned char* st,
                                             const unsigned char* kg,
                                             const unsigned char* vg,
                                             size_t src_stride, int row_bytes,
                                             int rs, int tile,
                                             int rows_valid) {
  const int cpr = row_bytes / kBytes, total = 2 * tile * cpr;
  const int nt = blockDim.x, dr = nt / cpr, dc = nt - dr * cpr;
  int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
  for (int i = threadIdx.x; i < total; i += nt) {
    const bool isv = r >= tile;
    const int row = isv ? r - tile : r;
    const bool ok = row < rows_valid;
    const unsigned char* base = isv ? vg : kg;
    copy_async_fill<kBytes>(
        st + (isv ? tile * rs : 0) + row * rs + c * kBytes,
        ok ? base + (size_t)row * src_stride + c * kBytes : base,
        ok ? kBytes : 0);
    c += dc;
    r += dr;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

// One block per (b, kv head) x split x head group: the slots
// [split * chunk, split * chunk + chunk) of the pair's cache, for up to
// kMG m-tiles of its rep query heads. Warp w takes m-tile w / kTcLanes and,
// of every tile, the 16 kWS slots from 16 kWS (w % kTcLanes). Scores and
// the running max are kept in base 2 (times log2 e), so that each weight
// is one exp2. With nsplit == 1 it writes out; otherwise (m, l, acc) per
// head to scratch (m in base e), laid out as swa_partial's ([b][h][split])
// for swa_merge.
template <int kKS, int kWS>
__global__ void __launch_bounds__(TcShape<kKS, kWS>::kMaxThreads)
swa_tc(const __nv_bfloat16* __restrict__ q,
       const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v,
       const int* __restrict__ valid_len, int H, int S, int KV, int D,
       int chunk, int nsplit, int stages, float scale, float softcap,
       float* __restrict__ pacc, float* __restrict__ pm,
       float* __restrict__ pl, __nv_bfloat16* __restrict__ out) {
  using Shape = TcShape<kKS, kWS>;
  constexpr int kDp = Shape::kDp, kTile = Shape::kTile;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kSlots = 16 * kWS;       // a warp's slots of a tile
  constexpr int kAcc = kWS == 1 ? 2 : 1;  // score sums kept apart
  extern __shared__ __align__(16) unsigned char smem[];
  launch_dependents();
  const int pair = blockIdx.x, b = pair / KV, kvh = pair - b * KV;
  const int split = blockIdx.y;
  const int rep = H / KV, hb = blockIdx.z * Shape::kMG * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5, mg = nwarps / kTcLanes;
  const int mi = warp / kTcLanes, ls = warp - mi * kTcLanes;
  const int t = lane & 3;

  const int vl = valid_len[b];
  const bool none = vl <= 0;             // every slot masked: uniform
  const int nvalid = none ? S : min(vl, S);
  const int s0 = split * chunk;
  if (s0 >= nvalid) return;              // wholly masked: never merged
  const int ns = min(chunk, nvalid - s0);
  const int ntiles = (ns + kTile - 1) / kTile;

  const int rs = tc_row_bytes(kDp);
  const int row_bytes = D * 2;
  unsigned char* sq = smem;
  unsigned char* ring = smem + mg * 16 * rs;
  const int stage_bytes = 2 * kTile * rs;

  const size_t src_stride = (size_t)KV * row_bytes;
  const size_t off = (((size_t)b * S + s0) * KV + kvh) * (size_t)row_bytes;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k) + off;
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v) + off;
  const bool copy16 = row_bytes % 16 == 0;
  auto load = [&](int tile) {
    unsigned char* st = ring + (tile % stages) * stage_bytes;
    const size_t o = (size_t)tile * kTile * src_stride;
    const int rows = min(kTile, ns - tile * kTile);
    if (copy16)
      tc_load_tile<16>(st, kg + o, vg + o, src_stride, row_bytes, rs, kTile,
                       rows);
    else
      tc_load_tile<8>(st, kg + o, vg + o, src_stride, row_bytes, rs, kTile,
                      rows);
  };
  for (int i = 0; i < stages - 1; ++i) {
    if (i < ntiles) load(i);
    commit_copies();
  }
  // while the first tiles are in flight: the block's query heads,
  // zero-padded to its m-tiles and to kDp columns
  for (int i = threadIdx.x; i < mg * 16 * kDp; i += blockDim.x) {
    const int r = i / kDp, c = i - r * kDp, hh = hb + r;
    __nv_bfloat16 x = __float2bfloat16(0.0f);
    if (hh < rep && c < D)
      x = q[((size_t)b * H + (size_t)kvh * rep + hh) * D + c];
    *reinterpret_cast<__nv_bfloat16*>(sq + r * rs + 2 * c) = x;
  }
  // columns D .. kDp of every ring row: never copied, so zeroed once
  if (D < kDp) {
    const int pad = kDp - D, rows = stages * 2 * kTile;
    for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
      const int r = i / pad, c = D + (i - r * pad);
      *reinterpret_cast<__nv_bfloat16*>(ring + r * rs + 2 * c) =
          __float2bfloat16(0.0f);
    }
  }
  __syncthreads();                       // the queries and the zeroed pads

  // this lane's ldmatrix rows: query row / slot / V slot and column offset
  const int qrow = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int krow = kSlots * ls + (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
  const int vrow = kSlots * ls + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;
  const unsigned char* qp = sq + qrow * rs + 2 * ((lane >> 4) * 8);
  const bool live = hb + mi * 16 < rep;  // an m-tile with a real head

  uint32_t qa[Shape::kQReg ? kKS : 1][4];
  if constexpr (Shape::kQReg) {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) ldsm4<false>(qa[ks], qp + 32 * ks);
  }

  float o[2 * kKS][4];
#pragma unroll
  for (int n = 0; n < 2 * kKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int tile = 0; tile < ntiles; ++tile) {
    wait_copies_upto(stages - 2);        // this thread's copies of the tile
    __syncthreads();                     // everyone's; the oldest stage free
    if (tile + stages - 1 < ntiles) load(tile + stages - 1);
    commit_copies();
    const int tv = min(kTile, ns - tile * kTile);
    if (!live || kSlots * ls >= tv) continue;
    const unsigned char* sk = ring + (tile % stages) * stage_bytes;
    const unsigned char* sv = sk + kTile * rs;

    // scores of 16 heads x kSlots slots (n-tiles of 8); with one group of
    // 16 slots, even and odd k-steps are summed apart
    float sc[kAcc][2 * kWS][4];
#pragma unroll
    for (int p = 0; p < kAcc; ++p)
#pragma unroll
      for (int n = 0; n < 2 * kWS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[p][n][e] = 0.0f;
    const unsigned char* kp = sk + krow * rs + 2 * kcol;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t a[4];
      if constexpr (Shape::kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
      } else {
        ldsm4<false>(a, qp + 32 * ks);
      }
#pragma unroll
      for (int j = 0; j < kWS; ++j) {
        uint32_t kb[4];
        ldsm4<false>(kb, kp + 16 * j * rs + 32 * ks);
        mma_bf16(sc[ks % kAcc][2 * j], a, kb[0], kb[1]);
        mma_bf16(sc[ks % kAcc][2 * j + 1], a, kb[2], kb[3]);
      }
    }

    // scale, softcap, mask; the online softmax of rows g and g + 8
    float s[2 * kWS][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * kWS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = 0.0f;
        if (!none) {
          x = sc[0][n][e];
#pragma unroll
          for (int p = 1; p < kAcc; ++p) x += sc[p][n][e];
          x *= scale;
          if (softcap != 0.0f) x = tanhf(x / softcap) * softcap;
          x *= kLog2e;
        }
        const int j = kSlots * ls + 8 * n + 2 * t + (e & 1);
        s[n][e] = j < tv ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], ref[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      ref[r] = mn == -INFINITY ? 0.0f : mn;
      alpha[r] = exp2f(m[r] - ref[r]);
      m[r] = mn;
    }
    // a max that moved rescales the sums (times 1 elsewhere: skipped, the
    // same bits)
    if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
      l[0] *= alpha[0];
      l[1] *= alpha[1];
#pragma unroll
      for (int n = 0; n < 2 * kKS; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    uint32_t ph[kWS][4], plo[kWS][4];
#pragma unroll
    for (int n = 0; n < 2 * kWS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[n][e] - ref[e >> 1]);
        l[e >> 1] += p[e];
      }
      split_bf16(p[0], p[1], ph[n >> 1][2 * (n & 1)], plo[n >> 1][2 * (n & 1)]);
      split_bf16(p[2], p[3], ph[n >> 1][2 * (n & 1) + 1],
                 plo[n >> 1][2 * (n & 1) + 1]);
    }

    // P.V: 16 heads x kDp columns += (hi + lo) 16 x kSlots slots . V
#pragma unroll
    for (int j = 0; j < kWS; ++j) {
      const unsigned char* vp = sv + (vrow + 16 * j) * rs + 2 * vcol;
#pragma unroll
      for (int np = 0; np < kKS; ++np) {
        uint32_t vb[4];
        ldsm4<true>(vb, vp + 32 * np);
        mma_bf16(o[2 * np], ph[j], vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], ph[j], vb[2], vb[3]);
        mma_bf16(o[2 * np], plo[j], vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], plo[j], vb[2], vb[3]);
      }
    }
  }

  // fold the kTcLanes warps of each m-tile, in lane order, for the rows of
  // real heads only (warps of an m-tile past rep write nothing)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  wait_copies<0>();
  __syncthreads();                       // the ring is free
  const int g = lane >> 2, ostr = tc_out_stride(kDp);
  const int nrows = min(mg * 16, rep - hb);
  float* so = reinterpret_cast<float*>(ring);
  float* sml = so + nwarps * 16 * ostr;
  float* sw = sml + nwarps * 16 * 2;
  if (live) {
    float* mine = so + warp * 16 * ostr;
#pragma unroll
    for (int n = 0; n < 2 * kKS; ++n) {
      *reinterpret_cast<float2*>(mine + g * ostr + 8 * n + 2 * t) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * ostr + 8 * n + 2 * t) =
          make_float2(o[n][2], o[n][3]);
    }
    if (t == 0) {
      float* ml = sml + warp * 32;
      ml[2 * g] = m[0];
      ml[2 * g + 1] = l[0];
      ml[2 * (g + 8)] = m[1];
      ml[2 * (g + 8) + 1] = l[1];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int mt = r / 16, row = r - mt * 16;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcLanes; ++w)
      mm = fmaxf(mm, sml[(mt * kTcLanes + w) * 32 + 2 * row]);
    float den = 0.0f;
#pragma unroll
    for (int w = 0; w < kTcLanes; ++w) {
      const float* ml = sml + (mt * kTcLanes + w) * 32 + 2 * row;
      const float e = mm == -INFINITY ? 0.0f : exp2f(ml[0] - mm);
      sw[r * (kTcLanes + 2) + w] = e;
      den += e * ml[1];
    }
    sw[r * (kTcLanes + 2) + kTcLanes] = mm;
    sw[r * (kTcLanes + 2) + kTcLanes + 1] = den;
  }
  __syncthreads();
  // four columns a thread: float4 reads of the partials, 8- or 16-byte
  // stores
  constexpr int kC4 = kDp / 4;
  for (int i = threadIdx.x; i < nrows * kC4; i += blockDim.x) {
    const int r = i / kC4, c = 4 * (i - r * kC4);
    if (c >= D) continue;
    const int mt = r / 16, row = r - mt * 16;
    const float* wr = sw + r * (kTcLanes + 2);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < kTcLanes; ++w)
      fma4(acc, wr[w],
           row4(so + ((mt * kTcLanes + w) * 16 + row) * ostr + c, 0));
    const size_t bh = (size_t)b * H + (size_t)kvh * rep + hb + r;
    if (nsplit == 1) {
      const float den = wr[kTcLanes + 1];
      store4(out + bh * D + c, make_float4(acc.x / den, acc.y / den,
                                           acc.z / den, acc.w / den));
    } else {
      const size_t pi = bh * nsplit + split;
      store4(pacc + pi * D + c, acc);
      if (c == 0) {
        pm[pi] = wr[kTcLanes] * 0.6931471805599453f;  // base e
        pl[pi] = wr[kTcLanes + 1];
      }
    }
  }
}

// The ring's stages for a block of mg m-tiles at head dim Dp and tiles of
// `tile` slots: as many as fit (at most kTcMaxStages) beside the queries; 0
// when not even kTcMinStages do.
int tc_stages(int Dp, int mg, int tile) {
  const int rs = tc_row_bytes(Dp), stage = 2 * tile * rs;
  const int qbytes = mg * 16 * rs;
  const int fold = tc_fold_bytes(kTcLanes * mg, mg, Dp);
  for (int st = kTcMaxStages; st >= kTcMinStages; --st) {
    const int ring = st * stage > fold ? st * stage : fold;
    if (qbytes + ring <= kTcSmemMax) return st;
  }
  return 0;
}

int tc_smem(int Dp, int mg, int tile, int stages) {
  const int rs = tc_row_bytes(Dp), ring = stages * 2 * tile * rs;
  const int fold = tc_fold_bytes(kTcLanes * mg, mg, Dp);
  return mg * 16 * rs + (ring > fold ? ring : fold);
}

template <int kKS>
cudaError_t tc_allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      swa_tc<kKS, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmemMax);
  if (e == cudaSuccess && tc_ws(kKS, 2) == 2)
    e = cudaFuncSetAttribute(swa_tc<kKS, tc_ws(kKS, 2)>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmemMax);
  return e;
}

template <int kKS, int kWS>
int tc_launch(const void* q, const void* k, const void* v,
              const void* valid_len, int B, int H, int S, int KV, int D,
              int chunk, int nsplit, float scale, float softcap,
              void* scratch, void* out, cudaStream_t stream) {
  using Shape = TcShape<kKS, kWS>;
  const int rep = H / KV, mtiles = (rep + 15) / 16;
  // at least kTcMinMG m-tiles' warps: those of an m-tile past rep only copy,
  // so that enough warps keep copies in flight
  const int mg = mtiles < kTcMinMG ? kTcMinMG
                                   : mtiles < Shape::kMG ? mtiles : Shape::kMG;
  const int groups = (mtiles + Shape::kMG - 1) / Shape::kMG;
  const int stages = tc_stages(Shape::kDp, mg, Shape::kTile);
  if (!stages) return (int)cudaErrorInvalidValue;
  float* pacc = (float*)scratch;
  float* pm = pacc + (size_t)B * H * nsplit * D;
  float* pl = pm + (size_t)B * H * nsplit;
  const dim3 grid(B * KV, nsplit, groups);
  swa_tc<kKS, kWS><<<grid, 32 * kTcLanes * mg,
                tc_smem(Shape::kDp, mg, Shape::kTile, stages), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)valid_len, H, S, KV, D, chunk,
      nsplit, stages, scale, softcap, pacc, pm, pl, (__nv_bfloat16*)out);
  if (nsplit == 1) return (int)cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, swa_merge<__nv_bfloat16>, (const float*)pacc, (const float*)pm,
      (const float*)pl, (const int*)valid_len, H, S, D, chunk, nsplit,
      (__nv_bfloat16*)out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#define SWA_TC_KS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

int pieces_for(int S, int split) { return (S + split - 1) / split; }

bool split_ok(int split) {
  return split >= kMinSplit && split <= kMaxSplit && !(split & (split - 1));
}

template <typename T, int kCopy>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(swa_partial<T, kCopy>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              partial_smem(kMaxSplit, kMaxD, kHeadGroup,
                                           (int)sizeof(T)));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           int B, int H, int S, int KV, int D, int split, float scale,
           float softcap, void* scratch, void* out, cudaStream_t stream) {
  if (B < 1 || S < 1 || KV < 1 || H < 1 || H % KV || D > kMaxD || D < 4 ||
      D % 4 || !split_ok(split))
    return (int)cudaErrorInvalidValue;
  const int np = pieces_for(S, split), rep = H / KV;
  float* pacc = (float*)scratch;
  float* pm = pacc + (size_t)B * H * np * D;
  float* pl = pm + (size_t)B * H * np;
  const int smem = partial_smem(split, D, rep, (int)sizeof(T));
  const dim3 grid(np, B, KV);
  if ((D * (int)sizeof(T)) % 16 == 0)
    swa_partial<T, 16><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)valid_len, H, S,
        KV, D, split, scale, softcap, np, pacc, pm, pl);
  else
    swa_partial<T, 8><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)valid_len, H, S,
        KV, D, split, scale, softcap, np, pacc, pm, pl);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, swa_merge<T>, (const float*)pacc, (const float*)pm,
      (const float*)pl, (const int*)valid_len, H, S, D, split, np, (T*)out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace swa

using namespace swa;

extern "C" {

// Lets the partial kernels take their largest piece (about 150 KB of
// dynamic shared memory), and the bf16 kernels their ring (up to 227 KB),
// on the current device: CUDA keeps the attribute
// per device, so the caller runs this once on each device before its first
// launch there.
int swa_init(void) {
  cudaError_t e = allow_smem<float, 16>();
  if (e == cudaSuccess) e = allow_smem<float, 8>();
#define SWA_TC_ALLOW(n) \
  if (e == cudaSuccess) e = tc_allow_smem<n>();
  SWA_TC_KS(SWA_TC_ALLOW)
#undef SWA_TC_ALLOW
  return (int)e;
}

// Floats of scratch one call needs: acc, then (m, l), per (b, h, piece).
int64_t swa_scratch_floats(int B, int H, int S, int D, int split) {
  return (int64_t)B * H * pieces_for(S, split) * (D + 2);
}

int swa_head_group(void) { return kHeadGroup; }
int swa_max_d(void) { return kMaxD; }
int swa_min_split(void) { return kMinSplit; }
int swa_max_split(void) { return kMaxSplit; }

// q (B, H, D), k and v (B, S, KV, D), out (B, H, D), all f32, contiguous
// and 16-byte aligned; valid_len (B,) int32; split the slots per piece (a
// power of two, kMinSplit..kMaxSplit); scale the f32 of D^-0.5; softcap 0
// for none.
int swa_decode_f32(const void* q, const void* k, const void* v,
                   const void* valid_len, int B, int H, int S, int KV, int D,
                   int split, float scale, float softcap, void* scratch,
                   void* out, void* stream) {
  return launch<float>(q, k, v, valid_len, B, H, S, KV, D, split, scale,
                       softcap, scratch, out, (cudaStream_t)stream);
}

int swa_tc_grain(void) { return kTcGrain; }

// Floats of scratch one bf16 call needs: none with one split, else acc,
// then (m, l), per (b, h, split).
int64_t swa_tc_scratch_floats(int B, int H, int D, int nsplit) {
  return nsplit > 1 ? (int64_t)B * H * nsplit * (D + 2) : 0;
}

// q (B, H, D), k and v (B, S, KV, D), out (B, H, D), all bf16, contiguous
// and 16-byte aligned; valid_len (B,) int32; chunk the slots per split (a
// multiple of kTcGrain) and nsplit = ceil(S / chunk); scale the f32 of
// D^-0.5; softcap 0 for none; scratch swa_tc_scratch_floats floats.
int swa_decode_tc(const void* q, const void* k, const void* v,
                  const void* valid_len, int B, int H, int S, int KV, int D,
                  int chunk, int nsplit, float scale, float softcap,
                  void* scratch, void* out, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H < 1 || H % KV || D > kMaxD || D < 4 ||
      D % 4 || chunk < kTcGrain || chunk % kTcGrain ||
      nsplit != (S + chunk - 1) / chunk || nsplit > 65535 ||
      (int64_t)B * KV > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
#define SWA_TC_CASE(n)                                                     \
  case n:                                                                  \
    return (H / KV > 16 && tc_ws(n, 2) == 2 ? tc_launch<n, tc_ws(n, 2)>    \
                                            : tc_launch<n, 1>)(            \
        q, k, v, valid_len, B, H, S, KV, D, chunk, nsplit, scale, softcap, \
        scratch, out, (cudaStream_t)stream);
    SWA_TC_KS(SWA_TC_CASE)
#undef SWA_TC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

const char* swa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
