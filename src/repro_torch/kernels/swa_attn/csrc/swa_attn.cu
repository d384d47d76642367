// Decode attention over a ring-buffer KV cache, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/swa_attn/swa_attn.py::
// swa_decode_attention (_swa_decode_kernel): one query token per sequence
// attends over a cache (B, S, KV, D) whose slots at or past valid_len[b] are
// masked, with an optional tanh softcap, and query head h reads kv head
// h / (H / KV) (GQA).
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
//     it). Otherwise its queries and the valid K rows of its piece, then the
//     valid V rows, go to shared memory as cp.async copies of 16 bytes (8
//     bytes for bf16 rows that are not a multiple of 16 bytes) in two commit
//     groups, issued before any arithmetic: 128 KB per block at the serve
//     shape. Rows are padded in shared memory so that neighbouring slots
//     fall in other banks.
//  2. Scores once K has landed, as a small product held in registers: a
//     tile of 4 slots x 4 query heads (16 sums) is shared by up to 32 lanes,
//     each taking every dp-th float4 of D, so each K and q element read from
//     shared memory serves four products, and one shuffle tree per tile
//     (log2 dp steps over 16 independent sums) finishes the dots: no thread
//     waits on a chain of warp reductions.
//  3. Softmax of the piece: 16 lanes per query head, all heads at once.
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
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swa {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinSplit = 8;    // cache slots per block, at least
constexpr int kMaxSplit = 64;   // and at most
constexpr int kMaxRep = 16;     // query heads per kv head
constexpr int kMaxD = 256;      // head dim
constexpr int kSpStride = kMaxRep + 4;  // floats per slot of scores, 16B rows
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

// Bytes of the rep queries of one kv head, padded to a multiple of 16.
__host__ __device__ __forceinline__ int query_bytes(int rep, int D,
                                                   int esize) {
  return (rep * D * esize + 15) / 16 * 16;
}

// Dynamic shared memory of one partial block: K and V pieces, the queries
// and the scores (one row of kSpStride floats per slot).
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
// of one (b, kv head). Partials are laid out [b][h][piece] (acc: [.][D]).
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
  copy_span<kCopy>(sqb, reinterpret_cast<const unsigned char*>(
                            q + ((size_t)b * H + (size_t)kvh * rep) * D),
                   rep * row_bytes);
  if (!none)
    copy_rows<kCopy>(sk, stride, reinterpret_cast<const unsigned char*>(k) +
                     off, src_stride, ns, row_bytes);
  commit_copies();
  copy_rows<kCopy>(sv, stride, reinterpret_cast<const unsigned char*>(v) +
                   off, src_stride, ns, row_bytes);
  commit_copies();
  wait_copies<1>();                      // this thread's queries and K
  __syncthreads();                       // everyone's

  // 2. scores. A tile of 4 slots x 4 heads is shared by dp lanes, each
  // taking every dp-th float4 of D; the dp partial dots are summed by a
  // shuffle tree, and the tile's first lane writes the 16 scores.
  {
    const int nj = (ns + 3) / 4, ng = (rep + 3) / 4, nt = nj * ng;
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
        kr[i] = reinterpret_cast<const T*>(sk +
                                           min(4 * jt + i, ns - 1) * stride);
        qr[i] = sq + min(4 * gt + i, rep - 1) * D;
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
          if (j < ns && g < rep) {
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

  // per query head (16 lanes each, all heads at once), the piece's max and
  // sum of exp; p in place
  {
    const int g = threadIdx.x >> 4, lane = threadIdx.x & 15;
    const bool mine = g < rep;
    float m = -1e30f;
    if (mine)
      for (int j = lane; j < ns; j += 16) m = fmaxf(m, sp[j * kSpStride + g]);
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
      const size_t i = ((size_t)b * H + (size_t)kvh * rep + g) * npieces +
                       piece;
      pm[i] = m;
      pl[i] = l;
    }
  }
  wait_copies<0>();                      // this thread's V copies
  __syncthreads();

  // 3. acc[g][4c..4c+3] = sum_j p[g][j] v[j][4c..4c+3], j in order: thread
  // t owns column group c = t % D4 and heads 4 (t / D4) .. + 3, reading
  // the four p of a slot as one float4
  const int ng = (rep + 3) / 4;
  if (threadIdx.x < ng * D4) {
    const int c = threadIdx.x % D4, gt = threadIdx.x / D4;
    float4 acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int j = 0; j < ns; ++j) {
      const float4 vv = row4(reinterpret_cast<const T*>(sv + j * stride), c);
      const float4 p = row4(sp + j * kSpStride + 4 * gt, 0);
      fma4(acc[0], p.x, vv);
      fma4(acc[1], p.y, vv);
      fma4(acc[2], p.z, vv);
      fma4(acc[3], p.w, vv);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int g = 4 * gt + u;
      if (g < rep)
        store4(pacc + (((size_t)b * H + (size_t)kvh * rep + g) * npieces +
                       piece) * D + 4 * c,
               acc[u]);
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

int pieces_for(int S, int split) { return (S + split - 1) / split; }

bool split_ok(int split) {
  return split >= kMinSplit && split <= kMaxSplit && !(split & (split - 1));
}

template <typename T, int kCopy>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(swa_partial<T, kCopy>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              partial_smem(kMaxSplit, kMaxD, kMaxRep,
                                           (int)sizeof(T)));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           int B, int H, int S, int KV, int D, int split, float scale,
           float softcap, void* scratch, void* out, cudaStream_t stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV || H / KV > kMaxRep || D > kMaxD ||
      D < 4 || D % 4 || !split_ok(split))
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
// dynamic shared memory); called once per process, before any launch.
int swa_init(void) {
  cudaError_t e = allow_smem<float, 16>();
  if (e == cudaSuccess) e = allow_smem<float, 8>();
  if (e == cudaSuccess) e = allow_smem<__nv_bfloat16, 16>();
  if (e == cudaSuccess) e = allow_smem<__nv_bfloat16, 8>();
  return (int)e;
}

// Floats of scratch one call needs: acc, then (m, l), per (b, h, piece).
int64_t swa_scratch_floats(int B, int H, int S, int D, int split) {
  return (int64_t)B * H * pieces_for(S, split) * (D + 2);
}

int swa_max_rep(void) { return kMaxRep; }
int swa_max_d(void) { return kMaxD; }
int swa_min_split(void) { return kMinSplit; }
int swa_max_split(void) { return kMaxSplit; }

// q (B, H, D), k and v (B, S, KV, D), out (B, H, D), all of one dtype,
// contiguous and 16-byte aligned; valid_len (B,) int32; split the slots per
// piece (a power of two, kMinSplit..kMaxSplit); scale the f32 of D^-0.5;
// softcap 0 for none.
int swa_decode_f32(const void* q, const void* k, const void* v,
                   const void* valid_len, int B, int H, int S, int KV, int D,
                   int split, float scale, float softcap, void* scratch,
                   void* out, void* stream) {
  return launch<float>(q, k, v, valid_len, B, H, S, KV, D, split, scale,
                       softcap, scratch, out, (cudaStream_t)stream);
}

int swa_decode_bf16(const void* q, const void* k, const void* v,
                    const void* valid_len, int B, int H, int S, int KV, int D,
                    int split, float scale, float softcap, void* scratch,
                    void* out, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid_len, B, H, S, KV, D, split,
                               scale, softcap, scratch, out,
                               (cudaStream_t)stream);
}

const char* swa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
