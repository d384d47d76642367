// The Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060), for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/ssd/ssd.py::ssd_scan
// (_ssd_kernel). For one (batch, head) row, chunk k of L steps from t0 = kL,
// with cum the within-chunk cumsum of dt * a (a < 0, dt > 0) and S_k the
// (P x N) state before the chunk (S_0 = h0, zero when none is given):
//   y[l]    = sum_{s <= l} (c_l . b_s) exp(cum[l] - cum[s]) dt_s x_s
//             + exp(cum[l]) S_k c_l,
//   S_{k+1} = exp(cum[L-1]) S_k + sum_s exp(cum[L-1] - cum[s]) dt_s x_s b_s^T.
// Everything is f32 (no tensor cores, so no TF32) and the last S is the final
// state.
//
// Layout. The kernels read the model's layout in place: x and y (B, S, H, P),
// dt (B, S, H), b and c (B, S, G, N) with head h reading group
// h / (H / G), h0 and the final state (B, H, P, N), and a per row (B * H,).
// The (BH, S, P) row layout of the TPU kernel is the same with H = G = 1.
// Groups are never repeated to heads in device memory.
//
// Bound: operations. The scores c_l . b_s do not depend on the head, so the
// least work forms them once per (batch, chunk, group): L (L + 1) N flops
// over the causal pairs. Per head and chunk the rest is 2P flops per causal
// pair for W X, and 2 L P N each for the chunk's state and the state's term:
//   B nc G L (L + 1) N + B H nc (4 L P N + L (L + 1) P)  flops
// (ssd.py::ssd_work). At the mamba2-1.3b serve shape (B 4, S 2048, H 64,
// P 64, G 1, N 128, L 256) that is 0.27 + 25.80 = 26.07 GFLOP, 0.389 ms at
// 67 TFLOP/s of f32; the function's bytes (x, dt, b, c read once, y and the
// state written) are 0.29 GB, 0.09 ms at 3.35 TB/s.
//
// Design. Four launches, none with atomics, so every run gives the same bits:
//   cb_pass     one block per (batch, chunk, group, causal 64 x 64 tile):
//               the tile of C B^T, written to scratch (5.2 MB at the serve
//               shape, so it stays in the 50 MB L2) and read by every head
//               of the group;
//   chunk_pass  one block per (row, chunk): the cumsum of dt * a (one warp,
//               fixed order) to scratch, then the chunk's state contribution
//               sum_s w_s x_s b_s^T, each thread an 8 x 4 tile of the P x N
//               result, x and b staged 32 steps at a time by cp.async into
//               two buffers so the next stage's copy overlaps this one's
//               products; written through shared memory as (N, P);
//   fold_pass   one thread per 4 state elements of a row: the chunks in
//               order from h0, replacing each contribution by the state
//               before its chunk, and the final state. The loads of 8
//               chunks are started before any store, so that the loads are
//               in flight together and no load waits behind a store;
//   output_pass one block per (row, chunk, 64-row query tile), 128 threads,
//               each an 8 x 4 tile of the 64 x P output. It walks a list of
//               64-deep slabs, each a pair of 64 x 64 tiles in shared memory,
//               double-buffered by cp.async: first the state's term (C's
//               columns against S^T's rows, N / 64 slabs), scaled by
//               exp(cum[l]); then each key tile on or below the diagonal
//               (the score tile from cb_pass, turned in place into the
//               weights score * exp(cum[l] - cum[s]) dt_s, against x's
//               rows). Masked entries (s > l) are never evaluated:
//               exp(cum[l] - cum[s]) there can be inf. On the diagonal tile
//               a thread stops at the last key its 8 rows need.
// Each inner step reads 8 rows of the left tile and 4 rows of the right one
// as 12 float4 loads of shared memory for 128 FMAs. A ragged chunk (L not a
// multiple of 64, as when S < the configured chunk) is zero-filled on load
// and masked on store; P or N not a multiple of 4 takes 4-byte copies
// instead of 16-byte ones.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {
namespace {

constexpr int kMaxL = 256;              // chunk length
constexpr int kMaxP = 64;               // head dim
constexpr int kMaxN = 128;              // state dim
constexpr int kT = 64;                  // tile edge: queries, keys, slab depth
constexpr int kTT = kT * kT;
constexpr int kCbLd = kT + 4;           // cb_pass rows, padded: no conflicts
constexpr int kTileThreads = 128;       // cb_pass, output_pass: 8 x 16
constexpr int kChunkThreads = 256;      // chunk_pass: 8 p-groups x 32 n-groups
constexpr int kStage = 32;              // steps per chunk_pass stage
constexpr int kFoldThreads = 256;       // fold_pass: a 32 x 32 (n, p) tile
constexpr int kFoldAhead = 8;           // chunks loaded before any store
constexpr int kTLd = kMaxP + 1;         // chunk_pass transpose rows
// chunk_pass: two stages of x (32 x 64) and b (32 x 128), then cum and w
constexpr int kChunkFloats = 2 * kStage * (kMaxP + kMaxN) + 2 * kMaxL;
static_assert(2 * kStage * (kMaxP + kMaxN) >= kMaxN * kTLd,
              "the transpose reuses the stage buffers");
// output_pass: two buffers of (left, right) tiles, the queries' cum, and two
// buffers of the keys' cum and dt
constexpr int kOutFloats = 4 * kTT + kT + 4 * kT;

struct Shape {
  int B, S, H, G, P, N, L, nc;
  int nt;                               // 64-step tiles of a chunk
  bool vec;                             // P and N multiples of 4
  __device__ __forceinline__ size_t x(int bi, int t, int h) const {
    return (((size_t)bi * S + t) * H + h) * P;
  }
  __device__ __forceinline__ size_t dt(int bi, int t, int h) const {
    return ((size_t)bi * S + t) * H + h;
  }
  __device__ __forceinline__ size_t bc(int bi, int t, int g) const {
    return (((size_t)bi * S + t) * G + g) * N;
  }
  __device__ __forceinline__ int group(int h) const { return h / (H / G); }
  // chunk k's state slot of row r, stored (N, P)
  __device__ __forceinline__ size_t state(int r, int k) const {
    return ((size_t)r * nc + k) * P * N;
  }
  // the causal score tile (qt, kt), kt <= qt, of (batch, chunk, group)
  __device__ __forceinline__ size_t score(int bi, int k, int g, int qt,
                                          int kt) const {
    const int nct = nt * (nt + 1) / 2;
    return ((((size_t)bi * nc + k) * G + g) * nct + qt * (qt + 1) / 2 + kt) *
           kTT;
  }
};

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of a rows x W tile into dst (row stride ld floats) by
// nthreads threads: dst[i][j] = src[i * stride + j] for i < nr and
// j < ncols, zero elsewhere. vec: ncols, stride and src are multiples of 4
// floats (16-byte copies).
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          const float* src, size_t stride,
                                          int nr, int ncols, bool vec,
                                          int nthreads) {
  if (vec) {
    constexpr int per = W / 4;
    for (int e = threadIdx.x; e < rows * per; e += nthreads) {
      const int i = e / per, j = (e % per) * 4;
      const bool v = i < nr && j < ncols;
      cp16(dst + i * ld + j, v ? src + i * stride + j : src, v);
    }
  } else {
    for (int e = threadIdx.x; e < rows * W; e += nthreads) {
      const int i = e / W, j = e % W;
      const bool v = i < nr && j < ncols;
      cp4(dst + i * ld + j, v ? src + i * stride + j : src, v);
    }
  }
}

// Starts the copy of n floats spaced `stride` apart into dst[0..64), zero
// past n.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         size_t stride, int n) {
  for (int i = threadIdx.x; i < kT; i += blockDim.x)
    cp4(dst + i, i < n ? src + i * stride : src, i < n);
}

__device__ __forceinline__ void fma4(float acc[4], float a, float4 b) {
  acc[0] += a * b.x;
  acc[1] += a * b.y;
  acc[2] += a * b.z;
  acc[3] += a * b.w;
}

// acc[i][j] += sum_{k < kend} A[r0 + i][k] Bt[k][c0 + j] for the 8 x 4 tile
// at (r0, c0): A row-major (k along rows, stride lda), Bt row-major (the
// thread's 4 columns contiguous, stride ldb). kend is a multiple of 4.
__device__ __forceinline__ void mma_8x4(float acc[8][4], const float* A,
                                        int lda, int r0, const float* Bt,
                                        int ldb, int c0, int kend) {
  for (int k = 0; k < kend; k += 4) {
    float4 a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      b[kk] = *reinterpret_cast<const float4*>(Bt + (k + kk) * ldb + c0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fma4(acc[i], a[i].x, b[0]);
      fma4(acc[i], a[i].y, b[1]);
      fma4(acc[i], a[i].z, b[2]);
      fma4(acc[i], a[i].w, b[3]);
    }
  }
}

// The within-chunk inclusive cumsum of dt * a into cum[0..L) (shared) and
// cum_out (scratch), by warp 0: each lane sums its run of consecutive steps in
// order, a shuffle scan adds the runs before it. The caller syncs.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             const Shape& sh, int bi, int h,
                                             int t0, float a, float* cum,
                                             float* __restrict__ cum_out) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (sh.L + 31) / 32;     // <= 8
  const int l0 = lane * per;
  float run[kMaxL / 32];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxL / 32; ++i) {
    const int l = l0 + i;
    if (i < per && l < sh.L)
      s = __fadd_rn(s, __fmul_rn(__ldg(dt + sh.dt(bi, t0 + l, h)), a));
    run[i] = s;
  }
  float incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, v);
  }
  float prefix = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) prefix = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxL / 32; ++i) {
    const int l = l0 + i;
    if (i < per && l < sh.L) {
      const float v = __fadd_rn(prefix, run[i]);
      cum[l] = v;
      cum_out[l] = v;
    }
  }
}

// grid (B * nc * G, nt (nt + 1) / 2), 128 threads. The causal tile (qt, kt)
// of C B^T for (batch, chunk, group): score[l][s] = c_{q0+l} . b_{s0+s}, zero
// past the chunk. Thread (ty, tx) owns rows 8 ty + i and columns tx + 16 j
// (strided, so that the reads of b's rows hit 32 banks).
__global__ void __launch_bounds__(kTileThreads)
cb_pass(const float* __restrict__ b, const float* __restrict__ c, Shape sh,
        float* __restrict__ scores) {
  __shared__ __align__(16) float cs[kT * kCbLd];
  __shared__ __align__(16) float bs[kT * kCbLd];
  const int g = blockIdx.x % sh.G;
  const int k = (blockIdx.x / sh.G) % sh.nc;
  const int bi = blockIdx.x / (sh.G * sh.nc);
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.y) ++qt;
  const int kt = blockIdx.y - qt * (qt + 1) / 2;
  const int t0 = k * sh.L, q0 = qt * kT, s0 = kt * kT;
  const int nq = min(kT, sh.L - q0), nk = min(kT, sh.L - s0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t stride = (size_t)sh.G * sh.N;

  float acc[8][4] = {};
  for (int n0 = 0; n0 < sh.N; n0 += kT) {
    load_tile<kT>(cs, kCbLd, kT, c + sh.bc(bi, t0 + q0, g) + n0, stride, nq,
                  sh.N - n0, sh.vec, kTileThreads);
    load_tile<kT>(bs, kCbLd, kT, b + sh.bc(bi, t0 + s0, g) + n0, stride, nk,
                  sh.N - n0, sh.vec, kTileThreads);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    const int kend = min(kT, (sh.N - n0 + 3) & ~3);
    for (int kk = 0; kk < kend; kk += 4) {
      float4 a[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(cs + (8 * ty + i) * kCbLd +
                                                kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kCbLd +
                                                 kk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += a[i].x * bv[j].x + a[i].y * bv[j].y +
                       a[i].z * bv[j].z + a[i].w * bv[j].w;
    }
    __syncthreads();
  }
  float* out = scores + sh.score(bi, k, g, qt, kt);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(8 * ty + i) * kT + tx + 16 * j] = acc[i][j];
}

// grid (rows, nc), 256 threads, kChunkFloats floats of dynamic shared memory.
// Writes cum for the chunk's steps and the chunk's state contribution
// sum_s exp(cum[L-1] - cum[s]) dt_s x_s b_s^T, stored (N, P). Thread
// (pg, ng) = (tid / 32, tid % 32) owns p = 8 pg + i and n = 4 ng + j.
__global__ void __launch_bounds__(kChunkThreads, 2)
chunk_pass(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_rows, const float* __restrict__ b,
           Shape sh, float* __restrict__ cum_g, float* __restrict__ states) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                               // [2][kStage][kMaxP]
  float* bs = xs + 2 * kStage * kMaxP;            // [2][kStage][kMaxN]
  float* cum = bs + 2 * kStage * kMaxN;           // [kMaxL]
  float* w = cum + kMaxL;                         // [kMaxL]
  const int r = blockIdx.x, k = blockIdx.y;
  const int bi = r / sh.H, h = r % sh.H, g = sh.group(h);
  const int t0 = k * sh.L;
  const int nstage = (sh.L + kStage - 1) / kStage;
  const size_t xstride = (size_t)sh.H * sh.P, bstride = (size_t)sh.G * sh.N;
  auto fetch = [&](int st) {
    const int s0 = st * kStage, buf = st & 1;
    // the copies' stride is the run-time block size: as a constant, nvcc
    // unrolls these loops and the pass spills at 2 blocks per SM
    load_tile<kMaxP>(xs + buf * kStage * kMaxP, kMaxP, kStage,
                     x + sh.x(bi, t0 + s0, h), xstride, sh.L - s0, sh.P,
                     sh.vec, blockDim.x);
    load_tile<kMaxN>(bs + buf * kStage * kMaxN, kMaxN, kStage,
                     b + sh.bc(bi, t0 + s0, g), bstride, sh.L - s0, sh.N,
                     sh.vec, blockDim.x);
    cp_commit();
  };
  fetch(0);
  chunk_cumsum(dt, sh, bi, h, t0, __ldg(a_rows + r), cum,
               cum_g + (size_t)r * sh.S + t0);
  __syncthreads();
  const float last = cum[sh.L - 1];
  for (int l = threadIdx.x; l < sh.L; l += kChunkThreads)
    w[l] = __fmul_rn(expf(last - cum[l]), __ldg(dt + sh.dt(bi, t0 + l, h)));

  const int pg = threadIdx.x >> 5, ng = threadIdx.x & 31;
  float acc[8][4] = {};
  for (int st = 0; st < nstage; ++st) {
    if (st + 1 < nstage) fetch(st + 1);
    else cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* xb = xs + (st & 1) * kStage * kMaxP;
    const float* bb = bs + (st & 1) * kStage * kMaxN;
    const int s0 = st * kStage, steps = min(kStage, sh.L - s0);
    for (int i = 0; i < steps; ++i) {
      const float ws = w[s0 + i];
      const float4 x0 = *reinterpret_cast<const float4*>(xb + i * kMaxP +
                                                         8 * pg);
      const float4 x1 = *reinterpret_cast<const float4*>(xb + i * kMaxP +
                                                         8 * pg + 4);
      float4 bv = *reinterpret_cast<const float4*>(bb + i * kMaxN + 4 * ng);
      bv.x *= ws;
      bv.y *= ws;
      bv.z *= ws;
      bv.w *= ws;
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) fma4(acc[ii], xv[ii], bv);
    }
    __syncthreads();
  }
  // through shared memory, so that the (N, P) slot is written coalesced
  float* tr = smem;                               // [kMaxN][kTLd]
#pragma unroll
  for (int ii = 0; ii < 8; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      tr[(4 * ng + jj) * kTLd + 8 * pg + ii] = acc[ii][jj];
  __syncthreads();
  float* out = states + sh.state(r, k);
  for (int e = threadIdx.x; e < sh.N * sh.P; e += kChunkThreads)
    out[e] = tr[(e / sh.P) * kTLd + e % sh.P];
}

// grid (rows, ceil(N / 32), ceil(P / 32)), 256 threads. Folds the chunks of
// a row in order: S_{k+1} = exp(cum_k[L-1]) S_k + contribution_k, replacing
// each contribution by S_k, and writes the final state. Thread t owns
// n = n0 + t / 8 and p = p0 + 4 (t % 8) + i; h0 and the final state, stored
// (P, N), pass through a shared tile so that they are read and written
// along N.
__global__ void __launch_bounds__(kFoldThreads)
fold_pass(const float* __restrict__ h0, const float* __restrict__ cum_g,
          Shape sh, float* __restrict__ states,
          float* __restrict__ final_state) {
  __shared__ float tile[32][33];
  const int r = blockIdx.x, n0 = blockIdx.y * 32, p0 = blockIdx.z * 32;
  const int t = threadIdx.x;
  const int n = n0 + t / 8, pl = 4 * (t % 8);
  const int pr = t / 8, nl = 4 * (t % 8);        // the (P, N) side
  const size_t pn = (size_t)sh.P * sh.N;
  const float* h0r = h0 ? h0 + r * pn : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + pr, nn = n0 + nl + i;
    tile[pr][nl + i] =
        (h0r && p < sh.P && nn < sh.N) ? __ldg(h0r + (size_t)p * sh.N + nn)
                                       : 0.0f;
  }
  __syncthreads();
  float st[4];
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st[i] = tile[pl + i][t / 8];
    ok[i] = n < sh.N && p0 + pl + i < sh.P;
  }
  const bool v4 = sh.vec && ok[0];
  const size_t e0 = (size_t)n * sh.P + p0 + pl;
  const float* cum_row = cum_g + (size_t)r * sh.S + sh.L - 1;
  for (int k0 = 0; k0 < sh.nc; k0 += kFoldAhead) {
    float c[kFoldAhead][4], d[kFoldAhead];
#pragma unroll
    for (int kk = 0; kk < kFoldAhead; ++kk) {
      const int k = k0 + kk;
      if (k >= sh.nc) break;
      const float* slot = states + sh.state(r, k) + e0;
      if (v4) {
        const float4 v = *reinterpret_cast<const float4*>(slot);
        c[kk][0] = v.x;
        c[kk][1] = v.y;
        c[kk][2] = v.z;
        c[kk][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) c[kk][i] = ok[i] ? slot[i] : 0.0f;
      }
      d[kk] = expf(__ldg(cum_row + (size_t)k * sh.L));
    }
#pragma unroll
    for (int kk = 0; kk < kFoldAhead; ++kk) {
      const int k = k0 + kk;
      if (k >= sh.nc) break;
      float* slot = states + sh.state(r, k) + e0;
      if (v4) {
        *reinterpret_cast<float4*>(slot) = make_float4(st[0], st[1], st[2],
                                                       st[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ok[i]) slot[i] = st[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st[i] = __fadd_rn(__fmul_rn(d[kk], st[i]), c[kk][i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) tile[pl + i][t / 8] = st[i];
  __syncthreads();
  float* fin = final_state + r * pn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + pr, nn = n0 + nl + i;
    if (p < sh.P && nn < sh.N) fin[(size_t)p * sh.N + nn] = tile[pr][nl + i];
  }
}

// grid (rows, nc, nt), 128 threads, kOutFloats floats of dynamic shared
// memory. Thread (ty, tx) = (tid / 16, tid % 16) owns query rows 8 ty + i
// and head dims 4 tx + j.
__global__ void __launch_bounds__(kTileThreads)
output_pass(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ c, const float* __restrict__ cum_g,
            const float* __restrict__ states,
            const float* __restrict__ scores, Shape sh,
            float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  float* left = smem;                         // [2][kT][kT]
  float* right = left + 2 * kTT;              // [2][kT][kT]
  float* qcum = right + 2 * kTT;              // [kT]
  float* kcum = qcum + kT;                    // [2][kT]
  float* kdt = kcum + 2 * kT;                 // [2][kT]

  const int r = blockIdx.x, k = blockIdx.y, qt = blockIdx.z;
  const int bi = r / sh.H, h = r % sh.H, g = sh.group(h);
  const int t0 = k * sh.L, q0 = qt * kT;
  const int nq = min(kT, sh.L - q0);
  const float* cum_row = cum_g + (size_t)r * sh.S + t0;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nstate = (sh.N + kT - 1) / kT;
  const int nslab = nstate + qt + 1;

  // slab j < nstate: C's columns [64 j, 64 j + 64) of the query rows, and
  // S^T's rows n of the same range; then key tile kt = j - nstate: the
  // score tile and x's rows of the keys, with the keys' cum and dt
  auto fetch = [&](int j) {
    const int buf = j & 1;
    float* L_ = left + buf * kTT;
    float* R_ = right + buf * kTT;
    if (j < nstate) {
      const int n0 = j * kT;
      load_tile<kT>(L_, kT, kT, c + sh.bc(bi, t0 + q0, g) + n0,
                    (size_t)sh.G * sh.N, nq, sh.N - n0, sh.vec,
                    kTileThreads);
      load_tile<kT>(R_, kT, kT, states + sh.state(r, k) + (size_t)n0 * sh.P,
                    sh.P, sh.N - n0, sh.P, sh.vec, kTileThreads);
    } else {
      const int kt = j - nstate, s0 = kt * kT;
      const int nk = min(kT, sh.L - s0);
      load_tile<kT>(L_, kT, kT, scores + sh.score(bi, k, g, qt, kt), kT, kT,
                    kT, true, kTileThreads);
      load_tile<kT>(R_, kT, kT, x + sh.x(bi, t0 + s0, h),
                    (size_t)sh.H * sh.P, nk, sh.P, sh.vec, kTileThreads);
      load_vec(kcum + buf * kT, cum_row + s0, 1, nk);
      load_vec(kdt + buf * kT, dt + sh.dt(bi, t0 + s0, h), sh.H, nk);
    }
    cp_commit();
  };
  load_vec(qcum, cum_row + q0, 1, nq);
  fetch(0);

  float acc[8][4] = {};
  for (int j = 0; j < nslab; ++j) {
    if (j + 1 < nslab) fetch(j + 1);
    else cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int buf = j & 1;
    float* L_ = left + buf * kTT;
    const float* R_ = right + buf * kTT;
    int kend;
    if (j < nstate) {
      kend = min(kT, (sh.N - j * kT + 3) & ~3);
    } else {
      // the score tile becomes the weights, in place; a masked entry's
      // decay is never evaluated
      const int kt = j - nstate, s0 = kt * kT;
      const int nk = min(kT, sh.L - s0);
      const float* kc = kcum + buf * kT;
      const float* kd = kdt + buf * kT;
      for (int e = threadIdx.x; e < kTT; e += kTileThreads) {
        const int l = e / kT, s = e % kT;
        float wv = 0.0f;
        if (l < nq && s < nk && s0 + s <= q0 + l)
          wv = __fmul_rn(__fmul_rn(L_[e], expf(qcum[l] - kc[s])), kd[s]);
        L_[e] = wv;
      }
      __syncthreads();
      // on the diagonal tile row l needs keys s <= l only
      kend = kt == qt ? 8 * ty + 8 : kT;
    }
    mma_8x4(acc, L_, kT, 8 * ty, R_, kT, 4 * tx, kend);
    if (j == nstate - 1) {
      // the state's term is complete: exp(cum[l]) * (c_l . S[p])
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = expf(qcum[8 * ty + i]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = __fmul_rn(d, acc[i][jj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = 8 * ty + i;
    if (l >= nq) continue;
    float* yrow = y + sh.x(bi, t0 + q0 + l, h);
    const int p = 4 * tx;
    if (sh.vec && p < sh.P) {
      *reinterpret_cast<float4*>(yrow + p) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (p + jj < sh.P) yrow[p + jj] = acc[i][jj];
    }
  }
}

bool valid(int B, int S, int H, int G, int P, int N, int L) {
  return B >= 1 && S >= 1 && H >= 1 && G >= 1 && H % G == 0 && P >= 1 &&
         P <= kMaxP && N >= 1 && N <= kMaxN && L >= 1 && L <= kMaxL &&
         S % L == 0 && S / L <= 65535;
}

// scratch regions, each rounded up to 64 floats (keeps 16-byte alignment)
int64_t round64(int64_t n) { return (n + 63) / 64 * 64; }

}  // namespace
}  // namespace ssd

using namespace ssd;

extern "C" {

// Floats of scratch one call needs: the cumsum (rows x S), one P x N state
// per (row, chunk), and the causal 64 x 64 score tiles per (batch, chunk,
// group).
int64_t ssd_scratch_floats(int B, int S, int H, int G, int P, int N, int L) {
  const int64_t rows = (int64_t)B * H, nc = S / L;
  const int64_t nt = (L + kT - 1) / kT;
  return round64(rows * S) + round64(rows * nc * P * N) +
         (int64_t)B * nc * G * (nt * (nt + 1) / 2) * kTT;
}

// Lets chunk_pass and output_pass take their dynamic shared memory (~50 and
// ~65 KiB) on the current device; called once, when the library is loaded
// (not while a CUDA graph is being captured).
int ssd_init() {
  cudaFuncSetAttribute(chunk_pass,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kChunkFloats * (int)sizeof(float));
  cudaFuncSetAttribute(output_pass,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kOutFloats * (int)sizeof(float));
  return (int)cudaGetLastError();
}

int ssd_max_p() { return kMaxP; }
int ssd_max_n() { return kMaxN; }
int ssd_max_chunk() { return kMaxL; }

// x, y (B, S, H, P); dt (B, S, H); a_rows (B * H,); b, c (B, S, G, N);
// h0 (B, H, P, N) or null; final_state (B, H, P, N); all f32, contiguous and
// 16-byte aligned. L is the chunk length and divides S.
int ssd_scan_f32(const void* x, const void* dt, const void* a_rows,
                 const void* b, const void* c, const void* h0, int B, int S,
                 int H, int G, int P, int N, int L, void* scratch, void* y,
                 void* final_state, void* stream) {
  if (!valid(B, S, H, G, P, N, L)) return (int)cudaErrorInvalidValue;
  const int nt = (L + kT - 1) / kT;
  const Shape sh{B, S, H, G, P, N, L, S / L, nt, P % 4 == 0 && N % 4 == 0};
  const int rows = B * H;
  cudaStream_t st = (cudaStream_t)stream;
  float* cum = (float*)scratch;
  float* states = cum + round64((int64_t)rows * S);
  float* scores = states + round64((int64_t)rows * sh.nc * P * N);
  cb_pass<<<dim3(B * sh.nc * G, nt * (nt + 1) / 2), kTileThreads, 0, st>>>(
      (const float*)b, (const float*)c, sh, scores);
  chunk_pass<<<dim3(rows, sh.nc), kChunkThreads,
               kChunkFloats * (int)sizeof(float), st>>>(
      (const float*)x, (const float*)dt, (const float*)a_rows,
      (const float*)b, sh, cum, states);
  fold_pass<<<dim3(rows, (N + 31) / 32, (P + 31) / 32), kFoldThreads, 0,
              st>>>((const float*)h0, cum, sh, states, (float*)final_state);
  output_pass<<<dim3(rows, sh.nc, nt), kTileThreads,
                kOutFloats * (int)sizeof(float), st>>>(
      (const float*)x, (const float*)dt, (const float*)c, cum, states, scores,
      sh, (float*)y);
  return (int)cudaGetLastError();
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
