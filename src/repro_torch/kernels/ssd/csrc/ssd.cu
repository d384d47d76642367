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
// Bound: operations. At the mamba2-1.3b serve shape (B 4, S 2048, H 64,
// P 64, G 1, N 128, L 256) the causal work is about 43 GFLOP (per row and
// chunk: C B^T and W X over the L (L + 1) / 2 causal pairs, 2 (N + P) flops
// each, plus the chunk state and the state's term, 2 L P N each), 0.64 ms at
// 67 TFLOP/s of f32; the function's bytes (x, dt, b, c read once, y and the
// state written) are 0.29 GB, 0.09 ms at 3.35 TB/s. The output pass also
// computes the masked half of each diagonal tile (tiles of 64), about 15%
// more work than the bound counts.
//
// Design. A chunk of L = 256 does not fit one block's shared memory (B and C
// are 128 KiB each, the L x L scores 256 KiB), and the chunks of a row are a
// chain. Three launches, all without atomics, so every run gives the same
// bits:
//   chunk_pass  one block per (row, chunk): the cumsum of dt * a (one warp,
//               fixed order) written to scratch, then the chunk's state
//               contribution sum_s w_s x_s b_s^T with x and b staged 32 steps
//               at a time, each thread a 4 x 8 tile of the P x N result;
//   fold_pass   one thread per (row, state element): the chunks in order
//               from h0, replacing each contribution by the state before its
//               chunk, and the final state;
//   output_pass one block per (row, chunk, 64-row query tile): the C tile and
//               the chunk's starting state in shared memory give the
//               inter-chunk term; then each key tile on or below the diagonal
//               (tiles above it are all masked and never visited) is staged,
//               the 64 x 64 decay-weighted scores are formed in registers,
//               and y accumulates W X. Masked entries (s > l) are never
//               evaluated: exp(cum[l] - cum[s]) there can be inf.
// A ragged chunk (L not a multiple of 64, as when S < the configured chunk)
// is masked on load and store.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 256;              // chunk length
constexpr int kMaxP = 64;               // head dim
constexpr int kMaxN = 128;              // state dim
constexpr int kStage = 32;              // steps staged per round, chunk_pass
constexpr int kTile = 64;               // query and key tile, output_pass
constexpr int kStrideN = kMaxN + 1;     // padded rows: no bank conflicts
constexpr int kStrideT = kTile + 1;
// output_pass shared memory: C tile, B tile (or the starting state), x tile,
// weights, and the query and key cumsums and key dt.
constexpr int kOutFloats =
    2 * kTile * kStrideN + 2 * kTile * kStrideT + 3 * kTile;

struct Shape {
  int B, S, H, G, P, N, L, nc;
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
  __device__ __forceinline__ size_t state(int r, int k) const {
    return ((size_t)r * nc + k) * P * N;
  }
};

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

// grid (rows, nc). Writes cum for the chunk's steps and the chunk's state
// contribution sum_s exp(cum[L-1] - cum[s]) dt_s x_s b_s^T (P x N).
__global__ void __launch_bounds__(kThreads)
chunk_pass(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_rows, const float* __restrict__ b,
           Shape sh, float* __restrict__ cum_g, float* __restrict__ states) {
  const int r = blockIdx.x, k = blockIdx.y;
  const int bi = r / sh.H, h = r % sh.H, g = sh.group(h);
  const int t0 = k * sh.L;
  __shared__ float cum[kMaxL];
  __shared__ float w[kMaxL];
  __shared__ float xs[kStage][kMaxP];
  __shared__ float bs[kStage][kMaxN];

  chunk_cumsum(dt, sh, bi, h, t0, __ldg(a_rows + r), cum,
               cum_g + (size_t)r * sh.S + t0);
  __syncthreads();
  const float last = cum[sh.L - 1];
  for (int l = threadIdx.x; l < sh.L; l += kThreads)
    w[l] = __fmul_rn(expf(last - cum[l]), __ldg(dt + sh.dt(bi, t0 + l, h)));
  __syncthreads();

  const int pg = threadIdx.x >> 4, ng = threadIdx.x & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int s0 = 0; s0 < sh.L; s0 += kStage) {
    for (int e = threadIdx.x; e < kStage * kMaxP; e += kThreads) {
      const int i = e / kMaxP, p = e % kMaxP, s = s0 + i;
      xs[i][p] = (s < sh.L && p < sh.P)
                     ? __fmul_rn(__ldg(x + sh.x(bi, t0 + s, h) + p), w[s])
                     : 0.0f;
    }
    for (int e = threadIdx.x; e < kStage * kMaxN; e += kThreads) {
      const int i = e / kMaxN, n = e % kMaxN, s = s0 + i;
      bs[i][n] = (s < sh.L && n < sh.N)
                     ? __ldg(b + sh.bc(bi, t0 + s, g) + n) : 0.0f;
    }
    __syncthreads();
    const int steps = min(kStage, sh.L - s0);
    for (int i = 0; i < steps; ++i) {
      float xv[4], bv[8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) xv[ii] = xs[i][pg + 16 * ii];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) bv[jj] = bs[i][ng + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[ii][jj] += xv[ii] * bv[jj];
    }
    __syncthreads();
  }
  float* out = states + sh.state(r, k);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int p = pg + 16 * ii;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = ng + 16 * jj;
      if (p < sh.P && n < sh.N) out[p * sh.N + n] = acc[ii][jj];
    }
  }
}

// grid (rows, ceil(P N / 256)). Folds the chunks of a row in order:
// S_{k+1} = exp(cum_k[L-1]) S_k + contribution_k, replacing each
// contribution by S_k, and writes the final state.
__global__ void __launch_bounds__(kThreads)
fold_pass(const float* __restrict__ h0, const float* __restrict__ cum_g,
          Shape sh, float* __restrict__ states,
          float* __restrict__ final_state) {
  const int r = blockIdx.x;
  const int pn = sh.P * sh.N;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= pn) return;
  float st = h0 ? h0[(size_t)r * pn + e] : 0.0f;
  for (int k = 0; k < sh.nc; ++k) {
    float* slot = states + sh.state(r, k) + e;
    const float contrib = *slot;
    *slot = st;
    const float decay =
        expf(__ldg(cum_g + (size_t)r * sh.S + (size_t)k * sh.L + sh.L - 1));
    st = __fadd_rn(__fmul_rn(decay, st), contrib);
  }
  final_state[(size_t)r * pn + e] = st;
}

// grid (rows, nc, ceil(L / 64)), kOutFloats floats of dynamic shared memory.
// Thread (tl, tc) = (tid / 16, tid % 16) owns query rows tl + 16 i and
// columns tc + 16 j (head dim p, or key s while forming the weights).
__global__ void __launch_bounds__(kThreads)
output_pass(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ b, const float* __restrict__ c,
            const float* __restrict__ cum_g, const float* __restrict__ states,
            Shape sh, float* __restrict__ y) {
  extern __shared__ float smem[];
  float* cs = smem;                           // [kTile][kStrideN] queries' c
  float* bsm = cs + kTile * kStrideN;         // [kTile][kStrideN] keys' b | S
  float* xsm = bsm + kTile * kStrideN;        // [kTile][kStrideT] keys' x
  float* wsm = xsm + kTile * kStrideT;        // [kTile][kStrideT] weights
  float* qcum = wsm + kTile * kStrideT;       // [kTile]
  float* kcum = qcum + kTile;                 // [kTile]
  float* kdt = kcum + kTile;                  // [kTile]

  const int r = blockIdx.x, k = blockIdx.y, qt = blockIdx.z;
  const int bi = r / sh.H, h = r % sh.H, g = sh.group(h);
  const int t0 = k * sh.L, q0 = qt * kTile;
  const int nq = min(kTile, sh.L - q0);
  const float* cum_row = cum_g + (size_t)r * sh.S + t0;
  const int tl = threadIdx.x >> 4, tc = threadIdx.x & 15;

  for (int e = threadIdx.x; e < kTile * kMaxN; e += kThreads) {
    const int i = e / kMaxN, n = e % kMaxN;
    cs[i * kStrideN + n] = (i < nq && n < sh.N)
                               ? __ldg(c + sh.bc(bi, t0 + q0 + i, g) + n)
                               : 0.0f;
    bsm[i * kStrideN + n] =
        (i < sh.P && n < sh.N) ? __ldg(states + sh.state(r, k) + i * sh.N + n)
                               : 0.0f;
  }
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    qcum[i] = i < nq ? __ldg(cum_row + q0 + i) : 0.0f;
  __syncthreads();

  // the state's term: exp(cum[l]) * (c_l . S[p])
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int n = 0; n < sh.N; ++n) {
    float cv[4], sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = cs[(tl + 16 * i) * kStrideN + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) sv[j] = bsm[(tc + 16 * j) * kStrideN + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * sv[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = expf(qcum[tl + 16 * i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = __fmul_rn(d, acc[i][j]);
  }
  __syncthreads();

  // the chunk's own term, key tile by key tile up to the diagonal
  for (int kt = 0; kt <= qt; ++kt) {
    const int s0 = kt * kTile;
    const int nk = min(kTile, sh.L - s0);
    for (int e = threadIdx.x; e < kTile * kMaxN; e += kThreads) {
      const int i = e / kMaxN, n = e % kMaxN;
      bsm[i * kStrideN + n] = (i < nk && n < sh.N)
                                  ? __ldg(b + sh.bc(bi, t0 + s0 + i, g) + n)
                                  : 0.0f;
    }
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int i = e / kTile, p = e % kTile;
      xsm[i * kStrideT + p] = (i < nk && p < sh.P)
                                  ? __ldg(x + sh.x(bi, t0 + s0 + i, h) + p)
                                  : 0.0f;
    }
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      kcum[i] = i < nk ? __ldg(cum_row + s0 + i) : 0.0f;
      kdt[i] = i < nk ? __ldg(dt + sh.dt(bi, t0 + s0 + i, h)) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int n = 0; n < sh.N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(tl + 16 * i) * kStrideN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bsm[(tc + 16 * j) * kStrideN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = tl + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tc + 16 * j;
        // causal: key step s0 + s on or before query step q0 + l, inside the
        // chunk; the decay of a masked entry is never evaluated
        float wv = 0.0f;
        if (l < nq && s0 + s <= q0 + l)
          wv = __fmul_rn(__fmul_rn(sc[i][j], expf(qcum[l] - kcum[s])),
                         kdt[s]);
        wsm[l * kStrideT + s] = wv;
      }
    }
    __syncthreads();

    for (int s = 0; s < nk; ++s) {
      float wv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = wsm[(tl + 16 * i) * kStrideT + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xsm[s * kStrideT + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = tl + 16 * i;
    if (l >= nq) continue;
    float* yrow = y + sh.x(bi, t0 + q0 + l, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tc + 16 * j;
      if (p < sh.P) yrow[p] = acc[i][j];
    }
  }
}

bool valid(int B, int S, int H, int G, int P, int N, int L) {
  return B >= 1 && S >= 1 && H >= 1 && G >= 1 && H % G == 0 && P >= 1 &&
         P <= kMaxP && N >= 1 && N <= kMaxN && L >= 1 && L <= kMaxL &&
         S % L == 0 && S / L <= 65535;
}

}  // namespace
}  // namespace ssd

using namespace ssd;

extern "C" {

// Floats of scratch one call needs: the cumsum (rows x S) and one P x N
// state per (row, chunk).
int64_t ssd_scratch_floats(int B, int S, int H, int P, int N, int L) {
  const int64_t rows = (int64_t)B * H;
  return rows * S + rows * (S / L) * P * N;
}

// Lets output_pass take its ~98 KiB of dynamic shared memory on the current
// device; called once, when the library is loaded (not while a CUDA graph is
// being captured).
int ssd_init() {
  cudaFuncSetAttribute(output_pass,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kOutFloats * (int)sizeof(float));
  return (int)cudaGetLastError();
}

int ssd_max_p() { return kMaxP; }
int ssd_max_n() { return kMaxN; }
int ssd_max_chunk() { return kMaxL; }

// x, y (B, S, H, P); dt (B, S, H); a_rows (B * H,); b, c (B, S, G, N);
// h0 (B, H, P, N) or null; final_state (B, H, P, N); all f32, contiguous.
// L is the chunk length and divides S.
int ssd_scan_f32(const void* x, const void* dt, const void* a_rows,
                 const void* b, const void* c, const void* h0, int B, int S,
                 int H, int G, int P, int N, int L, void* scratch, void* y,
                 void* final_state, void* stream) {
  if (!valid(B, S, H, G, P, N, L)) return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, H, G, P, N, L, S / L};
  const int rows = B * H;
  cudaStream_t st = (cudaStream_t)stream;
  float* cum = (float*)scratch;
  float* states = cum + (size_t)rows * S;
  const int out_bytes = kOutFloats * (int)sizeof(float);
  chunk_pass<<<dim3(rows, sh.nc), kThreads, 0, st>>>(
      (const float*)x, (const float*)dt, (const float*)a_rows,
      (const float*)b, sh, cum, states);
  fold_pass<<<dim3(rows, (P * N + kThreads - 1) / kThreads), kThreads, 0,
              st>>>((const float*)h0, cum, sh, states, (float*)final_state);
  output_pass<<<dim3(rows, sh.nc, (L + kTile - 1) / kTile), kThreads,
                out_bytes, st>>>((const float*)x, (const float*)dt,
                                 (const float*)b, (const float*)c, cum,
                                 states, sh, (float*)y);
  return (int)cudaGetLastError();
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
