// The RG-LRU linear recurrence (Griffin / RecurrentGemma), for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/rglru/rglru.py::
// rglru_scan (_rglru_kernel): for log_at and xi of shape (B, S, W),
//   a_t = exp(log_at), beta_t = sqrt(max(1 - exp(2 log_at), 1e-12)),
//   h_t = a_t h_{t-1} + beta_t xi_t,
// per channel (b, w), from h_{-1} = h0 (zero when none is given). h is
// written in xi's dtype, and the last step in f32.
//
// Bound: device memory. The function reads log_at and xi and writes h: 12
// bytes per element in f32, 254 MB at the RecurrentGemma-2B serve shape (B 4,
// S 2064, W 2560), 76 us at 3.35 TB/s, against about 10 flops and two exps
// per element.
//
// Design. There are only B * W independent channels (10,240 at the serve
// shape), each a chain of S dependent steps: one thread per channel would
// fill few SMs. The recurrence is associative, so S is cut into chunks of L
// steps, one thread per (b, chunk, w), neighbouring threads on neighbouring
// channels so every load is coalesced (B * W * S / L threads: 337,920 at the
// serve shape with L = 64):
//   pass 1: each thread runs its chunk from h = 0 and writes the chunk's end
//           state e_c and the product of its a_t, A_c;
//   pass 2: each thread folds the summaries of the chunks before its own, in
//           chunk order (carry = A_c carry + e_c, from h0), then runs its
//           chunk again from that carry and writes h.
// Pass 1 is skipped when there is one chunk. Inside a chunk the steps run in
// the sequential order of the plain version; only the carry across chunks is
// summed in another order. No atomics, the same bits on every run. The two
// passes read the inputs twice: 20 bytes per element in f32, so the design
// cannot come nearer than 1.7x of the bound.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rglru {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One step's decay and input weight from log a_t, as the plain version
// computes them.
__device__ __forceinline__ void gates(float la, float& a, float& beta) {
  a = expf(la);
  beta = sqrtf(fmaxf(1.0f - expf(2.0f * la), 1e-12f));
}

struct Shape {
  int B, S, W, L, nc;
  // thread i -> (b, c, w), w fastest
  __device__ __forceinline__ bool at(int64_t i, int& b, int& c,
                                     int& w) const {
    if (i >= (int64_t)B * nc * W) return false;
    w = (int)(i % W);
    c = (int)((i / W) % nc);
    b = (int)(i / ((int64_t)W * nc));
    return true;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_summary(const float* __restrict__ log_at, const T* __restrict__ xi,
              Shape sh, float* __restrict__ prod, float* __restrict__ end) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int b, c, w;
  if (!sh.at(i, b, c, w)) return;
  const int t0 = c * sh.L, t1 = min(sh.S, t0 + sh.L);
  size_t o = ((size_t)b * sh.S + t0) * sh.W + w;
  float h = 0.0f, p = 1.0f;
#pragma unroll 8
  for (int t = t0; t < t1; ++t, o += sh.W) {
    float a, beta;
    gates(__ldg(log_at + o), a, beta);
    h = a * h + beta * to_f32(xi[o]);
    p *= a;
  }
  prod[i] = p;
  end[i] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_scan(const float* __restrict__ log_at, const T* __restrict__ xi,
           const float* __restrict__ h0, Shape sh,
           const float* __restrict__ prod, const float* __restrict__ end,
           T* __restrict__ out, float* __restrict__ last) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int b, c, w;
  if (!sh.at(i, b, c, w)) return;
  float h = h0 ? h0[(size_t)b * sh.W + w] : 0.0f;
  const size_t s0 = (size_t)b * sh.nc * sh.W + w;
  for (int k = 0; k < c; ++k)
    h = prod[s0 + (size_t)k * sh.W] * h + end[s0 + (size_t)k * sh.W];
  const int t0 = c * sh.L, t1 = min(sh.S, t0 + sh.L);
  size_t o = ((size_t)b * sh.S + t0) * sh.W + w;
#pragma unroll 8
  for (int t = t0; t < t1; ++t, o += sh.W) {
    float a, beta;
    gates(__ldg(log_at + o), a, beta);
    h = a * h + beta * to_f32(xi[o]);
    store(out + o, h);
  }
  if (c == sh.nc - 1) last[(size_t)b * sh.W + w] = h;
}

template <typename T>
int launch(const void* log_at, const void* xi, const void* h0, int B, int S,
           int W, int L, void* scratch, void* out, void* last,
           cudaStream_t stream) {
  if (B < 1 || S < 1 || W < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, W, L, (S + L - 1) / L};
  const int64_t n = (int64_t)B * sh.nc * W;
  const int grid = (int)((n + kThreads - 1) / kThreads);
  float* prod = (float*)scratch;
  float* end = prod + n;
  if (sh.nc > 1)
    chunk_summary<T><<<grid, kThreads, 0, stream>>>(
        (const float*)log_at, (const T*)xi, sh, prod, end);
  chunk_scan<T><<<grid, kThreads, 0, stream>>>(
      (const float*)log_at, (const T*)xi, (const float*)h0, sh, prod, end,
      (T*)out, (float*)last);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rglru

using namespace rglru;

extern "C" {

// Floats of scratch one call needs: two per (b, chunk, w).
int64_t rglru_scratch_floats(int B, int S, int W, int L) {
  return 2 * (int64_t)B * ((S + L - 1) / L) * W;
}

// log_at (B, S, W) f32; xi and out (B, S, W) of one dtype; h0 (B, W) f32 or
// null; last (B, W) f32; all contiguous. L is the chunk length.
int rglru_scan_f32(const void* log_at, const void* xi, const void* h0, int B,
                   int S, int W, int L, void* scratch, void* out, void* last,
                   void* stream) {
  return launch<float>(log_at, xi, h0, B, S, W, L, scratch, out, last,
                       (cudaStream_t)stream);
}

int rglru_scan_bf16(const void* log_at, const void* xi, const void* h0, int B,
                    int S, int W, int L, void* scratch, void* out, void* last,
                    void* stream) {
  return launch<__nv_bfloat16>(log_at, xi, h0, B, S, W, L, scratch, out,
                               last, (cudaStream_t)stream);
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
