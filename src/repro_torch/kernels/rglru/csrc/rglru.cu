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
// Design: one pass that reads log_at and xi once and writes h once, 12 bytes
// per f32 element, and keeps nothing in device memory between steps. One
// block streams S in order for 32 neighbouring channels of one batch row (a
// row of the tile is one 128-byte line in f32), in stages of 32 steps, with
// its warps specialised:
//   - four producer warps copy each stage with cp.async into a ring of
//     kDepth stages in shared memory, kDepth - 1 stages ahead, so a block
//     keeps 24 KB of loads in flight without holding registers for them
//     (320 blocks at the serve shape: 7.7 MB in flight, more than 3.35 TB/s
//     needs over a load's latency). Each producer owns 8 channels of one
//     step of every stage: it copies them, waits for its own copies only,
//     and writes their gates a_t and beta_t xi_t into a ring of kGates
//     stages;
//   - one warp runs the recurrence, a thread per channel, h = a h + beta xi
//     step after step from h0 in the plain version's order, and writes h as
//     one coalesced row per step.
// Named barriers hand each gate stage from the producers to the chain
// (full) and back (empty), so the producers run up to kGates stages ahead
// and the chain's few instructions per step never wait on an exp. No
// scratch, no atomics, the same bits on every run.
// Designs not kept (timed on the card, PERF.md): the previous two passes
// (chunk summaries, then a rescan) read the inputs twice, 20 bytes per
// element; one pass that held a 64-step run per thread in registers and
// passed carries between blocks behind an integer ticket read the inputs
// once but, at 168 registers a thread, kept too few blocks on an SM to hide
// its load, compute and store phases; the same stream as here with all
// warps in lockstep (copy, gates, barrier, chain) waited on its own chain.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rglru {
namespace {

constexpr int kC = 32;                   // channels per block
constexpr int kT = 32;                   // steps per stage
constexpr int kDepth = 4;                // stages of inputs in the ring
constexpr int kGates = 2;                // stages of gates in the ring
constexpr int kProducers = 128;          // 4 warps: copies and gates
constexpr int kThreads = kProducers + 32;  // and one warp for the chain
constexpr int kOwn = 8;                  // channels a producer owns per step
static_assert(kProducers * kOwn == kT * kC, "each element has one owner");
// named barriers (0 is __syncthreads): gates of a stage written, and read
constexpr int kFull = 1, kEmpty = 1 + kGates;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void set_zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& x) {
  x = __float2bfloat16_rn(0.0f);
}

// One step's decay and input weight from log a_t, as the plain version
// computes them.
__device__ __forceinline__ void gates(float la, float& a, float& beta) {
  a = expf(la);
  beta = sqrtf(fmaxf(1.0f - expf(2.0f * la), 1e-12f));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
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
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

template <typename T>
struct Smem {
  float la[kDepth][kT][kC];
  T xi[kDepth][kT][kC];
  float a[kGates][kT][kC];
  float bx[kGates][kT][kC];
};

// grid (B * ceil(W / 32)), 160 threads, Smem<T> in shared memory (48 KiB in
// f32, 40 in bf16). Producer p owns step p / 4 of every stage and channels
// 8 (p % 4) .. + 8: it copies them, waits for its own copies only, and
// writes their gates. vec: rows copy as 16-byte pieces (W a multiple of 4
// in f32 and of 8 in bf16); otherwise log_at takes 4-byte copies and xi
// plain loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_stream(const float* __restrict__ log_at, const T* __restrict__ xi,
            const float* __restrict__ h0, int S, int W, bool vec,
            T* __restrict__ out, float* __restrict__ last) {
  __shared__ __align__(16) Smem<T> sm;
  const int tiles = (W + kC - 1) / kC;
  const int b = blockIdx.x / tiles, w0 = (blockIdx.x % tiles) * kC;
  const int nst = (S + kT - 1) / kT;
  const size_t base = (size_t)b * S * W + w0;   // (b, 0, w0)

  if (threadIdx.x < kProducers) {
    const int i = threadIdx.x / (kC / kOwn), j = threadIdx.x % (kC / kOwn) *
                                                 kOwn;
    // stage st's own elements, zero past S and past W (log a = 0, xi = 0:
    // a = 1 and beta xi = 0, the identity)
    auto fetch = [&](int st) {
      if (st < nst) {
        const int t = st * kT + i, buf = st % kDepth;
        const size_t o = base + (size_t)t * W + j;
        if (vec) {
          constexpr int per = 16 / sizeof(T);
#pragma unroll
          for (int q = 0; q < kOwn; q += 4) {
            const bool v = t < S && w0 + j + q < W;
            cp16(&sm.la[buf][i][j + q], v ? log_at + o + q : log_at, v);
          }
#pragma unroll
          for (int q = 0; q < kOwn; q += per) {
            const bool v = t < S && w0 + j + q < W;
            cp16(&sm.xi[buf][i][j + q], v ? xi + o + q : xi, v);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kOwn; ++q) {
            const bool v = t < S && w0 + j + q < W;
            cp4(&sm.la[buf][i][j + q], v ? log_at + o + q : log_at, v);
            if (v) sm.xi[buf][i][j + q] = xi[o + q];
            else set_zero(sm.xi[buf][i][j + q]);
          }
        }
      }
      cp_commit();
    };
    for (int st = 0; st < kDepth - 1; ++st) fetch(st);
    for (int st = 0; st < nst; ++st) {
      fetch(st + kDepth - 1);
      cp_wait<kDepth - 1>();
      const int buf = st % kDepth, g = st % kGates;
      if (st >= kGates) bar_sync(kEmpty + g);   // the chain read stage st - G
#pragma unroll
      for (int q = 0; q < kOwn; ++q) {
        float a, beta;
        gates(sm.la[buf][i][j + q], a, beta);
        sm.a[g][i][j + q] = a;
        sm.bx[g][i][j + q] = beta * to_f32(sm.xi[buf][i][j + q]);
      }
      bar_arrive(kFull + g);
    }
  } else {
    // the chain: one thread per channel, step after step
    const int lane = threadIdx.x - kProducers;
    const bool live = w0 + lane < W;
    float h = (live && h0) ? __ldg(h0 + (size_t)b * W + w0 + lane) : 0.0f;
    for (int st = 0; st < nst; ++st) {
      const int g = st % kGates, t0 = st * kT;
      bar_sync(kFull + g);
      float a[kT], bx[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        a[i] = sm.a[g][i][lane];
        bx[i] = sm.bx[g][i][lane];
      }
      if (st + kGates < nst) bar_arrive(kEmpty + g);
      T* o = out + base + (size_t)t0 * W + lane;
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        h = a[i] * h + bx[i];
        if (live && t0 + i < S) store(o + (size_t)i * W, h);
      }
    }
    if (live) last[(size_t)b * W + w0 + lane] = h;
  }
}

template <typename T>
int launch(const void* log_at, const void* xi, const void* h0, int B, int S,
           int W, void* out, void* last, cudaStream_t stream) {
  if (B < 1 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * ((W + kC - 1) / kC);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const bool vec = W % (16 / (int)sizeof(T)) == 0 && W % 4 == 0;
  scan_stream<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)log_at, (const T*)xi, (const float*)h0, S, W, vec,
      (T*)out, (float*)last);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rglru

using namespace rglru;

extern "C" {

// log_at (B, S, W) f32; xi and out (B, S, W) of one dtype; h0 (B, W) f32 or
// null; last (B, W) f32; all contiguous and 16-byte aligned.
int rglru_scan_f32(const void* log_at, const void* xi, const void* h0, int B,
                   int S, int W, void* out, void* last, void* stream) {
  return launch<float>(log_at, xi, h0, B, S, W, out, last,
                       (cudaStream_t)stream);
}

int rglru_scan_bf16(const void* log_at, const void* xi, const void* h0, int B,
                    int S, int W, void* out, void* last, void* stream) {
  return launch<__nv_bfloat16>(log_at, xi, h0, B, S, W, out, last,
                               (cudaStream_t)stream);
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
