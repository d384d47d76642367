// AsyncFedED server sweeps over the padded flat f32 model, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/fedagg/fedagg.py::
// fedagg_norms (_norms_kernel), ::fedagg_axpy (_axpy_kernel),
// ::fedagg_fused (_fused_kernel), ::fedagg_norms_q (_norms_q_kernel) and
// ::fedagg_axpy_q (_axpy_q_kernel).
//
// All five sweeps are bound by device memory: 12 bytes per element with an
// f32 delta (norms reads x_t, x_stale and delta once; the AXPY reads x_t and
// delta and writes the result), 10 with a bf16 delta and about 9 with an int8
// one (1 byte of q plus one f32 scale per 1024 elements), against no more
// than five flops per element. The fused sweep is the norms sweep that also
// writes the AXPY: 16 bytes per f32 element, one pass instead of two (24).
// The design therefore only has to stream: 16-byte loads of x_t per thread,
// the delta through its loader (fedagg_common.cuh), neighbouring threads on
// neighbouring addresses, and nothing staged in shared memory. An int8 delta
// is dequantized in registers, so its f32 form never exists in device memory.
//
// Launch shapes. The norms sweeps are grid-stride loops over grid_for(n)
// blocks; that grid fixes the order of their partial sums, and with it their
// bits. The AXPY is elementwise, so its bits do not depend on its launch
// shape, and it takes its own: one block of 256 threads per 1,024
// elements, one float4 per thread and one pass, so that the block
// scheduler, not a fixed grid, spreads the work over the SMs (a grid_for
// grid of at most 1,024 blocks leaves 32 of 132 SMs a block short at 2^28).
// A persistent grid of eight blocks per SM and four float4 a thread were
// measured and not kept (PERF.md).
// At 2^28 the bound is 0.96 ms (12 bytes per element at 3.35 TB/s); at the
// paper's lengths (65,536 to 262,144) the call is set by launch latency.
//
// One launch per norms sweep. At the paper's lengths a launch costs more
// than the sweep's bytes, so the fold of the per-block partials rides in the
// sweep's own launch: each block writes its (2,) partial and draws an
// integer ticket with an acquire-release atomic add, which orders the
// partial before the draw and, in the block that draws the last ticket, the
// reads of every partial after it (no separate fence: a fence around a
// plain atomicAdd measured slower, PERF.md). That block folds the partials
// in a fixed order (thread t takes partials t, t + 256, ..., then the block
// sum) and sets the ticket back to 0 for the next sweep. The ticket is one
// zeroed int32 per device that the wrapper keeps; sweeps that share it run
// one after another on one stream.
//
// Determinism: no float atomics (the ticket is an integer). The grid size
// depends only on n and the fold's order only on the grid, so a given input
// gives the same bits on every run, and the same bits as the two-launch
// design (a sweep, then a one-block fold) that this one replaced.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include "fedagg_common.cuh"

namespace fedagg {
namespace {

// x_t + e * d for one float4 group, the multiply and the add rounded
// separately (no FMA contraction), as the plain version does.
__device__ __forceinline__ float4 axpy4(float4 a, float e, float4 c) {
  return make_float4(
      __fadd_rn(a.x, __fmul_rn(e, c.x)), __fadd_rn(a.y, __fmul_rn(e, c.y)),
      __fadd_rn(a.z, __fmul_rn(e, c.z)), __fadd_rn(a.w, __fmul_rn(e, c.w)));
}

// partial[2*block + {0,1}] = this block's share of
// [sum (x_t - x_s)^2, sum d^2]; the block that draws the last ticket folds
// the partials into norms[0..1]. With kAxpy (fedagg_fused) the same sweep
// also writes out = x_t + eta * d; the sums are the same code in the same
// order, so the norms equal the norms sweep's to the bit.
template <typename L, bool kAxpy>
__global__ void __launch_bounds__(kThreads)
norms_sweep(const float* __restrict__ xt, const float* __restrict__ xs, L d,
            float* __restrict__ partial, unsigned* __restrict__ ticket,
            float* __restrict__ norms, int64_t n4,
            const float* __restrict__ eta, float* __restrict__ out) {
  __shared__ bool last;
  float s0 = 0.0f, s1 = 0.0f;
  const float e = kAxpy ? __ldg(eta) : 0.0f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = load_f32(xt, i), b = load_f32(xs, i), c = d(i);
    if (kAxpy) reinterpret_cast<float4*>(out)[i] = axpy4(a, e, c);
    const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z,
                dw = a.w - b.w;
    s0 += dx * dx + dy * dy + dz * dz + dw * dw;
    s1 += c.x * c.x + c.y * c.y + c.z * c.z + c.w * c.w;
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = s0;
    partial[2 * blockIdx.x + 1] = s1;
    // release: the partial is visible before the ticket is drawn; acquire:
    // the last block sees every partial
    unsigned drawn;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(drawn) : "l"(ticket) : "memory");
    last = drawn == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  s0 = s1 = 0.0f;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    s0 += __ldcg(partial + 2 * j);
    s1 += __ldcg(partial + 2 * j + 1);
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    norms[0] = s0;
    norms[1] = s1;
    *ticket = 0u;
  }
}

// out = x_t + eta * d, with eta read on the device: one pass, thread t of
// block b on float4 group b * kThreads + t.
template <typename L>
__global__ void __launch_bounds__(kThreads)
axpy(const float* __restrict__ xt, L d, const float* __restrict__ eta,
     float* __restrict__ out, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 a = load_f32(xt, i), c = d(i);
    reinterpret_cast<float4*>(out)[i] = axpy4(a, __ldg(eta), c);
  }
}

// The norms (eta and axpy_out null) or, with both given, the fused sweep:
// one launch.
template <typename L>
int launch_norms(const float* xt, const float* xs, L d, float* partial,
                 unsigned* ticket, float* out, int64_t n, cudaStream_t stream,
                 const float* eta = nullptr, float* axpy_out = nullptr) {
  const int64_t n4 = n / 4;
  const int g = grid_for(n4);
  if (axpy_out)
    norms_sweep<L, true><<<g, kThreads, 0, stream>>>(
        xt, xs, d, partial, ticket, out, n4, eta, axpy_out);
  else
    norms_sweep<L, false><<<g, kThreads, 0, stream>>>(
        xt, xs, d, partial, ticket, out, n4, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The AXPY: one block per kThreads float4 groups.
template <typename L>
int launch_axpy(const float* xt, L d, const float* eta, float* out, int64_t n,
                cudaStream_t stream) {
  const int64_t n4 = n / 4;
  const int64_t blocks = (n4 + kThreads - 1) / kThreads;
  axpy<L><<<(unsigned)blocks, kThreads, 0, stream>>>(xt, d, eta, out, n4);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fedagg

using namespace fedagg;

extern "C" {

// Number of (2,) f32 partials the norms scratch must hold for length n.
int fedagg_norms_blocks(int64_t n) { return grid_for(n / 4); }

// n is a multiple of 65536 and every pointer is 16-byte aligned (the wrapper
// checks both). delta is f32 (_f32), bf16 (_bf16) or int8 q with f32 scales
// (_int8). ticket is a zeroed uint32 that no other sweep uses meanwhile; the
// sweep leaves it at 0.
int fedagg_norms_f32(const void* xt, const void* xs, const void* d,
                     void* partial, void* ticket, void* out, int64_t n,
                     void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      F32Delta{(const float*)d}, (float*)partial,
                      (unsigned*)ticket, (float*)out, n,
                      (cudaStream_t)stream);
}

int fedagg_norms_bf16(const void* xt, const void* xs, const void* d,
                      void* partial, void* ticket, void* out, int64_t n,
                      void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      BF16Delta{(const uint16_t*)d}, (float*)partial,
                      (unsigned*)ticket, (float*)out, n,
                      (cudaStream_t)stream);
}

int fedagg_norms_int8(const void* xt, const void* xs, const void* q,
                      const void* scales, void* partial, void* ticket,
                      void* out, int64_t n, void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      I8Delta{(const int8_t*)q, (const float*)scales},
                      (float*)partial, (unsigned*)ticket, (float*)out, n,
                      (cudaStream_t)stream);
}

int fedagg_axpy_f32(const void* xt, const void* d, const void* eta, void* out,
                    int64_t n, void* stream) {
  return launch_axpy((const float*)xt, F32Delta{(const float*)d},
                     (const float*)eta, (float*)out, n, (cudaStream_t)stream);
}

int fedagg_axpy_bf16(const void* xt, const void* d, const void* eta,
                     void* out, int64_t n, void* stream) {
  return launch_axpy((const float*)xt, BF16Delta{(const uint16_t*)d},
                     (const float*)eta, (float*)out, n, (cudaStream_t)stream);
}

int fedagg_axpy_int8(const void* xt, const void* q, const void* scales,
                     const void* eta, void* out, int64_t n, void* stream) {
  return launch_axpy((const float*)xt,
                     I8Delta{(const int8_t*)q, (const float*)scales},
                     (const float*)eta, (float*)out, n, (cudaStream_t)stream);
}

// The fused sweep: axpy_out = x_t + eta * d and out = the norms, in one pass
// over (x_t, x_stale, d) that also folds the partials (one launch).
int fedagg_fused_f32(const void* xt, const void* xs, const void* d,
                     const void* eta, void* axpy_out, void* partial,
                     void* ticket, void* out, int64_t n, void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      F32Delta{(const float*)d}, (float*)partial,
                      (unsigned*)ticket, (float*)out, n, (cudaStream_t)stream,
                      (const float*)eta, (float*)axpy_out);
}

int fedagg_fused_bf16(const void* xt, const void* xs, const void* d,
                      const void* eta, void* axpy_out, void* partial,
                      void* ticket, void* out, int64_t n, void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      BF16Delta{(const uint16_t*)d}, (float*)partial,
                      (unsigned*)ticket, (float*)out, n, (cudaStream_t)stream,
                      (const float*)eta, (float*)axpy_out);
}

const char* fedagg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
