// AsyncFedED server sweeps over the padded flat f32 model, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/fedagg/fedagg.py::
// fedagg_norms (_norms_kernel), ::fedagg_axpy (_axpy_kernel),
// ::fedagg_norms_q (_norms_q_kernel) and ::fedagg_axpy_q (_axpy_q_kernel).
//
// All four sweeps are bound by device memory: 12 bytes per element with an
// f32 delta (norms reads x_t, x_stale and delta once; the AXPY reads x_t and
// delta and writes the result), 10 with a bf16 delta and about 9 with an int8
// one (1 byte of q plus one f32 scale per 1024 elements), against no more
// than five flops per element. The design therefore only has to stream:
// 16-byte loads of x_t per thread, the delta through its loader
// (fedagg_common.cuh), neighbouring threads on neighbouring addresses, a
// grid-stride loop over a fixed number of blocks, and nothing staged in
// shared memory. An int8 delta is dequantized in registers, so its f32 form
// never exists in device memory.
//
// Determinism: the norms reduction has no float atomics. Stage 1 writes one
// (2,) partial per block; stage 2 is one block that folds the partials in a
// fixed order. The grid size depends only on n, so a given input gives the
// same bits on every run.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include "fedagg_common.cuh"

namespace fedagg {
namespace {

// Stage 1: partial[2*block + {0,1}] = this block's share of
// [sum (x_t - x_s)^2, sum d^2].
template <typename L>
__global__ void __launch_bounds__(kThreads)
norms_partial(const float* __restrict__ xt, const float* __restrict__ xs,
              L d, float* __restrict__ partial, int64_t n4) {
  float s0 = 0.0f, s1 = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = load_f32(xt, i), b = load_f32(xs, i), c = d(i);
    const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z,
                dw = a.w - b.w;
    s0 += dx * dx + dy * dy + dz * dz + dw * dw;
    s1 += c.x * c.x + c.y * c.y + c.z * c.z + c.w * c.w;
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = s0;
    partial[2 * blockIdx.x + 1] = s1;
  }
}

// Stage 2: one block folds the partials, thread t taking t, t+256, ...
__global__ void __launch_bounds__(kThreads)
norms_final(const float* __restrict__ partial, int nblocks,
            float* __restrict__ out) {
  float s0 = 0.0f, s1 = 0.0f;
  for (int j = threadIdx.x; j < nblocks; j += kThreads) {
    s0 += partial[2 * j];
    s1 += partial[2 * j + 1];
  }
  block_sum2(s0, s1);
  if (threadIdx.x == 0) {
    out[0] = s0;
    out[1] = s1;
  }
}

// out = x_t + eta * d, with eta read on the device. The multiply and the add
// are rounded separately (no FMA contraction), as the plain version does.
template <typename L>
__global__ void __launch_bounds__(kThreads)
axpy(const float* __restrict__ xt, L d, const float* __restrict__ eta,
     float* __restrict__ out, int64_t n4) {
  const float e = __ldg(eta);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = load_f32(xt, i), c = d(i);
    reinterpret_cast<float4*>(out)[i] = make_float4(
        __fadd_rn(a.x, __fmul_rn(e, c.x)), __fadd_rn(a.y, __fmul_rn(e, c.y)),
        __fadd_rn(a.z, __fmul_rn(e, c.z)), __fadd_rn(a.w, __fmul_rn(e, c.w)));
  }
}

template <typename L>
int launch_norms(const float* xt, const float* xs, L d, float* partial,
                 float* out, int64_t n, cudaStream_t stream) {
  const int64_t n4 = n / 4;
  const int g = grid_for(n4);
  norms_partial<L><<<g, kThreads, 0, stream>>>(xt, xs, d, partial, n4);
  norms_final<<<1, kThreads, 0, stream>>>(partial, g, out);
  return (int)cudaGetLastError();
}

template <typename L>
int launch_axpy(const float* xt, L d, const float* eta, float* out, int64_t n,
                cudaStream_t stream) {
  const int64_t n4 = n / 4;
  axpy<L><<<grid_for(n4), kThreads, 0, stream>>>(xt, d, eta, out, n4);
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
// (_int8).
int fedagg_norms_f32(const void* xt, const void* xs, const void* d,
                     void* partial, void* out, int64_t n, void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      F32Delta{(const float*)d}, (float*)partial,
                      (float*)out, n, (cudaStream_t)stream);
}

int fedagg_norms_bf16(const void* xt, const void* xs, const void* d,
                      void* partial, void* out, int64_t n, void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      BF16Delta{(const uint16_t*)d}, (float*)partial,
                      (float*)out, n, (cudaStream_t)stream);
}

int fedagg_norms_int8(const void* xt, const void* xs, const void* q,
                      const void* scales, void* partial, void* out, int64_t n,
                      void* stream) {
  return launch_norms((const float*)xt, (const float*)xs,
                      I8Delta{(const int8_t*)q, (const float*)scales},
                      (float*)partial, (float*)out, n, (cudaStream_t)stream);
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

const char* fedagg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
