// AsyncFedED server sweeps over the padded flat f32 model, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/fedagg/fedagg.py::
// fedagg_norms (_norms_kernel) and ::fedagg_axpy (_axpy_kernel).
//
// Both sweeps are bound by device memory: 12 bytes per element (norms reads
// x_t, x_stale and delta once; the AXPY reads x_t and delta and writes the
// result) against no more than three flops per element. The design therefore
// only has to stream: 16-byte loads per thread (float4, or four bf16 values
// in 8 bytes), neighbouring threads on neighbouring addresses, a grid-stride
// loop over a fixed number of blocks, and nothing staged in shared memory.
//
// Determinism: the norms reduction has no float atomics. Stage 1 writes one
// (2,) partial per block; stage 2 is one block that folds the partials in a
// fixed order. The grid size depends only on n, so a given input gives the
// same bits on every run.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

// Four bf16 values in 8 bytes; a bf16 is the top half of an f32.
__device__ __forceinline__ float4 load4(const uint16_t* p, int64_t i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums a and b over the block; the totals are valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.0f;
    b = lane < kThreads / 32 ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// Stage 1: partial[2*block + {0,1}] = this block's share of
// [sum (x_t - x_s)^2, sum d^2].
template <typename D>
__global__ void __launch_bounds__(kThreads)
norms_partial(const float* __restrict__ xt, const float* __restrict__ xs,
              const D* __restrict__ d, float* __restrict__ partial,
              int64_t n4) {
  float s0 = 0.0f, s1 = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = load4(xt, i), b = load4(xs, i), c = load4(d, i);
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
template <typename D>
__global__ void __launch_bounds__(kThreads)
axpy(const float* __restrict__ xt, const D* __restrict__ d,
     const float* __restrict__ eta, float* __restrict__ out, int64_t n4) {
  const float e = __ldg(eta);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = load4(xt, i), c = load4(d, i);
    reinterpret_cast<float4*>(out)[i] = make_float4(
        __fadd_rn(a.x, __fmul_rn(e, c.x)), __fadd_rn(a.y, __fmul_rn(e, c.y)),
        __fadd_rn(a.z, __fmul_rn(e, c.z)), __fadd_rn(a.w, __fmul_rn(e, c.w)));
  }
}

int grid_for(int64_t n4) {
  const int64_t b = (n4 + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <typename D>
int launch_norms(const float* xt, const float* xs, const D* d, float* partial,
                 float* out, int64_t n, cudaStream_t stream) {
  const int64_t n4 = n / 4;
  const int g = grid_for(n4);
  norms_partial<D><<<g, kThreads, 0, stream>>>(xt, xs, d, partial, n4);
  norms_final<<<1, kThreads, 0, stream>>>(partial, g, out);
  return (int)cudaGetLastError();
}

template <typename D>
int launch_axpy(const float* xt, const D* d, const float* eta, float* out,
                int64_t n, cudaStream_t stream) {
  const int64_t n4 = n / 4;
  axpy<D><<<grid_for(n4), kThreads, 0, stream>>>(xt, d, eta, out, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of (2,) f32 partials the norms scratch must hold for length n.
int fedagg_norms_blocks(int64_t n) { return grid_for(n / 4); }

// n is a multiple of 4 and every pointer is 16-byte aligned (the wrapper
// checks both). delta is f32 (_f32) or bf16 (_bf16).
int fedagg_norms_f32(const void* xt, const void* xs, const void* d,
                     void* partial, void* out, int64_t n, void* stream) {
  return launch_norms((const float*)xt, (const float*)xs, (const float*)d,
                      (float*)partial, (float*)out, n, (cudaStream_t)stream);
}

int fedagg_norms_bf16(const void* xt, const void* xs, const void* d,
                      void* partial, void* out, int64_t n, void* stream) {
  return launch_norms((const float*)xt, (const float*)xs, (const uint16_t*)d,
                      (float*)partial, (float*)out, n, (cudaStream_t)stream);
}

int fedagg_axpy_f32(const void* xt, const void* d, const void* eta, void* out,
                    int64_t n, void* stream) {
  return launch_axpy((const float*)xt, (const float*)d, (const float*)eta,
                     (float*)out, n, (cudaStream_t)stream);
}

int fedagg_axpy_bf16(const void* xt, const void* d, const void* eta,
                     void* out, int64_t n, void* stream) {
  return launch_axpy((const float*)xt, (const uint16_t*)d, (const float*)eta,
                     (float*)out, n, (cudaStream_t)stream);
}

const char* fedagg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
