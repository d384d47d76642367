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
// It reads 4(2B+1) bytes per element (8B+4 with a bf16 delta) and does about
// 4B^2+5B flops on them: 7.9 flop/byte at B = 15, under the H100's f32 ridge
// of 20 flop/byte (67 TFLOP/s over 3.35 TB/s), so device memory bounds it.
// A thread cannot hold the 2B^2+2B sums (480 at B = 15, past the 255-register
// limit), so the kernel stages instead: each block copies a chunk of C
// elements of the B drifts and the B deltas into shared memory (C shrinks as
// B grows, so the chunk stays near 64 KB), then each warp takes a fixed set
// of the B + B^2 + B(B+1)/2 dot products (gram is symmetric: only k <= l is
// computed and the fold mirrors it), its lanes sweep the chunk with 16-byte
// shared-memory loads, a warp shuffle sums them, and lane 0 adds the chunk's
// sum to the block's accumulator in shared memory. Blocks walk the chunks in
// a grid-stride loop and write one partial vector each; a second launch,
// one thread per output, folds the partials in block order. No float
// atomics and a grid set by (n, B) alone: the result is the same to the bit
// on every run. No tensor cores and no TF32: the contractions stay in f32,
// as the schedule needs.
//
// apply_batched: out = x_t + sum_b eta_b D_b. It reads 4(B+1) bytes per
// element and writes 4, for 2B+1 flops: device memory bounds it. It streams
// the B delta rows in a grid-stride loop with the etas in shared memory, and
// sums in a fixed order with every multiply and add rounded on its own
// (acc = eta_0 D_0, acc = acc + eta_b D_b for b = 1..B-1, out = x_t + acc),
// exactly as the plain version's loop, so the two agree to the bit. It
// writes a new vector: the ring GMIS keeps every past one.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include "fedagg_common.cuh"

namespace fedagg {
namespace {

constexpr int kMaxB = 128;            // largest burst either kernel takes
constexpr int kBatchedBlocks = 264;   // two blocks per SM of an H100
constexpr int kWarps = kThreads / 32;

// Elements per staged chunk: about 8192 / B (64 KB of drifts and deltas),
// a power of two between 64 and 1024. n, a multiple of 65536, divides.
int chunk_for(int b) {
  int c = 1024;
  while (c > 64 && c * b > 8192) c >>= 1;
  return c;
}

// Partial layout per block: [dist B][cross B*B][gram B*B]; gram entries with
// k > l are never written or read.
__host__ __device__ inline int partial_len(int b) { return b + 2 * b * b; }

size_t norms_smem_bytes(int b) {
  return sizeof(float) * ((size_t)2 * b * chunk_for(b) + partial_len(b));
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
norms_batched_partial(const float* __restrict__ xt,
                      const float* __restrict__ xs, L d, int b, int64_t n,
                      int c, int64_t nchunks, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sS = reinterpret_cast<float*>(smem4);  // b rows of c drifts
  float* sD = sS + (size_t)b * c;               // b rows of c deltas
  float* acc = sD + (size_t)b * c;              // partial_len(b) sums
  const int p = partial_len(b), c4 = c / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = threadIdx.x; o < p; o += kThreads) acc[o] = 0.0f;

  for (int64_t ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const int64_t base4 = ch * c4;
    __syncthreads();  // the previous chunk's dots are done with the stage
    // every thread stages (row, column) pairs, so all loads are in flight
    // at once whatever B is; x_t is read once per row, from cache after
    // the first
    for (int idx = threadIdx.x; idx < b * c4; idx += kThreads) {
      const int r = idx / c4, j = idx - r * c4;
      const float4 x = load_f32(xt, base4 + j);
      const float4 s = load_f32(xs + r * n, base4 + j);
      reinterpret_cast<float4*>(sS + (size_t)r * c)[j] =
          make_float4(x.x - s.x, x.y - s.y, x.z - s.z, x.w - s.w);
      reinterpret_cast<float4*>(sD + (size_t)r * c)[j] =
          d.row(r, n)(base4 + j);
    }
    __syncthreads();
    for (int o = warp; o < p; o += kWarps) {
      const float *u, *v;
      if (o < b) {
        u = v = sS + (size_t)o * c;
      } else if (o < b + b * b) {
        const int q = o - b;
        u = sS + (size_t)(q / b) * c;
        v = sD + (size_t)(q % b) * c;
      } else {
        const int q = o - b - b * b, k = q / b, l = q % b;
        if (k > l) continue;  // the mirror of an upper entry
        u = sD + (size_t)k * c;
        v = sD + (size_t)l * c;
      }
      float sum = 0.0f;
      for (int j = lane; j < c4; j += 32) {
        const float4 x = reinterpret_cast<const float4*>(u)[j];
        const float4 y = reinterpret_cast<const float4*>(v)[j];
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      sum = warp_sum(sum);
      if (lane == 0) acc[o] += sum;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < p; o += kThreads)
    partial[(int64_t)blockIdx.x * p + o] = acc[o];
}

// One thread per output folds the partials of nblocks blocks in block order
// into out = [dist B][dn B][cross B*B][gram B*B], gram mirrored from k <= l
// and dn taken from its diagonal.
__global__ void __launch_bounds__(kThreads)
norms_batched_final(const float* __restrict__ partial, int nblocks, int b,
                    float* __restrict__ out) {
  const int p = partial_len(b);
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o < p) {
    int src = o, dst;
    if (o < b) {
      dst = o;
    } else if (o < b + b * b) {
      dst = b + o;
    } else {
      const int q = o - b - b * b, k = q / b, l = q % b;
      if (k > l) src = b + b * b + l * b + k;
      dst = 2 * b + b * b + q;
    }
    float s = 0.0f;
#pragma unroll 8
    for (int j = 0; j < nblocks; ++j) s += partial[(int64_t)j * p + src];
    out[dst] = s;
    if (dst >= 2 * b + b * b) {
      const int q = dst - 2 * b - b * b;
      if (q / b == q % b) out[b + q / b] = s;
    }
  }
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
apply_batched(const float* __restrict__ xt, L d,
              const float* __restrict__ etas, int b, int64_t n,
              float* __restrict__ out) {
  __shared__ float se[kMaxB];
  for (int r = threadIdx.x; r < b; r += kThreads) se[r] = __ldg(etas + r);
  __syncthreads();
  const int64_t n4 = n / 4, stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float4 v = d(i);
    float4 acc = make_float4(__fmul_rn(se[0], v.x), __fmul_rn(se[0], v.y),
                             __fmul_rn(se[0], v.z), __fmul_rn(se[0], v.w));
    for (int r = 1; r < b; ++r) {
      const float e = se[r];
      v = d.row(r, n)(i);
      acc.x = __fadd_rn(acc.x, __fmul_rn(e, v.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(e, v.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(e, v.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(e, v.w));
    }
    const float4 x = load_f32(xt, i);
    reinterpret_cast<float4*>(out)[i] =
        make_float4(__fadd_rn(x.x, acc.x), __fadd_rn(x.y, acc.y),
                    __fadd_rn(x.z, acc.z), __fadd_rn(x.w, acc.w));
  }
}

int blocks_for(int64_t n, int b) {
  const int64_t chunks = n / chunk_for(b);
  return (int)(chunks < kBatchedBlocks ? chunks : kBatchedBlocks);
}

template <typename L>
int launch_norms_batched(const float* xt, const float* xs, L d, int b,
                         int64_t n, float* partial, float* out,
                         cudaStream_t stream) {
  if (b < 1 || b > kMaxB) return (int)cudaErrorInvalidValue;
  const size_t smem = norms_smem_bytes(b);
  const int c = chunk_for(b), g = blocks_for(n, b);
  norms_batched_partial<L><<<g, kThreads, smem, stream>>>(
      xt, xs, d, b, n, c, n / c, partial);
  norms_batched_final<<<(partial_len(b) + kThreads - 1) / kThreads, kThreads,
                        0, stream>>>(partial, g, b, out);
  return (int)cudaGetLastError();
}

template <typename L>
int launch_apply_batched(const float* xt, L d, const float* etas, int b,
                         int64_t n, float* out, cudaStream_t stream) {
  if (b < 1 || b > kMaxB) return (int)cudaErrorInvalidValue;
  apply_batched<L><<<grid_for(n / 4), kThreads, 0, stream>>>(xt, d, etas, b,
                                                            n, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fedagg

using namespace fedagg;

extern "C" {

// Lets the norms kernel use the shared memory of the largest burst (about
// 193 KB at B = kMaxB, past the 48 KB default). Called once, when the
// library is loaded, so that no launch makes this call (a launch may be
// captured in a CUDA graph).
int fedagg_batched_init(void) {
  size_t most = 0;
  for (int b = 1; b <= kMaxB; ++b)
    most = norms_smem_bytes(b) > most ? norms_smem_bytes(b) : most;
  cudaError_t err = cudaFuncSetAttribute(
      norms_batched_partial<F32Delta>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(norms_batched_partial<BF16Delta>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(norms_batched_partial<I8Delta>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
  return (int)err;
}

// Largest B the batched kernels take.
int fedagg_batched_max_b(void) { return kMaxB; }

// Floats of partials the norms-batched scratch must hold for (n, B).
int64_t fedagg_norms_batched_scratch(int64_t n, int b) {
  return (int64_t)blocks_for(n, b) * partial_len(b);
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
  return launch_apply_batched((const float*)xt, F32Delta{(const float*)d},
                              (const float*)etas, b, n, (float*)out,
                              (cudaStream_t)stream);
}

int fedagg_apply_batched_bf16(const void* xt, const void* d, const void* etas,
                              int b, int64_t n, void* out, void* stream) {
  return launch_apply_batched((const float*)xt, BF16Delta{(const uint16_t*)d},
                              (const float*)etas, b, n, (float*)out,
                              (cudaStream_t)stream);
}

int fedagg_apply_batched_int8(const void* xt, const void* q, const void* s,
                              const void* etas, int b, int64_t n, void* out,
                              void* stream) {
  return launch_apply_batched((const float*)xt,
                              I8Delta{(const int8_t*)q, (const float*)s},
                              (const float*)etas, b, n, (float*)out,
                              (cudaStream_t)stream);
}

}  // extern "C"
