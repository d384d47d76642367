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
// 1.3 us of f32 arithmetic.
//
// Design. B * KV is small (4 at the serve shape), so the cache is cut along
// S into pieces of kSplit slots, one block per (piece, b, kv head): 128
// blocks at S = 2048. A block stages the rep = H / KV query heads that share
// its kv head in shared memory, so each K and V row is read once for all of
// them. Phase 1: each warp takes slots; its lanes read the K row in 16-byte
// pieces and dot it with every staged query, and warp shuffles finish the
// dots. Phase 2: per query head, the max and the sum of exp over the piece.
// Phase 3: each thread owns output columns d and sums p * V over the piece
// for every query head in registers, reading each V element once. The block
// writes its partial (m, l, acc); a second launch merges the pieces of each
// (b, h) in piece order. No atomics: the same bits on every run.
//
// Masked slots are skipped. With at least one valid slot their weight in the
// plain version, exp(-1e30 - m), is exactly 0, so skipping them is the same
// function. With valid_len <= 0 every slot scores -1e30 and the softmax is
// uniform over the S slots, as in the plain version.
//
// Plain C interface for ctypes. Every entry point launches on the stream it
// is given, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swa {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;     // cache slots per block
constexpr int kMaxRep = 16;    // query heads per kv head
constexpr int kMaxD = 256;     // head dim

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Elements 4c .. 4c+3 of a row as a float4 (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* row, int c) {
  return __ldg(reinterpret_cast<const float4*>(row) + c);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + c);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
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

// Partial (m, l, acc) of one piece of kSplit slots for the rep query heads
// of one (b, kv head). Partials are laid out [b][h][piece] (acc: [.][D]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
swa_partial(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ valid_len,
            int H, int S, int KV, int D, float scale, float softcap,
            int npieces, float* __restrict__ pm, float* __restrict__ pl,
            float* __restrict__ pacc) {
  __shared__ __align__(16) float sq[kMaxRep * kMaxD];
  __shared__ float sp[kMaxRep * kSplit];
  const int piece = blockIdx.x, b = blockIdx.y, kvh = blockIdx.z;
  const int rep = H / KV, D4 = D / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qb = q + ((size_t)b * H + (size_t)kvh * rep) * D;
  for (int i = threadIdx.x; i < rep * D; i += kThreads) sq[i] = to_f32(qb[i]);

  const int vl = valid_len[b];
  const bool none = vl <= 0;             // every slot masked: uniform
  const int nvalid = none ? S : min(vl, S);
  const int s0 = piece * kSplit;
  const int ns = max(min(s0 + kSplit, nvalid) - s0, 0);
  const size_t row_stride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S + s0) * row_stride + (size_t)kvh * D;
  const T* vb = v + ((size_t)b * S + s0) * row_stride + (size_t)kvh * D;
  __syncthreads();

  // phase 1: one score per (query head, slot)
  for (int j = warp; j < ns; j += kWarps) {
    float part[kMaxRep];
#pragma unroll
    for (int g = 0; g < kMaxRep; ++g) part[g] = 0.0f;
    if (!none) {
      const T* krow = kb + (size_t)j * row_stride;
      for (int c = lane; c < D4; c += 32) {
        const float4 kk = load4(krow, c);
#pragma unroll
        for (int g = 0; g < kMaxRep; ++g) {
          if (g < rep) {
            const float4 qq = reinterpret_cast<const float4*>(sq + g * D)[c];
            part[g] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxRep; ++g) {
      if (g < rep) {
        const float dot = warp_sum(part[g]);
        if (lane == 0) {
          float s = -1e30f;
          if (!none) {
            s = dot * scale;
            if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
          }
          sp[g * kSplit + j] = s;
        }
      }
    }
  }
  __syncthreads();

  // phase 2: per query head, the piece's max and sum of exp; p in place
  __shared__ float sm[kMaxRep], sl[kMaxRep];
  for (int g = warp; g < rep; g += kWarps) {
    float m = -1e30f;
    for (int j = lane; j < ns; j += 32) m = fmaxf(m, sp[g * kSplit + j]);
    m = warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < ns; j += 32) {
      const float p = expf(sp[g * kSplit + j] - m);
      sp[g * kSplit + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      sm[g] = m;
      sl[g] = l;
    }
  }
  __syncthreads();

  // phase 3: acc[g][d] = sum_j p[g][j] v[j][d], each V element read once
  const size_t head0 = ((size_t)b * H + (size_t)kvh * rep) * npieces + piece;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc[kMaxRep];
#pragma unroll
    for (int g = 0; g < kMaxRep; ++g) acc[g] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < ns; ++j) {
      const float vv = to_f32(vb[(size_t)j * row_stride + d]);
#pragma unroll
      for (int g = 0; g < kMaxRep; ++g)
        if (g < rep) acc[g] += sp[g * kSplit + j] * vv;
    }
#pragma unroll
    for (int g = 0; g < kMaxRep; ++g)
      if (g < rep) pacc[(head0 + (size_t)g * npieces) * D + d] = acc[g];
  }
  if (threadIdx.x < rep) {
    pm[head0 + (size_t)threadIdx.x * npieces] = sm[threadIdx.x];
    pl[head0 + (size_t)threadIdx.x * npieces] = sl[threadIdx.x];
  }
}

// One block per (b, h): merges the pieces in piece order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
swa_merge(const float* __restrict__ pm, const float* __restrict__ pl,
          const float* __restrict__ pacc, int npieces, int D,
          T* __restrict__ out) {
  const size_t bh = blockIdx.x;
  const float* m = pm + bh * npieces;
  const float* l = pl + bh * npieces;
  float mx = -1e30f;
  for (int i = 0; i < npieces; ++i) mx = fmaxf(mx, m[i]);
  float den = 0.0f;
  for (int i = 0; i < npieces; ++i) den += l[i] * expf(m[i] - mx);
  den = fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.0f;
    for (int i = 0; i < npieces; ++i)
      a += pacc[(bh * npieces + i) * D + d] * expf(m[i] - mx);
    store(out + bh * D + d, a / den);
  }
}

int pieces_for(int S) { return (S + kSplit - 1) / kSplit; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           int B, int H, int S, int KV, int D, float scale, float softcap,
           void* scratch, void* out, cudaStream_t stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV || H / KV > kMaxRep || D > kMaxD ||
      D % 4)
    return (int)cudaErrorInvalidValue;
  const int np = pieces_for(S);
  float* pm = (float*)scratch;
  float* pl = pm + (size_t)B * H * np;
  float* pacc = pl + (size_t)B * H * np;
  swa_partial<T><<<dim3(np, B, KV), kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)valid_len, H, S, KV,
      D, scale, softcap, np, pm, pl, pacc);
  swa_merge<T><<<B * H, kThreads, 0, stream>>>(pm, pl, pacc, np, D, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace swa

using namespace swa;

extern "C" {

// Floats of scratch one call needs: (m, l) and acc per (b, h, piece).
int64_t swa_scratch_floats(int B, int H, int S, int D) {
  return (int64_t)B * H * pieces_for(S) * (2 + D);
}

int swa_max_rep(void) { return kMaxRep; }
int swa_max_d(void) { return kMaxD; }

// q (B, H, D), k and v (B, S, KV, D), out (B, H, D), all of one dtype and
// contiguous; valid_len (B,) int32; scale the f32 of D^-0.5; softcap 0 for
// none.
int swa_decode_f32(const void* q, const void* k, const void* v,
                   const void* valid_len, int B, int H, int S, int KV, int D,
                   float scale, float softcap, void* scratch, void* out,
                   void* stream) {
  return launch<float>(q, k, v, valid_len, B, H, S, KV, D, scale, softcap,
                       scratch, out, (cudaStream_t)stream);
}

int swa_decode_bf16(const void* q, const void* k, const void* v,
                    const void* valid_len, int B, int H, int S, int KV, int D,
                    float scale, float softcap, void* scratch, void* out,
                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid_len, B, H, S, KV, D, scale,
                               softcap, scratch, out, (cudaStream_t)stream);
}

const char* swa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
