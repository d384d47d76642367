// Shared pieces of the fedagg kernels (fedagg.cu, fedagg_batched.cu): the
// block size, the delta loaders and the block reductions.
//
// A delta loader reads element group i (elements 4i .. 4i+3) of a flat delta
// as a float4, whatever form the delta travels in:
//   F32Delta  - f32, one 16-byte load;
//   BF16Delta - bf16, four values in one 8-byte load, widened by a shift
//               (a bf16 is the top half of an f32);
//   I8Delta   - int8 wire form: four values in one 4-byte load, times the f32
//               scale of their 1024-element block, each product rounded as
//               the plain version's `q.float() * s` rounds it.
// row(b, n) gives the loader of row b of a (B, n) stack of deltas, so one
// kernel template serves the single and the batched sweeps. A kernel that
// loads a delta's raw bytes itself (cp.async, or wider loads into
// registers) takes them from raw(i), kRawBytes per group (kElemBytes per
// element), and for the int8 form the scale from scale(i), and turns them
// into f32 with widen (bf16 and int8 forms) or, from 32-bit words,
// widen_words, as the loader's call does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fedagg {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kQBlock = 1024;  // elements per int8 scale on the wire

__device__ __forceinline__ float4 load_f32(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

struct F32Delta {
  static constexpr int kRawBytes = 16, kElemBytes = 4;
  const float* p;
  __device__ __forceinline__ const void* raw(int64_t i) const {
    return p + 4 * i;
  }
  static __device__ __forceinline__ float4 widen_words(const uint32_t* w,
                                                      float) {
    return make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                       __uint_as_float(w[2]), __uint_as_float(w[3]));
  }
  __device__ __forceinline__ float4 operator()(int64_t i) const {
    return load_f32(p, i);
  }
  __device__ __forceinline__ F32Delta row(int b, int64_t n) const {
    return {p + b * n};
  }
};

struct BF16Delta {
  static constexpr int kRawBytes = 8, kElemBytes = 2;
  const uint16_t* p;
  __device__ __forceinline__ const void* raw(int64_t i) const {
    return p + 4 * i;
  }
  static __device__ __forceinline__ float4 widen(uint2 u) {
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float4 widen_words(const uint32_t* w,
                                                      float) {
    return widen(make_uint2(w[0], w[1]));
  }
  __device__ __forceinline__ float4 operator()(int64_t i) const {
    return widen(__ldg(reinterpret_cast<const uint2*>(p) + i));
  }
  __device__ __forceinline__ BF16Delta row(int b, int64_t n) const {
    return {p + b * n};
  }
};

struct I8Delta {
  static constexpr int kRawBytes = 4, kElemBytes = 1;
  const int8_t* q;
  const float* s;  // one scale per kQBlock elements
  __device__ __forceinline__ const void* raw(int64_t i) const {
    return q + 4 * i;
  }
  __device__ __forceinline__ const float* scale(int64_t i) const {
    return s + (i * 4) / kQBlock;
  }
  // four int8 values, each times the scale, as the plain version rounds
  static __device__ __forceinline__ float4 widen(char4 v, float sc) {
    return make_float4(__fmul_rn((float)v.x, sc), __fmul_rn((float)v.y, sc),
                       __fmul_rn((float)v.z, sc), __fmul_rn((float)v.w, sc));
  }
  // the same from the four bytes of one 32-bit word, lowest first, without
  // a conversion instruction: byte k, biased to q + 128, becomes the low
  // byte of the float 2^23 + q + 128, from which subtracting 2^23 + 128
  // leaves q exactly, as (float)q gives it
  static __device__ __forceinline__ float4 widen_words(const uint32_t* w,
                                                      float sc) {
    const uint32_t u = w[0] ^ 0x80808080u;
    const float bias = 8388736.0f;  // 2^23 + 128
    const float q0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                           0x7540)), bias);
    const float q1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                           0x7541)), bias);
    const float q2 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                           0x7542)), bias);
    const float q3 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u,
                                                           0x7543)), bias);
    return make_float4(__fmul_rn(q0, sc), __fmul_rn(q1, sc),
                       __fmul_rn(q2, sc), __fmul_rn(q3, sc));
  }
  __device__ __forceinline__ float4 operator()(int64_t i) const {
    return widen(__ldg(reinterpret_cast<const char4*>(q) + i),
                 __ldg(scale(i)));
  }
  __device__ __forceinline__ I8Delta row(int b, int64_t n) const {
    return {q + b * n, s + b * (n / kQBlock)};
  }
};

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

// Blocks of a grid-stride sweep over n4 float4 groups: set by n alone.
inline int grid_for(int64_t n4) {
  const int64_t b = (n4 + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace fedagg
