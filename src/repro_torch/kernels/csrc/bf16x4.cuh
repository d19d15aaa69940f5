// Four elements at a time in f32 or bf16, for the kernels of this
// directory whose state operands come in either dtype.
//
// A bf16 is the high half of an f32, so widening is a shift (exact).
// Narrowing rounds to nearest even, written out as PyTorch's CPU
// conversion (c10::BFloat16's round_to_nearest_even) does it, NaN
// included, so a kernel's bf16 output is the bits of its plain version's
// `.to(torch.bfloat16)`.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16x4 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

__device__ __forceinline__ uint16_t narrow(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) {
  return widen(__bfloat16_as_ushort(x));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __ushort_as_bfloat16(narrow(x));
}

// Elements [0, 4) of p as f32: one 16-byte (f32) or 8-byte (bf16) load
// when VEC (p aligned to 4 elements), else four loads.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
template <bool VEC>
__device__ __forceinline__ float4 load4(const bf16* p) {
  if (VEC) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_float4(widen((uint16_t)(w.x & 0xffffu)),
                       widen((uint16_t)(w.x >> 16)),
                       widen((uint16_t)(w.y & 0xffffu)),
                       widen((uint16_t)(w.y >> 16)));
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]),
                     to_f32(p[3]));
}

// v rounded to T into elements [0, 4) of p; STREAM stores evict-first
// (__stcs) when VEC.
template <bool VEC, bool STREAM = false>
__device__ __forceinline__ void store4(float* p, float4 v) {
  if (VEC) {
    if (STREAM) {
      __stcs(reinterpret_cast<float4*>(p), v);
    } else {
      *reinterpret_cast<float4*>(p) = v;
    }
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}
template <bool VEC, bool STREAM = false>
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const uint16_t a = narrow(v.x), b = narrow(v.y), c = narrow(v.z),
                 d = narrow(v.w);
  if (VEC) {
    const uint2 w = make_uint2((uint32_t)a | ((uint32_t)b << 16),
                               (uint32_t)c | ((uint32_t)d << 16));
    if (STREAM) {
      __stcs(reinterpret_cast<uint2*>(p), w);
    } else {
      *reinterpret_cast<uint2*>(p) = w;
    }
  } else {
    p[0] = __ushort_as_bfloat16(a); p[1] = __ushort_as_bfloat16(b);
    p[2] = __ushort_as_bfloat16(c); p[3] = __ushort_as_bfloat16(d);
  }
}

// Whether p may be read or written four elements of T at a time.
template <typename T>
inline bool aligned4(const void* p) {
  return p == nullptr ||
         (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

}  // namespace bf16x4
