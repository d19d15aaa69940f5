// Four elements at a time in f32, bf16 or fp16, for the kernels of this
// directory whose state operands come in any of these dtypes.
//
// Widening a 16-bit float to f32 is exact: a bf16 is the high half of an
// f32 (a shift), an fp16 converts exactly (subnormals included).
// Narrowing rounds to nearest even and writes the bits PyTorch's CPU
// conversion writes, so a kernel's 16-bit output is the bits of its plain
// version's `.to(dtype)`:
// * bf16: c10::BFloat16's round_to_nearest_even, written out, every NaN
//   0x7fc0;
// * fp16: __float2half_rn for every number (subnormals kept, overflow to
//   +-inf), and a NaN as the CPU's F16C conversion writes it: its sign,
//   quiet, the top 10 bits of its payload (0x7e00 / 0xfe00 for torch's
//   NaN), where __float2half_rn writes one canonical NaN.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace lowp4 {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// The 16-bit dtypes' bits <-> f32.
template <typename T>
__device__ __forceinline__ float widen(uint16_t h);
template <>
__device__ __forceinline__ float widen<bf16>(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}
template <>
__device__ __forceinline__ float widen<f16>(uint16_t h) {
  return __half2float(__ushort_as_half(h));
}

template <typename T>
__device__ __forceinline__ uint16_t narrow(float x);
template <>
__device__ __forceinline__ uint16_t narrow<bf16>(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
template <>
__device__ __forceinline__ uint16_t narrow<f16>(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    return (uint16_t)(((u >> 16) & 0x8000u) | 0x7e00u | ((u >> 13) & 0x3ffu));
  }
  return __half_as_ushort(__float2half_rn(x));
}

__device__ __forceinline__ uint16_t bits(bf16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint16_t bits(f16 x) { return __half_as_ushort(x); }

template <typename T>
__device__ __forceinline__ T from_bits(uint16_t h);
template <>
__device__ __forceinline__ bf16 from_bits<bf16>(uint16_t h) {
  return __ushort_as_bfloat16(h);
}
template <>
__device__ __forceinline__ f16 from_bits<f16>(uint16_t h) {
  return __ushort_as_half(h);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return widen<bf16>(bits(x)); }
__device__ __forceinline__ float to_f32(f16 x) { return widen<f16>(bits(x)); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  return from_bits<T>(narrow<T>(x));
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Elements [0, 4) of p as f32: one 16-byte (f32) or 8-byte (16-bit) load
// when VEC (p aligned to 4 elements), else four loads.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
template <bool VEC, typename T>
__device__ __forceinline__ float4 load4_16(const T* p) {
  if (VEC) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_float4(widen<T>((uint16_t)(w.x & 0xffffu)),
                       widen<T>((uint16_t)(w.x >> 16)),
                       widen<T>((uint16_t)(w.y & 0xffffu)),
                       widen<T>((uint16_t)(w.y >> 16)));
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]),
                     to_f32(p[3]));
}
template <bool VEC>
__device__ __forceinline__ float4 load4(const bf16* p) {
  return load4_16<VEC>(p);
}
template <bool VEC>
__device__ __forceinline__ float4 load4(const f16* p) {
  return load4_16<VEC>(p);
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
template <bool VEC, bool STREAM, typename T>
__device__ __forceinline__ void store4_16(T* p, float4 v) {
  const uint16_t a = narrow<T>(v.x), b = narrow<T>(v.y), c = narrow<T>(v.z),
                 d = narrow<T>(v.w);
  if (VEC) {
    const uint2 w = make_uint2((uint32_t)a | ((uint32_t)b << 16),
                               (uint32_t)c | ((uint32_t)d << 16));
    if (STREAM) {
      __stcs(reinterpret_cast<uint2*>(p), w);
    } else {
      *reinterpret_cast<uint2*>(p) = w;
    }
  } else {
    p[0] = from_bits<T>(a); p[1] = from_bits<T>(b);
    p[2] = from_bits<T>(c); p[3] = from_bits<T>(d);
  }
}
template <bool VEC, bool STREAM = false>
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  store4_16<VEC, STREAM>(p, v);
}
template <bool VEC, bool STREAM = false>
__device__ __forceinline__ void store4(f16* p, float4 v) {
  store4_16<VEC, STREAM>(p, v);
}

// Whether p may be read or written four elements of T at a time.
template <typename T>
inline bool aligned4(const void* p) {
  return p == nullptr ||
         (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

}  // namespace lowp4
