// Fused local half-steps of the 0/1 optimizers for Hopper (sm_90a), one
// per base kind. Both update the optimizer state in place.
//
// fused_local_step      replaces src/repro/kernels/fused_adam.py::
//                       fused_local_step (Adam base):
//   m <- fma(b1, m, omb1 * g)        omb1 = 1 - b1, folded on the host
//   u <- fma(lr, m, u)               with the new m
//   d  = (lr * m) / sqrt(v + eps)
//
// fused_local_step_sgd  replaces src/repro/kernels/fused_adam.py::
//                       fused_local_step_sgd (momentum-SGD base):
//   m <- fma(b1, m, omb1 * g)
//   u <- fma(lr, m, u)               from the new m, not as u + d
//   d  = lr * m
//
// Operand dtypes: the gradient g in f32 or bf16 (the parameter dtype),
// the state m, u, v all in one dtype, f32, bf16 or fp16 (state_dtype),
// u' into uo, f32 or the state dtype, and d always f32. Every operand is
// widened to f32 on load (exact), the arithmetic is f32, and each output
// is rounded once, to nearest even, to its own dtype (lowp4.cuh: the
// bits of PyTorch's CPU conversion): m' and a 16-bit u' are
// what the reference rounds at the end of its step, while a sync step's
// exchange reads an f32 u' (uo then an f32 buffer of the caller's) and d
// stays f32 for x_half = x - d.
//
// In place: m is read and written through one pointer, uo may be u, and
// d may be the gradient's own buffer (an f32 gradient, dead after the
// step). Each element is read once and written once by one thread, every
// load before any store, so the aliased pointers carry no __restrict__
// (v, only read, is the one operand that aliases nothing).
//
// Bound: bytes. The Adam step reads g, m, u, v and writes m, u, d: 28
// bytes per element in f32, 16 with bf16 g and a 16-bit state and u'
// (18 with an f32 u'); the SGD step reads three and writes three, 24
// bytes in f32, 14 with 16-bit operands. Both do a handful of flops per element, far below
// the card's ridge point; nothing is reused, so there is nothing to tile.
//
// Design: one grid-stride loop over the flat element range. Each thread
// moves four elements per operand per iteration (16 bytes of f32, 8 of
// a 16-bit dtype) when every pointer is aligned to four of its elements and the
// length is a multiple of 4, else one element. The grid is capped at a
// few waves of blocks so the loop, not the launch, covers the widest
// frames (up to 155M elements when four workers stack). One template
// serves both kinds and every dtype; the SGD instance never touches v.
//
// Rounding: the two FMAs are written out with __fmaf_rn, the divide and
// square root with __fdiv_rn / __fsqrt_rn, and the file is compiled with
// -fmad=false so nvcc contracts nothing else. That pins m' and u' (and
// the SGD step's d) to the single-rounding results the reference's XLA
// build produces, and lets the plain PyTorch versions reproduce them bit
// for bit. XLA contracts u' = u + lr * m' into an FMA even where d = lr * m'
// is written out, so the SGD step computes u' from m' and not as u + d.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lowp4.cuh"

namespace {

using lowp4::bf16;
using lowp4::f16;
using lowp4::load4;
using lowp4::store4;

struct Scalars {
  float lr, b1, omb1, eps;
};

template <bool kSgd>
__device__ __forceinline__ void step_one(float g, float m, float u, float v,
                                         const Scalars& s, float* mo,
                                         float* uo, float* d) {
  const float mh = __fmaf_rn(s.b1, m, __fmul_rn(s.omb1, g));
  *mo = mh;
  *uo = __fmaf_rn(s.lr, mh, u);
  if (kSgd) {
    *d = __fmul_rn(s.lr, mh);
  } else {
    *d = __fdiv_rn(__fmul_rn(s.lr, mh), __fsqrt_rn(__fadd_rn(v, s.eps)));
  }
}

template <bool kSgd, typename G, typename S, typename U>
__global__ void local_step_vec4(const G* g, S* m, const S* u, U* uo,
                                const S* __restrict__ v, float* d,
                                int64_t n4, Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 gg = load4<true>(g + 4 * i), mm = load4<true>(m + 4 * i),
                 uu = load4<true>(u + 4 * i);
    const float4 vv =
        kSgd ? make_float4(0.f, 0.f, 0.f, 0.f) : load4<true>(v + 4 * i);
    float4 mo, u4, dd;
    step_one<kSgd>(gg.x, mm.x, uu.x, vv.x, s, &mo.x, &u4.x, &dd.x);
    step_one<kSgd>(gg.y, mm.y, uu.y, vv.y, s, &mo.y, &u4.y, &dd.y);
    step_one<kSgd>(gg.z, mm.z, uu.z, vv.z, s, &mo.z, &u4.z, &dd.z);
    step_one<kSgd>(gg.w, mm.w, uu.w, vv.w, s, &mo.w, &u4.w, &dd.w);
    store4<true>(m + 4 * i, mo);
    store4<true>(uo + 4 * i, u4);
    store4<true>(d + 4 * i, dd);
  }
}

template <bool kSgd, typename G, typename S, typename U>
__global__ void local_step_scalar(const G* g, S* m, const S* u, U* uo,
                                  const S* __restrict__ v, float* d,
                                  int64_t n, Scalars s) {
  using lowp4::from_f32;
  using lowp4::to_f32;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gg = to_f32(g[i]), mm = to_f32(m[i]), uu = to_f32(u[i]);
    const float vv = kSgd ? 0.f : to_f32(v[i]);
    float mo, u1, dd;
    step_one<kSgd>(gg, mm, uu, vv, s, &mo, &u1, &dd);
    m[i] = from_f32<S>(mo);
    uo[i] = from_f32<U>(u1);
    d[i] = dd;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;  // 8 blocks per SM of an H100

int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)(b < 1 ? 1 : b);
}

template <bool kSgd, typename G, typename S, typename U>
int launch(const void* g, void* m, const void* u, void* uo, const void* v,
           void* d, long long n, const Scalars& s, cudaStream_t st) {
  using lowp4::aligned4;
  const bool vec = (n % 4 == 0) && aligned4<G>(g) && aligned4<S>(m) &&
                   aligned4<S>(u) && aligned4<U>(uo) && aligned4<S>(v) &&
                   aligned4<float>(d);
  const G* gp = static_cast<const G*>(g);
  S* mp = static_cast<S*>(m);
  const S* up = static_cast<const S*>(u);
  U* op = static_cast<U*>(uo);
  const S* vp = static_cast<const S*>(v);
  float* dp = static_cast<float*>(d);
  if (vec) {
    const int64_t n4 = n / 4;
    local_step_vec4<kSgd, G, S, U><<<blocks_for(n4), kThreads, 0, st>>>(
        gp, mp, up, op, vp, dp, n4, s);
  } else {
    local_step_scalar<kSgd, G, S, U><<<blocks_for(n), kThreads, 0, st>>>(
        gp, mp, up, op, vp, dp, n, s);
  }
  return (int)cudaGetLastError();
}

// The operand dtypes as bits of `types`: 1 a bf16 gradient (else f32), 2
// a bf16 state (m, u, v), 8 an fp16 state (neither: f32), 4 u' in the
// state's 16-bit dtype (else uo is f32).
template <bool kSgd>
int launch_typed(const void* g, void* m, const void* u, void* uo,
                 const void* v, void* d, long long n, const Scalars& s,
                 long long types, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (types) {
    case 0: return launch<kSgd, float, float, float>(g, m, u, uo, v, d, n, s, st);
    case 1: return launch<kSgd, bf16, float, float>(g, m, u, uo, v, d, n, s, st);
    case 2: return launch<kSgd, float, bf16, float>(g, m, u, uo, v, d, n, s, st);
    case 3: return launch<kSgd, bf16, bf16, float>(g, m, u, uo, v, d, n, s, st);
    case 6: return launch<kSgd, float, bf16, bf16>(g, m, u, uo, v, d, n, s, st);
    case 7: return launch<kSgd, bf16, bf16, bf16>(g, m, u, uo, v, d, n, s, st);
    case 8: return launch<kSgd, float, f16, float>(g, m, u, uo, v, d, n, s, st);
    case 9: return launch<kSgd, bf16, f16, float>(g, m, u, uo, v, d, n, s, st);
    case 12: return launch<kSgd, float, f16, f16>(g, m, u, uo, v, d, n, s, st);
    case 13: return launch<kSgd, bf16, f16, f16>(g, m, u, uo, v, d, n, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// m is updated in place; uo may equal u; d may equal g (f32 g only).

extern "C" int fused_local_step(const void* g, void* m, const void* u,
                                void* uo, const void* v, void* d,
                                long long n, float lr, float b1, float omb1,
                                float eps, long long types, void* stream) {
  return launch_typed<false>(g, m, u, uo, v, d, n,
                             Scalars{lr, b1, omb1, eps}, types, stream);
}

extern "C" int fused_local_step_sgd(const void* g, void* m, const void* u,
                                    void* uo, void* d, long long n, float lr,
                                    float b1, float omb1, long long types,
                                    void* stream) {
  return launch_typed<true>(g, m, u, uo, nullptr, d, n,
                            Scalars{lr, b1, omb1, 0.f}, types, stream);
}
