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
// In place: m and u are read and written through the same pointers, and
// d may be the gradient's own buffer (the caller's gradient is dead after
// the step). Each element is read once and written once by one thread,
// every load before any store, so the aliased pointers carry no
// __restrict__ (v, only read, is the one operand that aliases nothing).
//
// Bound: bytes. The Adam step reads four f32 operands and writes three,
// 28 bytes per element; the SGD step reads three and writes three, 24
// bytes per element. Both do a handful of flops per element, far below
// the card's ridge point; nothing is reused, so there is nothing to tile.
//
// Design: one grid-stride loop over the flat element range. Each thread
// moves 16 bytes per operand per iteration (float4) when every pointer is
// 16-byte aligned and the length is a multiple of 4, else one element.
// The grid is capped at a few waves of blocks so the loop, not the launch,
// covers the widest frames (up to 155M elements when four workers stack).
// One template serves both kinds; the SGD instance never touches v.
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

namespace {

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

template <bool kSgd>
__global__ void local_step_vec4(const float4* g, float4* m, float4* u,
                                const float4* __restrict__ v, float4* d,
                                int64_t n4, Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 gg = g[i], mm = m[i], uu = u[i];
    const float4 vv = kSgd ? make_float4(0.f, 0.f, 0.f, 0.f) : v[i];
    float4 mo, uo, dd;
    step_one<kSgd>(gg.x, mm.x, uu.x, vv.x, s, &mo.x, &uo.x, &dd.x);
    step_one<kSgd>(gg.y, mm.y, uu.y, vv.y, s, &mo.y, &uo.y, &dd.y);
    step_one<kSgd>(gg.z, mm.z, uu.z, vv.z, s, &mo.z, &uo.z, &dd.z);
    step_one<kSgd>(gg.w, mm.w, uu.w, vv.w, s, &mo.w, &uo.w, &dd.w);
    m[i] = mo;
    u[i] = uo;
    d[i] = dd;
  }
}

template <bool kSgd>
__global__ void local_step_scalar(const float* g, float* m, float* u,
                                  const float* __restrict__ v, float* d,
                                  int64_t n, Scalars s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gg = g[i], mm = m[i], uu = u[i];
    const float vv = kSgd ? 0.f : v[i];
    float mo, uo, dd;
    step_one<kSgd>(gg, mm, uu, vv, s, &mo, &uo, &dd);
    m[i] = mo;
    u[i] = uo;
    d[i] = dd;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;  // 8 blocks per SM of an H100

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)(b < 1 ? 1 : b);
}

template <bool kSgd>
int launch(const void* g, void* m, void* u, const void* v, void* d,
           long long n, const Scalars& s, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = (n % 4 == 0) && aligned16(g) && aligned16(m) &&
                   aligned16(u) && aligned16(v) && aligned16(d);
  if (vec) {
    const int64_t n4 = n / 4;
    local_step_vec4<kSgd><<<blocks_for(n4), kThreads, 0, st>>>(
        static_cast<const float4*>(g), static_cast<float4*>(m),
        static_cast<float4*>(u), static_cast<const float4*>(v),
        static_cast<float4*>(d), n4, s);
  } else {
    local_step_scalar<kSgd><<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<float*>(m),
        static_cast<float*>(u), static_cast<const float*>(v),
        static_cast<float*>(d), n, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// m and u are updated in place; d may equal g.

extern "C" int fused_local_step_f32(const void* g, void* m, void* u,
                                    const void* v, void* d, long long n,
                                    float lr, float b1, float omb1,
                                    float eps, void* stream) {
  return launch<false>(g, m, u, v, d, n, Scalars{lr, b1, omb1, eps},
                       stream);
}

extern "C" int fused_local_step_sgd_f32(const void* g, void* m, void* u,
                                        void* d, long long n, float lr,
                                        float b1, float omb1, void* stream) {
  return launch<true>(g, m, u, nullptr, d, n, Scalars{lr, b1, omb1, 0.f},
                      stream);
}
