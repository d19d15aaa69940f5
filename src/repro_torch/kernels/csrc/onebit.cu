// Error-feedback 1-bit compression kernels for Hopper (sm_90a): the
// two-pass and the single-pass sign compressors of the 0/1 Adam exchange
// and their decoder.
//
// All four work on a 2-D (rows, cols) f32 frame of a comm view, with
// cols a multiple of 8. counts[r] is the number of true (unpadded)
// elements of row r; the mask is rebuilt as `col < counts[r]`.
//
// abs_rowsum   replaces src/repro/kernels/onebit.py::abs_rowsum
//              out[r] = sum_{c < counts[r]} |z + err|
// ef_quantize  replaces src/repro/kernels/onebit.py::ef_quantize
//              packed bit (z + err >= 0), 8 per byte, element 0 in the
//              MSB; err_out = mask * (zw - (bit ? s : -s)), s = scales[r]
// ef_compress  replaces src/repro/kernels/onebit.py::ef_compress
//              single pass with per-row scales: s[r] = abs_rowsum[r] /
//              max(counts[r], 1), then ef_quantize's bits and err_out
// decompress   replaces src/repro/kernels/onebit.py::decompress
//              out = (bit ? s : -s), s = scales[r]
//
// Bound: bytes, for every kernel. abs_rowsum reads 8 bytes per true
// element; ef_quantize reads 8 and writes 4.125 bytes per element;
// ef_compress the same as ef_quantize plus 4 bytes of scale per row;
// decompress reads 0.125 and writes 4 bytes per element. The arithmetic
// is an add, a compare and a subtract per element.
//
// Design:
// * abs_rowsum gives each row one block of 256 threads that loops over
//   the row (frames reach 50,432 columns, far more than a block holds),
//   16 bytes per thread per load, stopping at counts[r]: a pad row
//   (counts[r] == 0) reads nothing and writes 0. The block reduces with
//   warp shuffles and one shared-memory pass.
// * ef_quantize and decompress give each thread one packed byte, i.e.
//   8 consecutive elements of one row: two float4 loads per operand, one
//   byte and two float4 stores. The bit order is written out per element
//   (bit 7 - k for element k), so no ballot and no bit reversal is needed.
//   A grid-stride loop covers the frame.
// * ef_compress needs a row's sum before it can quantize the row, and a
//   row reaches 30,720 f32 (120 KB). One block per row sweeps its row
//   twice: abs_rowsum's loop and reduction, the scale through shared
//   memory, then ef_quantize's per-byte loop over the same row (the second
//   read of a row that fits in L2 is mostly a hit). Keeping the row in
//   shared memory instead is left for a later change.
// * Compiled with -fmad=false; the arithmetic is a single add or subtract
//   per element and one IEEE divide per row, so kernel and plain version
//   round identically given the same row sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)(b < 1 ? 1 : b);
}

// Masked L1 sum of one row, reduced over the block; the total is valid
// in thread 0 only.
__device__ float row_abs_sum(const float* __restrict__ zr,
                             const float* __restrict__ er, int64_t cnt,
                             bool vec) {
  float acc = 0.f;
  int64_t start = 0;
  if (vec) {
    const int64_t n4 = cnt / 4;
    const float4* z4 = reinterpret_cast<const float4*>(zr);
    const float4* e4 = reinterpret_cast<const float4*>(er);
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 a = z4[i], b = e4[i];
      acc = __fadd_rn(acc, fabsf(__fadd_rn(a.x, b.x)));
      acc = __fadd_rn(acc, fabsf(__fadd_rn(a.y, b.y)));
      acc = __fadd_rn(acc, fabsf(__fadd_rn(a.z, b.z)));
      acc = __fadd_rn(acc, fabsf(__fadd_rn(a.w, b.w)));
    }
    start = n4 * 4;
  }
  for (int64_t c = start + threadIdx.x; c < cnt; c += blockDim.x) {
    acc = __fadd_rn(acc, fabsf(__fadd_rn(zr[c], er[c])));
  }
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = acc;
  __syncthreads();
  if (wid == 0) {
    acc = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
  }
  return acc;
}

__device__ __forceinline__ int64_t row_count(const int* counts, int64_t r,
                                             int64_t cols) {
  int64_t cnt = counts[r];
  if (cnt < 0) cnt = 0;
  if (cnt > cols) cnt = cols;
  return cnt;
}

__global__ void abs_rowsum_kernel(const float* __restrict__ z,
                                  const float* __restrict__ err,
                                  const int* __restrict__ counts,
                                  float* __restrict__ out, int64_t cols,
                                  bool vec) {
  const int64_t r = blockIdx.x;
  const float acc = row_abs_sum(z + r * cols, err + r * cols,
                                row_count(counts, r, cols), vec);
  if (threadIdx.x == 0) out[r] = acc;
}

__device__ __forceinline__ void load8(const float* p, bool vec, float* v) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[k];
  }
}

__device__ __forceinline__ void store8(float* p, bool vec, const float* v) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = v[k];
  }
}

// Signs and error feedback of the 8 elements [c0, c0 + 8) of one row.
__device__ __forceinline__ void quantize8(const float* __restrict__ zp,
                                          const float* __restrict__ ep,
                                          float s, int64_t c0, int64_t cnt,
                                          bool vec, uint8_t* __restrict__ pb,
                                          float* __restrict__ op) {
  float zv[8], ev[8], eo[8];
  load8(zp, vec, zv);
  load8(ep, vec, ev);
  unsigned byte = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float zw = __fadd_rn(zv[k], ev[k]);
    const bool bit = zw >= 0.f;
    byte |= (unsigned)bit << (7 - k);
    eo[k] = (c0 + k < cnt) ? __fsub_rn(zw, bit ? s : -s) : 0.f;
  }
  *pb = (uint8_t)byte;
  store8(op, vec, eo);
}

__global__ void ef_quantize_kernel(const float* __restrict__ z,
                                   const float* __restrict__ err,
                                   const float* __restrict__ scales,
                                   const int* __restrict__ counts,
                                   uint8_t* __restrict__ packed,
                                   float* __restrict__ err_out,
                                   int64_t rows, int64_t cols, bool vec) {
  const int64_t cb = cols / 8;
  const int64_t nbytes = rows * cb;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < nbytes; i += stride) {
    const int64_t r = i / cb;
    const int64_t c0 = (i - r * cb) * 8;
    const int64_t off = r * cols + c0;
    quantize8(z + off, err + off, scales[r], c0, counts[r], vec, packed + i,
              err_out + off);
  }
}

__global__ void ef_compress_kernel(const float* __restrict__ z,
                                   const float* __restrict__ err,
                                   const int* __restrict__ counts,
                                   uint8_t* __restrict__ packed,
                                   float* __restrict__ scales,
                                   float* __restrict__ err_out,
                                   int64_t cols, bool vec) {
  const int64_t r = blockIdx.x;
  const int64_t cnt = row_count(counts, r, cols);
  const float* zr = z + r * cols;
  const float* er = err + r * cols;
  __shared__ float row_scale;
  const float sum = row_abs_sum(zr, er, cnt, vec);
  if (threadIdx.x == 0) {
    const float s = __fdiv_rn(sum, (float)(cnt > 1 ? cnt : 1));
    scales[r] = s;
    row_scale = s;
  }
  __syncthreads();
  const float s = row_scale;
  const int64_t cb = cols / 8;
  for (int64_t b = threadIdx.x; b < cb; b += blockDim.x) {
    quantize8(zr + b * 8, er + b * 8, s, b * 8, cnt, vec,
              packed + r * cb + b, err_out + r * cols + b * 8);
  }
}

__global__ void decompress_kernel(const uint8_t* __restrict__ packed,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, int64_t rows,
                                  int64_t cb, bool vec) {
  const int64_t nbytes = rows * cb;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < nbytes; i += stride) {
    const int64_t r = i / cb;
    const float s = scales[r];
    const unsigned b = packed[i];
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = ((b >> (7 - k)) & 1u) ? s : -s;
    store8(out + i * 8, vec, o);
  }
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).

extern "C" int abs_rowsum_f32(const void* z, const void* err,
                              const void* counts, void* out, long long rows,
                              long long cols, void* stream) {
  if (rows <= 0) return 0;
  const bool vec = cols % 4 == 0 && aligned16(z) && aligned16(err);
  abs_rowsum_kernel<<<(unsigned)rows, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(err),
      static_cast<const int*>(counts), static_cast<float*>(out), cols, vec);
  return (int)cudaGetLastError();
}

extern "C" int ef_quantize_f32(const void* z, const void* err,
                               const void* scales, const void* counts,
                               void* packed, void* err_out, long long rows,
                               long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (cols % 8) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(z) && aligned16(err) && aligned16(err_out);
  ef_quantize_kernel<<<blocks_for(rows * (cols / 8)), kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(err),
      static_cast<const float*>(scales), static_cast<const int*>(counts),
      static_cast<uint8_t*>(packed), static_cast<float*>(err_out), rows,
      cols, vec);
  return (int)cudaGetLastError();
}

extern "C" int ef_compress_f32(const void* z, const void* err,
                               const void* counts, void* packed,
                               void* scales, void* err_out, long long rows,
                               long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (cols % 8) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(z) && aligned16(err) && aligned16(err_out);
  ef_compress_kernel<<<(unsigned)rows, kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(err),
      static_cast<const int*>(counts), static_cast<uint8_t*>(packed),
      static_cast<float*>(scales), static_cast<float*>(err_out), cols, vec);
  return (int)cudaGetLastError();
}

extern "C" int decompress_f32(const void* packed, const void* scales,
                              void* out, long long rows, long long cols,
                              void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (cols % 8) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(out);
  decompress_kernel<<<blocks_for(rows * (cols / 8)), kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<float*>(out), rows, cols / 8, vec);
  return (int)cudaGetLastError();
}
