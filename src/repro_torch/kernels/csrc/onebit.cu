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
// * ef_quantize gives each thread one packed byte, i.e. 8 consecutive
//   elements of one row: two float4 loads per operand, one byte and two
//   float4 stores. The bit order is written out per element (bit 7 - k
//   for element k), so no ballot and no bit reversal is needed. A
//   grid-stride loop covers the frame.
// * decompress is 97% stores (4 of its 4.125 bytes per element), so its
//   design is about the stores. The frame is decoded as one flat run of
//   packed bytes: a warp takes a chunk of 128 bytes (1,024 outputs), each
//   lane loads 4 of them as one 32-bit word, and the lanes hand the words
//   round with __shfl_sync so that lane l writes float4 k*32 + l of the
//   chunk (k = 0..7): every warp store is one contiguous 512-byte run. A
//   float4 is half a packed byte (the high nibble for the even float4).
//   The row of a byte, for its scale, is a 32-bit multiply-shift by a
//   reciprocal of the packed row width computed on the host (exact for
//   frames under 2^31 packed bytes, which the wrapper enforces): no
//   divide. One warp per chunk, no grid-stride loop (measured faster);
//   the stores are streaming (__stcs), which also measured faster.
// * ef_compress needs a row's sum before it can quantize the row, and a
//   row reaches 50,432 f32 (30,720 at BERT's vocabulary; 240 KB of z and
//   err), too much for one block's shared memory and, over ~1,000
//   resident rows, for L2. So a row goes to a thread-block cluster of 1-8
//   blocks, each owning a slice of the row whose width is a multiple of 8
//   columns (no packed byte straddles two blocks); cluster size and slice
//   width come from the host (kernels/onebit.py::ef_compress_geometry).
//   Each block reads its slice of z and err once (float4, four loads of
//   each in flight per thread), keeps zw = z + err in shared memory (up to
//   7,680 columns, 30 KB: seven 256-thread blocks then fit on an SM; a
//   slice wider than that keeps its head and re-reads only the excess
//   from device memory) and reduces its masked partial sum of |zw|. After
//   cluster.sync() every block reads all the partials through distributed
//   shared memory, so every block derives the same scale; rank 0 writes
//   it. Then each block quantizes what it kept: lane pairs join two
//   nibbles into a byte, and the err_out stores are contiguous float4s
//   per warp. A second cluster.sync() ends each row, so no block's shared
//   memory is read after that block moved on or exited.
//   Summation order of a row (fixed, so the scale is the same from run to
//   run): each thread adds its elements in column order (float4 j = t,
//   t + 256, ... of its block's slice, x, y, z, w); the 32 lanes of a
//   warp then fold by __shfl_down (offsets 16, 8, 4, 2, 1), warp 0 folds
//   the 8 warps' sums the same way, and the blocks' partials are added in
//   rank order. The plain version sums in torch's order, so the scales
//   agree to a few ulp, not bit for bit.
// * Compiled with -fmad=false; the arithmetic is a single add or subtract
//   per element and one IEEE divide per row, so kernel and plain version
//   round identically given the same row sum.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kMaxRowsGrid = 65535;     // gridDim.y limit
// ef_compress: float4 loads of each operand in flight per thread
constexpr int kUnroll = 4;
// decompress: packed bytes one warp decodes at a time (1,024 outputs)
constexpr uint32_t kChunk = 128;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)(b < 1 ? 1 : b);
}

// Sum of acc over the block: warp shuffles, then the warps' sums the same
// way. The total is valid in thread 0 only; warp_sums is free again after
// the caller's next block-wide barrier.
__device__ float block_sum(float acc, float* warp_sums) {
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
  return block_sum(acc, warp_sums);
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

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// Streaming store (__stcs, evict-first): the outputs are written once and
// read by a later kernel, so they need not displace the inputs in L2
// (measured faster for decompress, PERF.md).
template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v) {
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// acc + the masked |zw| of the 4 elements from column c, in element order
__device__ __forceinline__ float add_abs4(float acc, float4 zw, int c,
                                          int cnt) {
  acc = __fadd_rn(acc, c < cnt ? fabsf(zw.x) : 0.f);
  acc = __fadd_rn(acc, c + 1 < cnt ? fabsf(zw.y) : 0.f);
  acc = __fadd_rn(acc, c + 2 < cnt ? fabsf(zw.z) : 0.f);
  acc = __fadd_rn(acc, c + 3 < cnt ? fabsf(zw.w) : 0.f);
  return acc;
}

__device__ __forceinline__ float ef1(float zw, float s, bool keep) {
  return keep ? __fsub_rn(zw, zw >= 0.f ? s : -s) : 0.f;
}

// The 4 sign bits of the elements from column c (element 0 in bit 3) and
// their error feedback in *eo.
__device__ __forceinline__ unsigned quantize4(float4 zw, float s, int c,
                                              int cnt, float4* eo) {
  *eo = make_float4(ef1(zw.x, s, c < cnt), ef1(zw.y, s, c + 1 < cnt),
                    ef1(zw.z, s, c + 2 < cnt), ef1(zw.w, s, c + 3 < cnt));
  return ((unsigned)(zw.x >= 0.f) << 3) | ((unsigned)(zw.y >= 0.f) << 2) |
         ((unsigned)(zw.z >= 0.f) << 1) | (unsigned)(zw.w >= 0.f);
}

// One cluster of gridDim.x blocks per row (grid-strided over rows along
// y); block `rank` owns columns [rank * slice, min(cols, (rank+1) * slice))
// and keeps the first `kept` of them in shared memory.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ef_compress_kernel(const float* __restrict__ z,
                   const float* __restrict__ err,
                   const int* __restrict__ counts,
                   uint8_t* __restrict__ packed,
                   float* __restrict__ scales,
                   float* __restrict__ err_out, int64_t rows, int cols,
                   int slice, int kept) {
  extern __shared__ float4 zw_kept[];
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float part;          // this block's masked sum of the row
  __shared__ float row_scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nrank = (int)cluster.num_blocks();
  const int c_lo = rank * slice;
  const int c_hi = min(cols, c_lo + slice);
  const int units = c_hi > c_lo ? (c_hi - c_lo) / 4 : 0;   // even
  const int kept_units = min(units, kept / 4);
  const int t = threadIdx.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int cnt = (int)row_count(counts, r, cols);
    const int64_t off = r * cols + c_lo;
    const float* zr = z + off;
    const float* er = err + off;
    float acc = 0.f;
    for (int j0 = 0; j0 < units; j0 += kThreads * kUnroll) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads + t;
        if (j < units) {
          a[u] = load4<VEC>(zr + 4 * j);
          b[u] = load4<VEC>(er + 4 * j);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads + t;
        if (j < units) {
          const float4 zw = add4(a[u], b[u]);
          if (j < kept_units) zw_kept[j] = zw;
          acc = add_abs4(acc, zw, c_lo + 4 * j, cnt);
        }
      }
    }
    acc = block_sum(acc, warp_sums);
    if (t == 0) part = acc;
    cluster.sync();
    if (t == 0) {
      float sum = 0.f;
      for (int q = 0; q < nrank; ++q) {
        sum = __fadd_rn(sum, *cluster.map_shared_rank(&part, q));
      }
      const float s = __fdiv_rn(sum, (float)(cnt > 1 ? cnt : 1));
      row_scale = s;
      if (rank == 0) scales[r] = s;
    }
    __syncthreads();
    const float s = row_scale;
    uint8_t* pr = packed + r * (cols / 8) + c_lo / 8;
    float* eo_r = err_out + off;
    // units is even and j0 a multiple of 256, so lanes 2i and 2i+1 hold
    // the two halves of one packed byte, or neither
    for (int j0 = 0; j0 < units; j0 += kThreads) {
      const int j = j0 + t;
      unsigned nib = 0;
      if (j < units) {
        const float4 zw = j < kept_units
                              ? zw_kept[j]
                              : add4(load4<VEC>(zr + 4 * j),
                                     load4<VEC>(er + 4 * j));
        float4 eo;
        nib = quantize4(zw, s, c_lo + 4 * j, cnt, &eo);
        store4<VEC>(eo_r + 4 * j, eo);
      }
      const unsigned low = __shfl_xor_sync(0xffffffffu, nib, 1);
      if (j < units && !(t & 1)) pr[j >> 1] = (uint8_t)((nib << 4) | low);
    }
    cluster.sync();
  }
}

// One chunk of kChunk packed bytes per warp.
// Row of byte b: (b * mul) >> shift == b / cb for b < 2^31.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
decompress_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ scales,
                  float* __restrict__ out, uint32_t nbytes, uint32_t mul,
                  uint32_t shift, bool words) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t base = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) *
                        kChunk;
  if (base >= nbytes) return;   // whole warps only: the shuffles need all
  // this lane's bytes [base + 4 lane, +4), the first in the low 8 bits
  const uint32_t b0 = base + 4 * lane;
  uint32_t w = 0;
  if (words && base + kChunk <= nbytes) {
    w = reinterpret_cast<const uint32_t*>(packed)[b0 >> 2];
  } else {
#pragma unroll
    for (uint32_t k = 0; k < 4; ++k) {
      if (b0 + k < nbytes) w |= (uint32_t)packed[b0 + k] << (8 * k);
    }
  }
#pragma unroll
  for (uint32_t k = 0; k < kChunk / 16; ++k) {
    // float4 k*32 + lane of the chunk is half of byte k*16 + lane/2,
    // which lane 4k + lane/8 loaded
    const uint32_t wk = __shfl_sync(0xffffffffu, w, 4 * k + (lane >> 3));
    const uint32_t b = base + 16 * k + (lane >> 1);
    if (b < nbytes) {
      const uint32_t byte = (wk >> (8 * ((lane >> 1) & 3))) & 0xffu;
      const uint32_t nib = (lane & 1) ? (byte & 15u) : (byte >> 4);
      const float s =
          scales[(uint32_t)(((uint64_t)b * mul) >> shift)];
      store4<VEC>(out + 4 * (2 * (uint64_t)b + (lane & 1)),
                  make_float4((nib & 8u) ? s : -s, (nib & 4u) ? s : -s,
                              (nib & 2u) ? s : -s, (nib & 1u) ? s : -s));
    }
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

// cluster, slice and kept come from kernels/onebit.py::ef_compress_geometry.
extern "C" int ef_compress_f32(const void* z, const void* err,
                               const void* counts, void* packed,
                               void* scales, void* err_out, long long rows,
                               long long cols, long long cluster,
                               long long slice, long long kept,
                               void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  // (cols < 2^28 keeps every column index of the kernel in 32 bits)
  if (cols % 8 || cols >= (1LL << 28) || cluster < 1 || cluster > 8 ||
      slice <= 0 || slice % 8 || slice > cols || cluster * slice < cols ||
      kept < 4 || kept % 4 || kept > slice) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster,
                     (unsigned)(rows < kMaxRowsGrid ? rows : kMaxRowsGrid),
                     1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)kept * sizeof(float);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = aligned16(z) && aligned16(err) && aligned16(err_out);
  // beyond the default 48 KB of shared memory (static included) a kernel
  // must be allowed more: once, and again only for a larger size
  static size_t smem_set[2] = {47 * 1024, 47 * 1024};
  if (cfg.dynamicSmemBytes > smem_set[vec]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        vec ? ef_compress_kernel<true> : ef_compress_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    smem_set[vec] = cfg.dynamicSmemBytes;
  }
  const float* zp = static_cast<const float*>(z);
  const float* ep = static_cast<const float*>(err);
  const int* cp = static_cast<const int*>(counts);
  uint8_t* pp = static_cast<uint8_t*>(packed);
  float* sp = static_cast<float*>(scales);
  float* op = static_cast<float*>(err_out);
  const int64_t r64 = rows;
  const int c32 = (int)cols, s32 = (int)slice, k32 = (int)kept;
  const cudaError_t rc =
      vec ? cudaLaunchKernelEx(&cfg, ef_compress_kernel<true>, zp, ep, cp,
                               pp, sp, op, r64, c32, s32, k32)
          : cudaLaunchKernelEx(&cfg, ef_compress_kernel<false>, zp, ep, cp,
                               pp, sp, op, r64, c32, s32, k32);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// mul and shift come from kernels/onebit.py::decompress_divisor.
extern "C" int decompress_f32(const void* packed, const void* scales,
                              void* out, long long rows, long long cols,
                              long long mul, long long shift, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long nbytes = rows * (cols / 8);
  if (cols % 8 || nbytes >= (1LL << 31) || mul <= 0 || mul >= (1LL << 32) ||
      shift < 0 || shift > 62) {
    return (int)cudaErrorInvalidValue;
  }
  const bool words = (reinterpret_cast<uintptr_t>(packed) & 3u) == 0;
  const unsigned blocks = (unsigned)(
      ((nbytes + kChunk - 1) / kChunk * 32 + kThreads - 1) / kThreads);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  if (aligned16(out)) {
    decompress_kernel<true><<<blocks, kThreads, 0, st>>>(
        pp, sp, op, (uint32_t)nbytes, (uint32_t)mul, (uint32_t)shift, words);
  } else {
    decompress_kernel<false><<<blocks, kThreads, 0, st>>>(
        pp, sp, op, (uint32_t)nbytes, (uint32_t)mul, (uint32_t)shift, words);
  }
  return (int)cudaGetLastError();
}
