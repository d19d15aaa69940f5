// Error-feedback 1-bit compression kernels for Hopper (sm_90a): the
// two-pass and the single-pass sign compressors of the 0/1 Adam exchange
// and their decoder.
//
// All four work on a 2-D (rows, cols) f32 frame of a comm view, with
// cols a multiple of 8. counts[r] is the number of true (unpadded)
// elements of row r; the mask is rebuilt as `col < counts[r]`. The error
// feedback err (and err_out, in err's dtype) is f32, bf16 or fp16, the
// optimizer's state_dtype, named by the entry points' `types` code: a
// 16-bit err is widened on load (exact), added to z in f32, and err_out
// is rounded once to nearest even (lowp4.cuh), as the reference's kernels
// compute `z.astype(f32) + err.astype(f32)` and store
// `.astype(errout.dtype)`.
//
// abs_rowsum   replaces src/repro/kernels/onebit.py::abs_rowsum and the
//              reference's combine of its row sums into scales
//              (src/repro/kernels/dispatch.py::_combine_scales)
//              out[r] = sum_{c < counts[r]} |z + err|; with groups,
//              scales[g] = (sum of out over rows [g*gr, (g+1)*gr)) /
//              denoms[g]
// ef_quantize  replaces src/repro/kernels/onebit.py::ef_quantize
//              packed bit (z + err >= 0), 8 per byte, element 0 in the
//              MSB; err_out = mask * (zw - (bit ? s : -s)),
//              s = scales[r / gr]
// ef_compress  replaces src/repro/kernels/onebit.py::ef_compress
//              single pass with per-row scales: s[r] = abs_rowsum[r] /
//              max(counts[r], 1), then ef_quantize's bits and err_out
// decompress   replaces src/repro/kernels/onebit.py::decompress
//              out = (bit ? s : -s), s = scales[r]
//
// Bound: bytes, for every kernel. abs_rowsum reads 8 bytes per true
// element (6 with a 16-bit err; and writes 4 per row and per group);
// ef_quantize reads 8 and writes 4.125 bytes per element (6 and 2.125
// with a 16-bit err); ef_compress the same as ef_quantize plus 4 bytes of
// scale per row; decompress reads 0.125 and writes 4 bytes per element.
// The arithmetic is an add, a compare and a subtract per element.
//
// Design:
// * abs_rowsum gives each row 1, 2, 4 or 8 warps, a number chosen from
//   the row's width alone (kernels/onebit.py::abs_rowsum_geometry: one
//   warp up to 8,192 columns, eight at gpt2's 50,432), so several rows
//   share a 256-thread block. Warp k of a row owns float4 columns
//   [k * slice4, (k + 1) * slice4); lane l reads float4 j*32 + l of the
//   slice (every warp load is 512 contiguous bytes), four of each operand
//   in flight, and stops at counts[r]: a pad row reads nothing and its
//   sum is 0. Summation order of a row, fixed by the width alone: each
//   lane adds its elements in column order (x, y, z, w of float4 l, then
//   l + 32, ...), the lanes fold by __shfl_down (16, 8, 4, 2, 1), and the
//   row's warps' sums are added in rank order. A row's sum is therefore
//   the same bits in any frame, stacked or alone.
//   With groups (gr consecutive rows each) the row sums become scales
//   in the same call. A group of at most 8 / wpr rows lies in one block
//   (a block then takes 8 / wpr / gr whole groups), which adds its row
//   sums in order and divides by denoms[g]: one launch. A larger group
//   is added up by a second kernel from the same entry point: one warp
//   per group up to 256 rows, else a 1,024-thread block; thread t adds
//   rows t, t + T, ... of its group in order (T its threads), then the
//   shuffle fold, then the warps' sums folded again by warp 0, and one
//   IEEE divide. Each of these orders depends on the group's row count
//   and the row width alone, never on the number of groups or the
//   frame, so a worker's scale from a stack of workers' frames is the
//   same bits as from its own frame: this is what makes a process-per-
//   worker rank bitwise its simulated worker. (On an H100 this measured
//   faster than one launch whose last block per group, found by an
//   atomic ticket, adds up the group: PERF.md.)
// * ef_quantize walks the frame as one flat run of float4s (cols % 8 == 0,
//   so a float4 never crosses a row and a packed byte is two neighbouring
//   float4s). A warp takes a chunk of 256 float4s (1,024 elements, 128
//   packed bytes), lane l float4 k*32 + l of it (k = 0..7), all 16 loads
//   of z and err in flight before any arithmetic: every warp load and
//   every err_out store (__stcs) is one contiguous 512-byte run. Each
//   float4 gives a nibble; lane pairs join two nibbles into a byte with
//   one __shfl_xor, and the even lanes store 16 contiguous bytes. The row
//   of a float4 and the group of a row are 32-bit multiply-shifts by
//   reciprocals from the host (kernels/onebit.py::ef_quantize_divisors,
//   exact below 2^31 float4s, which the wrapper enforces): no divide.
//   One warp per chunk and plain loads: on an H100 they beat grid-stride
//   loops of 4-16 blocks per SM and streaming (__ldcs) loads at every
//   gpt2 frame that was not host-bound (PERF.md).
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
//   per element and one IEEE divide per row or group, so kernel and plain
//   version round identically given the same sum.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lowp4.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsGrid = 65535;     // gridDim.y limit
// ef_compress: float4 loads of each operand in flight per thread
constexpr int kUnroll = 4;
// decompress: packed bytes one warp decodes at a time (1,024 outputs)
constexpr uint32_t kChunk = 128;
constexpr int kWarps = kThreads / 32;
// abs_rowsum: loads of each operand in flight
constexpr int kRowUnroll = 4;
// group scales over several abs_rowsum blocks: a warp per group up to
// this many rows, else 1,024 threads
constexpr int64_t kGroupWarpRows = 256;
// ef_quantize: float4s per lane of a warp's chunk, and the chunk
constexpr int kQuantUnroll = 8;
constexpr uint32_t kQuantChunk = 32 * kQuantUnroll;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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

__device__ __forceinline__ int64_t row_count(const int* counts, int64_t r,
                                             int64_t cols) {
  int64_t cnt = counts[r];
  if (cnt < 0) cnt = 0;
  if (cnt > cols) cnt = cols;
  return cnt;
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

// Four elements [c, c + n) of a row, n >= 1, the rest read as 0 (they lie
// at or past counts[r] and are masked anyway): the whole float4 when
// vectorized (cols % 4 == 0), else only the elements inside the row.
template <bool VEC>
__device__ __forceinline__ float4 load4_upto(const float* p, int n) {
  if (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                     n > 3 ? p[3] : 0.f);
}
template <bool VEC, typename T>
__device__ __forceinline__ float4 load4_upto(const T* p, int n) {
  using lowp4::to_f32;
  if (VEC) return lowp4::load4<true>(p);
  return make_float4(to_f32(p[0]), n > 1 ? to_f32(p[1]) : 0.f,
                     n > 2 ? to_f32(p[2]) : 0.f, n > 3 ? to_f32(p[3]) : 0.f);
}

// Pass 1. A block holds gpb groups of gr rows (gpb * gr <= 8 / wpr),
// each row wpr warps (warp k of a row sums float4 columns [k * slice4,
// (k + 1) * slice4)); with scales, the block adds each of its groups' row
// sums in order and writes the group's scale. (Groups of more rows than a
// block holds come here as single rows, gr = 1, without scales; the
// second kernel below adds them up.)
template <bool VEC, typename E>
__global__ void __launch_bounds__(kThreads)
abs_rowsum_kernel(const float* __restrict__ z,
                  const E* __restrict__ err,
                  const int* __restrict__ counts, float* __restrict__ out,
                  const float* __restrict__ denoms,
                  float* __restrict__ scales, int64_t rows, int cols,
                  int wpr, int slice4, int gr, int gpb) {
  __shared__ float parts[kWarps];      // each warp's sum
  __shared__ float row_sums[kWarps];   // each row's sum
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = w / wpr, part = w % wpr;   // row of the block, its warp
  const int64_t r0 = (int64_t)blockIdx.x * gpb * gr;
  const int nrows = (int)min((int64_t)gpb * gr, rows - r0);
  const int64_t r = r0 + i;
  float acc = 0.f;
  if (i < nrows) {
    const int cnt = (int)row_count(counts, r, cols);
    const int lo = part * slice4;
    const int hi = min((cnt + 3) / 4, lo + slice4);   // float4s to read
    const float* zr = z + r * cols;
    const E* er = err + r * cols;
    for (int j0 = lo; j0 < hi; j0 += 32 * kRowUnroll) {
      float4 a[kRowUnroll], b[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int j = j0 + u * 32 + lane;
        if (j < hi) {
          a[u] = load4_upto<VEC>(zr + 4 * j, cnt - 4 * j);
          b[u] = load4_upto<VEC>(er + 4 * j, cnt - 4 * j);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int j = j0 + u * 32 + lane;
        if (j < hi) acc = add_abs4(acc, add4(a[u], b[u]), 4 * j, cnt);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (wpr > 1) {                          // the same in every thread
    if (lane == 0) parts[w] = acc;
    __syncthreads();
    if (part == 0 && lane == 0) {
      for (int q = 1; q < wpr; ++q) acc = __fadd_rn(acc, parts[w + q]);
    }
  }
  if (part == 0 && lane == 0 && i < nrows) {
    out[r] = acc;
    row_sums[i] = acc;
  }
  if (scales == nullptr) return;          // the same in every thread
  __syncthreads();
  if ((int)threadIdx.x < nrows / gr) {    // thread t: the block's group t
    const int j0 = (int)threadIdx.x * gr;
    float sum = row_sums[j0];
    for (int j = 1; j < gr; ++j) sum = __fadd_rn(sum, row_sums[j0 + j]);
    const int64_t g = (int64_t)blockIdx.x * gpb + threadIdx.x;
    scales[g] = __fdiv_rn(sum, denoms[g]);
  }
}

// scales[g] = (sum of rowsum over the gr rows of group g) / denoms[g], for
// groups of more rows than one abs_rowsum block holds. T threads per
// group (32: eight groups a block; 1024: one), chosen from gr alone;
// thread t adds rows t, t + T, ... of its group in order.
template <int T>
__global__ void __launch_bounds__(T == 32 ? kThreads : 1024)
group_scales_kernel(const float* __restrict__ rowsum,
                    const float* __restrict__ denoms,
                    float* __restrict__ scales, int64_t groups, int64_t gr) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int64_t g = T == 32 ? (int64_t)blockIdx.x * (kThreads / 32) +
                                  (threadIdx.x >> 5)
                            : (int64_t)blockIdx.x;
  const int t = T == 32 ? lane : (int)threadIdx.x;
  float acc = 0.f;
  if (g < groups) {
    const float* rs = rowsum + g * gr;
    for (int64_t i0 = t; i0 < gr; i0 += (int64_t)T * kRowUnroll) {
      float v[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int64_t i = i0 + (int64_t)u * T;
        v[u] = i < gr ? rs[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (i0 + (int64_t)u * T < gr) acc = __fadd_rn(acc, v[u]);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (T > 32) {
    if (lane == 0) warp_sums[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x >= 32) return;
    acc = warp_sums[lane];
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
  }
  if (lane == 0 && g < groups) scales[g] = __fdiv_rn(acc, denoms[g]);
}

__device__ __forceinline__ uint32_t mulshift(uint32_t b, uint32_t mul,
                                             uint32_t shift) {
  return (uint32_t)(((uint64_t)b * mul) >> shift);
}

// Chunks of kQuantChunk float4s, one warp each. Row of float4 f:
// mulshift(f, row_mul, row_shift) == f / c4; group of row r:
// mulshift(r, grp_mul, grp_shift) == r / gr.
template <bool VEC, typename E>
__global__ void __launch_bounds__(kThreads)
ef_quantize_kernel(const float* __restrict__ z,
                   const E* __restrict__ err,
                   const float* __restrict__ scales,
                   const int* __restrict__ counts,
                   uint8_t* __restrict__ packed,
                   E* __restrict__ err_out, uint32_t n4, uint32_t c4,
                   uint32_t row_mul, uint32_t row_shift, uint32_t grp_mul,
                   uint32_t grp_shift) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t ch = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  // whole warps leave or stay: the shuffles below need all 32 lanes
  if (ch < (n4 + kQuantChunk - 1) / kQuantChunk) {
    const uint32_t base = ch * kQuantChunk;
    float4 a[kQuantUnroll], b[kQuantUnroll];
#pragma unroll
    for (int k = 0; k < kQuantUnroll; ++k) {
      const uint32_t f = base + 32 * k + lane;
      if (f < n4) {
        a[k] = load4<VEC>(z + 4 * (size_t)f);
        b[k] = lowp4::load4<VEC>(err + 4 * (size_t)f);
      }
    }
#pragma unroll
    for (int k = 0; k < kQuantUnroll; ++k) {
      // n4 is even and base + 32k too: lanes 2i and 2i+1 hold the two
      // halves of one packed byte, or neither
      const uint32_t f = base + 32 * k + lane;
      unsigned nib = 0;
      if (f < n4) {
        const uint32_t r = mulshift(f, row_mul, row_shift);
        const int c = (int)(4 * (f - r * c4));
        const int cnt = (int)row_count(counts, r, 4 * (int64_t)c4);
        const float s = scales[mulshift(r, grp_mul, grp_shift)];
        float4 eo;
        nib = quantize4(add4(a[k], b[k]), s, c, cnt, &eo);
        lowp4::store4<VEC, true>(err_out + 4 * (size_t)f, eo);
      }
      const unsigned low = __shfl_xor_sync(0xffffffffu, nib, 1);
      if (f < n4 && !(lane & 1)) packed[f >> 1] = (uint8_t)((nib << 4) | low);
    }
  }
}

// One cluster of gridDim.x blocks per row (grid-strided over rows along
// y); block `rank` owns columns [rank * slice, min(cols, (rank+1) * slice))
// and keeps the first `kept` of them in shared memory.
template <bool VEC, typename E>
__global__ void __launch_bounds__(kThreads)
ef_compress_kernel(const float* __restrict__ z,
                   const E* __restrict__ err,
                   const int* __restrict__ counts,
                   uint8_t* __restrict__ packed,
                   float* __restrict__ scales,
                   E* __restrict__ err_out, int64_t rows, int cols,
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
    const E* er = err + off;
    float acc = 0.f;
    for (int j0 = 0; j0 < units; j0 += kThreads * kUnroll) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads + t;
        if (j < units) {
          a[u] = load4<VEC>(zr + 4 * j);
          b[u] = lowp4::load4<VEC>(er + 4 * j);
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
    E* eo_r = err_out + off;
    // units is even and j0 a multiple of 256, so lanes 2i and 2i+1 hold
    // the two halves of one packed byte, or neither
    for (int j0 = 0; j0 < units; j0 += kThreads) {
      const int j = j0 + t;
      unsigned nib = 0;
      if (j < units) {
        const float4 zw = j < kept_units
                              ? zw_kept[j]
                              : add4(load4<VEC>(zr + 4 * j),
                                     lowp4::load4<VEC>(er + 4 * j));
        float4 eo;
        nib = quantize4(zw, s, c_lo + 4 * j, cnt, &eo);
        lowp4::store4<VEC, true>(eo_r + 4 * j, eo);
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

// The entry points' bodies, templated on err's dtype E (float, bf16 or
// fp16).

template <typename E>
int abs_rowsum_impl(const void* z, const void* err, const void* counts,
                    void* out, const void* denoms, void* scales,
                    long long rows, long long cols, long long wpr,
                    long long slice4, long long gr, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (cols >= (1LL << 30) || !(wpr == 1 || wpr == 2 || wpr == 4 ||
                               wpr == 8) ||
      slice4 <= 0 || wpr * slice4 < (cols + 3) / 4 || gr < 0 ||
      (gr > 0 && (rows % gr || denoms == nullptr || scales == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int64_t rpb = kWarps / wpr;
  const bool in_block = gr > 0 && gr <= rpb;
  const int64_t g1 = in_block ? gr : 1;
  const int64_t gpb = rpb / g1;
  const unsigned blocks = (unsigned)((rows + gpb * g1 - 1) / (gpb * g1));
  const float* zp = static_cast<const float*>(z);
  const E* ep = static_cast<const E*>(err);
  const int* cp = static_cast<const int*>(counts);
  float* op = static_cast<float*>(out);
  const float* dp = static_cast<const float*>(denoms);
  float* sp = static_cast<float*>(scales);
  auto kernel = cols % 4 == 0 && aligned16(z) && lowp4::aligned4<E>(err)
                    ? abs_rowsum_kernel<true, E>
                    : abs_rowsum_kernel<false, E>;
  kernel<<<blocks, kThreads, 0, st>>>(zp, ep, cp, op, dp,
                                      in_block ? sp : nullptr, rows,
                                      (int)cols, (int)wpr, (int)slice4,
                                      (int)g1, (int)gpb);
  if (gr > 0 && !in_block) {
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    const int64_t groups = rows / gr;
    if (gr <= kGroupWarpRows) {
      group_scales_kernel<32><<<(unsigned)((groups + kWarps - 1) / kWarps),
                                kThreads, 0, st>>>(op, dp, sp, groups, gr);
    } else {
      group_scales_kernel<1024><<<(unsigned)groups, 1024, 0, st>>>(
          op, dp, sp, groups, gr);
    }
  }
  return (int)cudaGetLastError();
}

template <typename E>
int ef_quantize_impl(const void* z, const void* err, const void* scales,
                     const void* counts, void* packed, void* err_out,
                     long long rows, long long cols, long long row_mul,
                     long long row_shift, long long grp_mul,
                     long long grp_shift, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long n4 = rows * (cols / 4);
  if (cols % 8 || n4 >= (1LL << 31) || row_mul <= 0 ||
      row_mul >= (1LL << 32) || row_shift < 0 || row_shift > 62 ||
      grp_mul <= 0 || grp_mul >= (1LL << 32) || grp_shift < 0 ||
      grp_shift > 62) {
    return (int)cudaErrorInvalidValue;
  }
  const long long chunks = (n4 + kQuantChunk - 1) / kQuantChunk;
  const unsigned grid = (unsigned)((chunks + kWarps - 1) / kWarps);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto kernel = aligned16(z) && lowp4::aligned4<E>(err) &&
                        lowp4::aligned4<E>(err_out)
                    ? ef_quantize_kernel<true, E>
                    : ef_quantize_kernel<false, E>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(z), static_cast<const E*>(err),
      static_cast<const float*>(scales), static_cast<const int*>(counts),
      static_cast<uint8_t*>(packed), static_cast<E*>(err_out),
      (uint32_t)n4, (uint32_t)(cols / 4), (uint32_t)row_mul,
      (uint32_t)row_shift, (uint32_t)grp_mul, (uint32_t)grp_shift);
  return (int)cudaGetLastError();
}

template <typename E>
int ef_compress_impl(const void* z, const void* err, const void* counts,
                     void* packed, void* scales, void* err_out,
                     long long rows, long long cols, long long cluster,
                     long long slice, long long kept, void* stream) {
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
  const bool vec = aligned16(z) && lowp4::aligned4<E>(err) &&
                   lowp4::aligned4<E>(err_out);
  // beyond the default 48 KB of shared memory (static included) a kernel
  // must be allowed more: once, and again only for a larger size
  static size_t smem_set[2] = {47 * 1024, 47 * 1024};
  if (cfg.dynamicSmemBytes > smem_set[vec]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        vec ? ef_compress_kernel<true, E> : ef_compress_kernel<false, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    smem_set[vec] = cfg.dynamicSmemBytes;
  }
  const float* zp = static_cast<const float*>(z);
  const E* ep = static_cast<const E*>(err);
  const int* cp = static_cast<const int*>(counts);
  uint8_t* pp = static_cast<uint8_t*>(packed);
  float* sp = static_cast<float*>(scales);
  E* op = static_cast<E*>(err_out);
  const int64_t r64 = rows;
  const int c32 = (int)cols, s32 = (int)slice, k32 = (int)kept;
  const cudaError_t rc =
      vec ? cudaLaunchKernelEx(&cfg, ef_compress_kernel<true, E>, zp, ep,
                               cp, pp, sp, op, r64, c32, s32, k32)
          : cudaLaunchKernelEx(&cfg, ef_compress_kernel<false, E>, zp, ep,
                               cp, pp, sp, op, r64, c32, s32, k32);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// `types` is err's (and err_out's) dtype: 0 f32, 1 bf16, 2 fp16.

// wpr and slice4 come from kernels/onebit.py::abs_rowsum_geometry; with
// gr > 0 the scales of rows / gr groups of gr rows follow (denoms and
// scales hold one per group): from the same kernel where a group fits in
// a block, else from a second kernel on the same stream.
extern "C" int abs_rowsum(const void* z, const void* err, const void* counts,
                          void* out, const void* denoms, void* scales,
                          long long rows, long long cols, long long wpr,
                          long long slice4, long long gr, long long types,
                          void* stream) {
  switch (types) {
    case 0: return abs_rowsum_impl<float>(z, err, counts, out, denoms, scales,
                                          rows, cols, wpr, slice4, gr, stream);
    case 1: return abs_rowsum_impl<lowp4::bf16>(z, err, counts, out, denoms,
                                                 scales, rows, cols, wpr,
                                                 slice4, gr, stream);
    case 2: return abs_rowsum_impl<lowp4::f16>(z, err, counts, out, denoms,
                                               scales, rows, cols, wpr,
                                               slice4, gr, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The divisors come from kernels/onebit.py::ef_quantize_divisors; one
// warp per chunk of kQuantChunk float4s.
extern "C" int ef_quantize(const void* z, const void* err, const void* scales,
                           const void* counts, void* packed, void* err_out,
                           long long rows, long long cols, long long row_mul,
                           long long row_shift, long long grp_mul,
                           long long grp_shift, long long types,
                           void* stream) {
  switch (types) {
    case 0: return ef_quantize_impl<float>(z, err, scales, counts, packed,
                                           err_out, rows, cols, row_mul,
                                           row_shift, grp_mul, grp_shift,
                                           stream);
    case 1: return ef_quantize_impl<lowp4::bf16>(z, err, scales, counts,
                                                  packed, err_out, rows, cols,
                                                  row_mul, row_shift, grp_mul,
                                                  grp_shift, stream);
    case 2: return ef_quantize_impl<lowp4::f16>(z, err, scales, counts,
                                                packed, err_out, rows, cols,
                                                row_mul, row_shift, grp_mul,
                                                grp_shift, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cluster, slice and kept come from kernels/onebit.py::ef_compress_geometry.
extern "C" int ef_compress(const void* z, const void* err, const void* counts,
                           void* packed, void* scales, void* err_out,
                           long long rows, long long cols, long long cluster,
                           long long slice, long long kept, long long types,
                           void* stream) {
  switch (types) {
    case 0: return ef_compress_impl<float>(z, err, counts, packed, scales,
                                           err_out, rows, cols, cluster, slice,
                                           kept, stream);
    case 1: return ef_compress_impl<lowp4::bf16>(z, err, counts, packed,
                                                  scales, err_out, rows, cols,
                                                  cluster, slice, kept,
                                                  stream);
    case 2: return ef_compress_impl<lowp4::f16>(z, err, counts, packed,
                                                scales, err_out, rows, cols,
                                                cluster, slice, kept, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mul and shift come from kernels/onebit.py::divisor.
extern "C" int decompress(const void* packed, const void* scales, void* out,
                          long long rows, long long cols, long long mul,
                          long long shift, void* stream) {
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
