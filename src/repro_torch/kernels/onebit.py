"""Error-feedback 1-bit compression, two-pass and single-pass: CUDA
kernels, plain versions, wrappers.

Frames are 2-D (rows, cols) f32 with cols a multiple of 8; ``counts`` is
the int32 per-row count of true elements (padding is a row tail or a
whole row, see ``core.compressor.view_row_counts``). The error feedback
``err`` is f32 or bf16 (the optimizer's ``state_dtype``); ``z + err`` is
an f32 sum and the residual ``err_out`` comes back in ``err``'s dtype,
rounded once to nearest even, as the reference's kernels store it. Each
dtype has its own kernel instance, chosen by the C entry's ``types``
code (:data:`ERR_TYPES`); any other dtype raises.

* :func:`abs_rowsum_scales` — pass 1, masked per-row L1 sums of
  ``z + err`` and, in the same call, the scale of each group of
  consecutive rows (their sums over a denominator); replaces
  ``src/repro/kernels/onebit.py::abs_rowsum`` and the reference's combine
  (``src/repro/kernels/dispatch.py::_combine_scales``). :func:`abs_rowsum`
  is the same kernel without the groups.
* :func:`ef_quantize` — pass 2, big-endian packed signs of ``z + err``
  and the error-feedback residual against one scale per group of rows;
  replaces ``src/repro/kernels/onebit.py::ef_quantize``.
* :func:`ef_compress` — single pass with per-row scales: the masked L1
  mean of each row, then :func:`ef_quantize`'s bits and residual against
  it; replaces ``src/repro/kernels/onebit.py::ef_compress``.
* :func:`decompress`  — packed signs times per-row scales; replaces
  ``src/repro/kernels/onebit.py::decompress``.

The kernels are in ``csrc/onebit.cu``. CPU tensors take the plain
versions below; CUDA tensors launch the kernels.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.compressor import pack_signs, unpack_signs
from repro_torch.kernels import build


def _mask(counts, rows, cols):
    col = torch.arange(cols, device=counts.device, dtype=torch.int32)
    return col[None, :] < counts.reshape(rows, 1)


# --- launch geometry (host side, checked by the CPU tests) -------------

# ef_compress: a row goes to a thread-block cluster of at most 8 blocks
# (the portable maximum), each keeping at most EF_KEPT_COLS columns of
# z + err in shared memory: 30 KB, so that seven 256-thread blocks fit in
# an SM's 227 KB. A wider slice re-reads the rest. (On an H100, BERT's
# 30,720-column rows ran fastest in 4 blocks of 7,680 columns of the
# cluster sizes 1-8 that chip_sweep.py times; see PERF.md.)
EF_MAX_CLUSTER = 8
EF_KEPT_COLS = 7680
# the kernel's column indices are 32-bit: cols < 2**28
EF_COMPRESS_MAX_COLS = 1 << 28


def ef_compress_geometry(cols: int):
    """(cluster, slice_cols, kept_cols) of ``ef_compress`` at ``cols``
    columns: the fewest blocks per row whose slices fit in EF_KEPT_COLS
    (at most 8), slices a multiple of 8 columns wide so that no packed
    byte straddles two blocks (block k owns columns [k * slice_cols,
    min(cols, (k + 1) * slice_cols))), and the columns of a slice that its
    block keeps in shared memory (kept_cols * 4 bytes)."""
    cluster = min(EF_MAX_CLUSTER, max(1, -(-cols // EF_KEPT_COLS)))
    slice_cols = -(-cols // (8 * cluster)) * 8
    return cluster, slice_cols, min(slice_cols, EF_KEPT_COLS)


# abs_rowsum: the warps a row gets come from its width alone, never from
# the frame's row count, so a row's sum (and a group's) is the same in a
# stack of workers' frames as in one worker's frame. A warp takes up to
# ROWSUM_WARP_COLS columns; wider rows get 2, 4 or 8 of a block's 8 warps.
ROWSUM_WARP_COLS = 8192
ROWSUM_BLOCK_WARPS = 8


@functools.lru_cache(maxsize=None)
def abs_rowsum_geometry(cols: int):
    """(warps_per_row, slice4) of ``abs_rowsum`` at ``cols`` columns: warp
    k of a row sums float4 columns [k * slice4, (k + 1) * slice4); with
    more than one warp a slice is a multiple of 32 float4 (512 bytes), so
    that every warp load is one contiguous run."""
    c4 = -(-cols // 4)
    warps = 1
    while warps < ROWSUM_BLOCK_WARPS and warps * ROWSUM_WARP_COLS < cols:
        warps *= 2
    return warps, (c4 if warps == 1 else -(-c4 // (32 * warps)) * 32)


# decompress and ef_quantize: element indices are 32-bit, the row of a
# byte, of a float4 and the group of a row a multiply-shift; ef_quantize
# launches a larger frame in slabs of whole scale groups, each under
# EF_QUANTIZE_MAX_FLOAT4
DECOMPRESS_MAX_BYTES = 1 << 31
EF_QUANTIZE_MAX_FLOAT4 = 1 << 31


def divisor(d: int):
    """(mul, shift) with ``b // d == (b * mul) >> shift`` for every
    0 <= b < 2**31, so a kernel finds the row of packed byte b of rows
    ``d`` bytes wide (or of float4 b, or the group of row b) without a
    divide (mul < 2**32; round-up reciprocal, since ``mul * d - 2**shift
    < d`` and b < 2**31)."""
    if d == 1:
        return 1, 0
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


@functools.lru_cache(maxsize=None)
def ef_quantize_divisors(cols: int, group_rows: int):
    """(row_mul, row_shift, group_mul, group_shift): the row of float4 f
    of a ``cols``-wide frame and the scale group of row r, each by
    :func:`divisor`."""
    return (*divisor(cols // 4), *divisor(group_rows))


def ef_quantize_slabs(rows: int, cols: int, group_rows: int,
                      max_n4: int = EF_QUANTIZE_MAX_FLOAT4):
    """(first row, rows) of each launch of ``ef_quantize`` on a (rows,
    cols) frame: whole scale groups of ``group_rows`` rows, fewer than
    ``max_n4`` float4 a launch (one launch where the frame fits). Raises
    where one group holds ``max_n4`` float4 or more."""
    if not rows or not cols:
        return []
    group_n4 = group_rows * (cols // 4)
    if group_n4 >= max_n4:
        raise ValueError(f"ef_quantize: a scale group of {group_rows} rows "
                         f"x {cols} holds {group_n4} float4; the kernel "
                         f"takes fewer than {max_n4} a launch")
    slab = (max_n4 - 1) // group_n4 * group_rows
    return [(r0, min(slab, rows - r0)) for r0 in range(0, rows, slab)]


# --- plain versions ----------------------------------------------------

# the C entries' ``types`` code of each dtype of err (and err_out)
ERR_TYPES = {torch.float32: 0, torch.bfloat16: 1}
ERR_DTYPES = tuple(ERR_TYPES)


def abs_rowsum_plain(z, err, counts):
    rows, cols = z.shape
    zw = z + err.to(torch.float32)
    return torch.where(_mask(counts, rows, cols), zw.abs(),
                       torch.zeros((), dtype=zw.dtype,
                                   device=zw.device)).sum(1)


def group_scales_plain(rowsum, group_rows, denoms):
    """Scale of each group of ``group_rows`` consecutive rows: the sum of
    its row sums over ``denoms[g]``, one torch sum over each row of the
    (groups, group_rows) view, whether the frame holds one worker's
    groups or a stack of them."""
    return rowsum.view(-1, group_rows).sum(1) / denoms


def abs_rowsum_scales_plain(z, err, counts, group_rows, denoms):
    rowsum = abs_rowsum_plain(z, err, counts)
    return rowsum, group_scales_plain(rowsum, group_rows, denoms)


def ef_quantize_plain(z, err, scales, counts, group_rows=1):
    rows, cols = z.shape
    zw = z + err.to(torch.float32)
    bits = zw >= 0
    s = scales.reshape(-1, 1).expand(-1, group_rows).reshape(rows, 1)
    zhat = torch.where(bits, s, -s)
    err_out = torch.where(_mask(counts, rows, cols), zw - zhat,
                          torch.zeros((), dtype=zw.dtype, device=zw.device))
    return pack_signs(zw), err_out.to(err.dtype)


def ef_compress_plain(z, err, counts):
    s = (abs_rowsum_plain(z, err, counts)
         / counts.clamp_min(1).to(torch.float32))
    packed, err_out = ef_quantize_plain(z, err, s, counts)
    return packed, s, err_out


def decompress_plain(packed, scales):
    rows, cb = packed.shape
    s = scales.reshape(rows, 1)
    return torch.where(unpack_signs(packed, cb * 8) > 0, s, -s)


# --- wrappers ----------------------------------------------------------

def _check_zerr(kernel, z, err, counts):
    if z.dim() != 2:
        raise ValueError(f"{kernel}: z must be 2-D, got {tuple(z.shape)}")
    rows, cols = z.shape
    dev = z.device
    build.check_operand(kernel, "z", z, torch.float32, (rows, cols), dev)
    if err.dtype not in ERR_DTYPES:
        raise TypeError(f"{kernel}: err has dtype {err.dtype}, expected one "
                        f"of {ERR_DTYPES}")
    build.check_operand(kernel, "err", err, err.dtype, (rows, cols), dev)
    build.check_operand(kernel, "counts", counts, torch.int32, (rows,), dev)
    return rows, cols, dev


def _groups(kernel, rows, group_rows):
    if group_rows < 1 or rows % group_rows:
        raise ValueError(f"{kernel}: {rows} rows do not split into groups "
                         f"of {group_rows}")
    return rows // group_rows


def _launch_abs_rowsum(z, err, counts, out, denoms, scales, group_rows):
    rows, cols = z.shape
    build.launch("abs_rowsum", "abs_rowsum", z.device, z.data_ptr(),
                 err.data_ptr(), counts.data_ptr(), out.data_ptr(),
                 denoms.data_ptr() if group_rows else None,
                 scales.data_ptr() if group_rows else None, rows, cols,
                 *abs_rowsum_geometry(cols), group_rows,
                 ERR_TYPES[err.dtype])


def abs_rowsum(z, err, counts):
    """f32 (rows,) masked L1 sums of ``z + err``."""
    rows, cols, dev = _check_zerr("abs_rowsum", z, err, counts)
    if not build.on_card("abs_rowsum", z):
        return abs_rowsum_plain(z, err, counts)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        _launch_abs_rowsum(z, err, counts, out, None, None, 0)
    return out


def abs_rowsum_scales(z, err, counts, group_rows, denoms):
    """(rowsum f32 (rows,), scales f32 (rows // group_rows,)): the masked
    L1 sums of ``z + err`` and, for each group g of ``group_rows``
    consecutive rows, ``scales[g]`` = the sum of its row sums over
    ``denoms[g]``. On the card a group's rows are added in an order fixed
    by ``group_rows`` and ``cols`` alone, so a worker's scale is the same
    bits in a stack of workers' frames as in its own frame."""
    rows, cols, dev = _check_zerr("abs_rowsum", z, err, counts)
    groups = _groups("abs_rowsum", rows, group_rows)
    build.check_operand("abs_rowsum", "denoms", denoms, torch.float32,
                        (groups,), dev)
    if not build.on_card("abs_rowsum", z):
        return abs_rowsum_scales_plain(z, err, counts, group_rows, denoms)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    scales = torch.empty(groups, dtype=torch.float32, device=dev)
    if rows:
        _launch_abs_rowsum(z, err, counts, out, denoms, scales, group_rows)
    return out, scales


def ef_quantize(z, err, scales, counts, group_rows=1):
    """(packed u8 (rows, cols//8), err_out (rows, cols) in err's dtype)
    against the scale ``scales[r // group_rows]`` of row r."""
    rows, cols, dev = _check_zerr("ef_quantize", z, err, counts)
    if cols % 8:
        raise ValueError(f"ef_quantize: cols={cols} is not a multiple of 8")
    groups = _groups("ef_quantize", rows, group_rows)
    build.check_operand("ef_quantize", "scales", scales, torch.float32,
                        (groups,), dev)
    if not build.on_card("ef_quantize", z):
        return ef_quantize_plain(z, err, scales, counts, group_rows)
    slabs = ef_quantize_slabs(rows, cols, group_rows)
    packed = torch.empty((rows, cols // 8), dtype=torch.uint8, device=dev)
    err_out = torch.empty_like(err)
    _launch_ef_quantize(z, err, scales, counts, packed, err_out, group_rows,
                        slabs)
    return packed, err_out


def _launch_ef_quantize(z, err, scales, counts, packed, err_out, group_rows,
                        slabs):
    """One launch a slab of :func:`ef_quantize_slabs`, its operands offset
    to the slab's first row: every element gets the arithmetic of one
    launch over the frame."""
    cols = z.shape[1]
    divs = ef_quantize_divisors(cols, group_rows)
    types, esize = ERR_TYPES[err.dtype], err.element_size()
    for r0, n in slabs:
        off, eoff = r0 * cols * 4, r0 * cols * esize
        build.launch("ef_quantize", "ef_quantize", z.device,
                     z.data_ptr() + off, err.data_ptr() + eoff,
                     scales.data_ptr() + r0 // group_rows * 4,
                     counts.data_ptr() + r0 * 4,
                     packed.data_ptr() + r0 * (cols // 8),
                     err_out.data_ptr() + eoff, n, cols, *divs, types)


def ef_compress(z, err, counts):
    """(packed u8 (rows, cols//8), scales f32 (rows,), err_out (rows, cols)
    in err's dtype) with ``scales[r] = sum_{c<counts[r]} |z+err| /
    max(counts[r], 1)``."""
    rows, cols, dev = _check_zerr("ef_compress", z, err, counts)
    if cols % 8:
        raise ValueError(f"ef_compress: cols={cols} is not a multiple of 8")
    if not build.on_card("ef_compress", z):
        return ef_compress_plain(z, err, counts)
    packed = torch.empty((rows, cols // 8), dtype=torch.uint8, device=dev)
    scales = torch.empty(rows, dtype=torch.float32, device=dev)
    err_out = torch.empty_like(err)
    if z.numel():
        build.launch("ef_compress", "ef_compress", dev, z.data_ptr(),
                     err.data_ptr(), counts.data_ptr(), packed.data_ptr(),
                     scales.data_ptr(), err_out.data_ptr(), rows, cols,
                     *ef_compress_geometry(cols), ERR_TYPES[err.dtype])
    return packed, scales, err_out


def decompress(packed, scales):
    """f32 (rows, 8 * packed cols): +scale for a 1 bit, -scale for 0."""
    if packed.dim() != 2:
        raise ValueError(f"decompress: packed must be 2-D, got "
                         f"{tuple(packed.shape)}")
    rows, cb = packed.shape
    dev = packed.device
    build.check_operand("decompress", "packed", packed, torch.uint8,
                        (rows, cb), dev)
    build.check_operand("decompress", "scales", scales, torch.float32,
                        (rows,), dev)
    if not build.on_card("decompress", packed):
        return decompress_plain(packed, scales)
    if packed.numel() >= DECOMPRESS_MAX_BYTES:
        raise ValueError(f"decompress: {packed.numel()} packed bytes; the "
                         f"kernel takes fewer than 2**31")
    out = torch.empty((rows, cb * 8), dtype=torch.float32, device=dev)
    if packed.numel():
        build.launch("decompress", "decompress", dev, packed.data_ptr(),
                     scales.data_ptr(), out.data_ptr(), rows, cb * 8,
                     *divisor(cb))
    return out
