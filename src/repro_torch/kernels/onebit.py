"""Error-feedback 1-bit compression, two-pass and single-pass: CUDA
kernels, plain versions, wrappers.

Frames are 2-D (rows, cols) f32 with cols a multiple of 8; ``counts`` is
the int32 per-row count of true elements (padding is a row tail or a
whole row, see ``core.compressor.view_row_counts``).

* :func:`abs_rowsum`  — pass 1, masked per-row L1 sums of ``z + err``;
  replaces ``src/repro/kernels/onebit.py::abs_rowsum``.
* :func:`ef_quantize` — pass 2, big-endian packed signs of ``z + err``
  and the error-feedback residual against per-row scales; replaces
  ``src/repro/kernels/onebit.py::ef_quantize``.
* :func:`ef_compress` — single pass with per-row scales: the masked L1
  mean of each row, then :func:`ef_quantize`'s bits and residual against
  it; replaces ``src/repro/kernels/onebit.py::ef_compress``.
* :func:`decompress`  — packed signs times per-row scales; replaces
  ``src/repro/kernels/onebit.py::decompress``.

The kernels are in ``csrc/onebit.cu``. CPU tensors take the plain
versions below; CUDA tensors launch the kernels.
"""
from __future__ import annotations

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


# decompress: byte indices are 32-bit, the row of a byte a multiply-shift
DECOMPRESS_MAX_BYTES = 1 << 31


def decompress_divisor(cb: int):
    """(mul, shift) with ``b // cb == (b * mul) >> shift`` for every
    0 <= b < 2**31: the row of packed byte b in a frame ``cb`` bytes wide,
    without a divide (mul < 2**32; round-up reciprocal, since
    ``mul * cb - 2**shift < cb`` and b < 2**31)."""
    if cb == 1:
        return 1, 0
    shift = 31 + (cb - 1).bit_length()
    return -(-(1 << shift) // cb), shift


# --- plain versions ----------------------------------------------------

def abs_rowsum_plain(z, err, counts):
    rows, cols = z.shape
    zw = z + err
    return torch.where(_mask(counts, rows, cols), zw.abs(),
                       torch.zeros((), dtype=zw.dtype,
                                   device=zw.device)).sum(1)


def ef_quantize_plain(z, err, scales, counts):
    rows, cols = z.shape
    zw = z + err
    bits = zw >= 0
    s = scales.reshape(rows, 1)
    zhat = torch.where(bits, s, -s)
    err_out = torch.where(_mask(counts, rows, cols), zw - zhat,
                          torch.zeros((), dtype=zw.dtype, device=zw.device))
    return pack_signs(zw), err_out


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
    build.check_operand(kernel, "err", err, torch.float32, (rows, cols), dev)
    build.check_operand(kernel, "counts", counts, torch.int32, (rows,), dev)
    return rows, cols, dev


def abs_rowsum(z, err, counts):
    """f32 (rows,) masked L1 sums of ``z + err``."""
    rows, cols, dev = _check_zerr("abs_rowsum", z, err, counts)
    if not build.on_card("abs_rowsum", z):
        return abs_rowsum_plain(z, err, counts)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        build.launch("abs_rowsum", "abs_rowsum_f32", dev, z.data_ptr(), err.data_ptr(),
                     counts.data_ptr(), out.data_ptr(), rows, cols)
    return out


def ef_quantize(z, err, scales, counts):
    """(packed u8 (rows, cols//8), err_out f32 (rows, cols))."""
    rows, cols, dev = _check_zerr("ef_quantize", z, err, counts)
    if cols % 8:
        raise ValueError(f"ef_quantize: cols={cols} is not a multiple of 8")
    build.check_operand("ef_quantize", "scales", scales, torch.float32,
                        (rows,), dev)
    if not build.on_card("ef_quantize", z):
        return ef_quantize_plain(z, err, scales, counts)
    packed = torch.empty((rows, cols // 8), dtype=torch.uint8, device=dev)
    err_out = torch.empty_like(z)
    if z.numel():
        build.launch("ef_quantize", "ef_quantize_f32", dev, z.data_ptr(), err.data_ptr(),
                     scales.data_ptr(), counts.data_ptr(), packed.data_ptr(), err_out.data_ptr(), rows, cols)
    return packed, err_out


def ef_compress(z, err, counts):
    """(packed u8 (rows, cols//8), scales f32 (rows,), err_out f32 (rows,
    cols)) with ``scales[r] = sum_{c<counts[r]} |z+err| / max(counts[r], 1)``.
    """
    rows, cols, dev = _check_zerr("ef_compress", z, err, counts)
    if cols % 8:
        raise ValueError(f"ef_compress: cols={cols} is not a multiple of 8")
    if not build.on_card("ef_compress", z):
        return ef_compress_plain(z, err, counts)
    packed = torch.empty((rows, cols // 8), dtype=torch.uint8, device=dev)
    scales = torch.empty(rows, dtype=torch.float32, device=dev)
    err_out = torch.empty_like(z)
    if z.numel():
        build.launch("ef_compress", "ef_compress_f32", dev, z.data_ptr(),
                     err.data_ptr(), counts.data_ptr(), packed.data_ptr(),
                     scales.data_ptr(), err_out.data_ptr(), rows, cols,
                     *ef_compress_geometry(cols))
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
        build.launch("decompress", "decompress_f32", dev, packed.data_ptr(),
                     scales.data_ptr(), out.data_ptr(), rows, cb * 8,
                     *decompress_divisor(cb))
    return out
