"""View-level dispatch: comm views of stacked workers -> 2-D frames ->
kernels. PyTorch port of the unsharded part of
``src/repro/kernels/dispatch.py``.

    ef_compress_view      <->  compressor.ef_compress (z + err fused in)
    server_compress_view  <->  codecs._server_compress
    decompress_view       <->  compressor.decompress
    fused_local_step_view_ <->  the local half-step of the base (adam, lamb,
                               sgd)

Every tensor carries a leading dim of stacked workers. Their frames stack
along rows, so each phase of each leaf is one launch however many workers
the process simulates. Padding travels as per-row true counts
(``compressor.view_row_counts``), so scales and error feedback are
pad-exact. Scales of every granularity come from the two-pass kernels
(``abs_rowsum_scales``: row sums and the scale of each group of
consecutive frame rows, over its denominator; ``ef_quantize`` against one
scale per group), except per-row scales on 3-D views, which the
single-pass ``ef_compress`` computes itself. A scale group is a stacked
worker (tensor), one of its chunks (chunk) or one (chunk, chunk-row) pair
(row), so each worker's scales are summed as if its frame stood alone.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import compressor as C
from repro_torch.kernels import fused_adam, onebit


@functools.lru_cache(maxsize=None)
def _worker_counts(layout: C.LeafLayout, stack: int, inner_index,
                   device: str):
    """Row counts of ``stack`` stacked worker frames and each worker's
    f32 scale denominators, on device (cached: no per-call copy): the
    tensor-mode one (stack,) and the chunk-mode ones (stack, chunks). A
    worker's frame is its full view for ``inner_index`` None, else the
    reduce-scatter slice ``inner_index[w]`` (the last slice holds the pad,
    and a slice of a tiny leaf can be all pad: its denominators clamp to
    1, as the reference's)."""
    rf = layout.rest_factor
    if inner_index is None:
        total, per_chunk = C.true_counts(layout)
        cnt = np.tile(C.view_row_counts(layout), stack)
        totals = np.full(stack, total)
        per_chunk = np.tile(per_chunk, (stack, 1))
    else:
        j = np.asarray(inner_index)
        cnt = C.slice_row_counts(layout)[j].reshape(-1)
        totals, per_chunk = (a[j] for a in C.slice_true_counts(layout))
    dev = torch.device(device)
    return (torch.as_tensor(cnt, device=dev),
            torch.as_tensor(np.maximum(totals * rf, 1.0), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.maximum(per_chunk * rf, 1.0),
                            dtype=torch.float32, device=dev))


@functools.lru_cache(maxsize=None)
def _server_counts(layout: C.LeafLayout, widx: tuple, device: str):
    """Row counts of the server chunks the stacked workers own (worker w
    serves chunk widx[w]; the last chunk holds the pad), and each chunk's
    f32 scale denominator, both on device (cached: no per-call copy)."""
    cnt = C.chunk_row_counts(layout)[np.asarray(widx)]
    denom = np.maximum(cnt.sum(axis=1).astype(np.float64)
                       * layout.rest_factor, 1.0).astype(np.float32)
    dev = torch.device(device)
    return (torch.as_tensor(cnt.reshape(-1), device=dev),
            torch.as_tensor(denom, device=dev))


# Shared memory a block of the card may opt in to (H100, sm_90: 227 KB);
# ``ef_compress`` keeps ``kept_cols`` f32 of z + err per block there
SMEM_OPTIN_BYTES = 227 * 1024


def frame_precheck(layout: C.LeafLayout, *, stack: int = 1) -> list:
    """Static check of one comm layout's 2-D frame against the launch
    contract of the CUDA kernels of ``csrc/onebit.cu`` (kernels 2-5:
    ``abs_rowsum``, ``ef_quantize``, ``ef_compress``, ``decompress``),
    for ``stack`` workers' frames stacked along rows in one launch (a
    simulating process stacks all of its workers). Returns human-readable
    issues; empty means every such kernel takes the frame (the worker
    view's: the slice and server-chunk frames are row blocks of it).
    Pure metadata: nothing is allocated, built or launched.

    * cols a multiple of 8: sign bits pack whole bytes per row
      (``ef_quantize``, ``ef_compress``, ``decompress`` refuse otherwise);
    * the 32-bit element indices: ``ef_quantize`` launches in slabs of
      whole scale groups, each of ``n4 = rows * cols / 4 < 2**31`` float4,
      so one scale group must be smaller, and the largest is one worker's
      whole frame (tensor scales); ``decompress``'s packed bytes of the
      stacked frame ``< 2**31``; ``ef_compress``'s ``cols < 2**28``;
    * ``ef_compress``'s geometry (``onebit.ef_compress_geometry``): a
      cluster of 1-8 blocks whose 8-aligned slices cover the row, each
      block keeping ``kept_cols * 4`` bytes of dynamic shared memory,
      at most the card's opt-in limit per block (``SMEM_OPTIN_BYTES``);
    * a flatten view is a whole number of the 128-element flatten quantum
      wide and folds to at most ``FRAME_MAX_COLS`` columns
      (``compressor.view_rows_cols``).

    The reference's check (its ``kernels/dispatch.py::frame_precheck``)
    also holds frames to the TPU's 128-lane tile on every view and to a
    VMEM budget; neither exists on the card, so neither is checked."""
    issues = []
    vs = layout.view_shape
    if layout.flatten and vs[-1] % 128:
        return [f"flatten view {vs} is not a multiple of the 128-element "
                f"flatten quantum wide (layout shape {layout.shape})"]
    rows, cols = C.view_rows_cols(layout)
    rows *= stack
    if cols % 8:
        issues.append(
            f"frame cols={cols} not a multiple of 8: sign-bit packing "
            f"needs byte-aligned rows (layout shape {layout.shape}, view "
            f"{vs})")
    if layout.flatten and cols > C.FRAME_MAX_COLS:
        issues.append(
            f"frame cols={cols} exceeds FRAME_MAX_COLS={C.FRAME_MAX_COLS} "
            f"- view_rows_cols should have folded this view")
    n4 = rows // stack * (cols // 4)
    if n4 >= onebit.EF_QUANTIZE_MAX_FLOAT4:
        issues.append(
            f"one worker's frame ({rows // stack}, {cols}) holds n4={n4} "
            f"float4, ef_quantize's 32-bit index takes fewer than 2**31 a "
            f"scale group")
    nbytes = rows * (cols // 8)
    if nbytes >= onebit.DECOMPRESS_MAX_BYTES:
        issues.append(
            f"frame ({rows}, {cols}) packs to {nbytes} bytes, decompress's "
            f"32-bit index takes fewer than 2**31")
    if cols >= onebit.EF_COMPRESS_MAX_COLS:
        issues.append(
            f"frame cols={cols}: ef_compress's column index takes fewer "
            f"than 2**28")
    else:
        cluster, slice_cols, kept = onebit.ef_compress_geometry(cols)
        if not (1 <= cluster <= onebit.EF_MAX_CLUSTER and slice_cols % 8 == 0
                and cluster * slice_cols >= cols and 4 <= kept <= slice_cols
                and kept % 4 == 0):
            issues.append(
                f"ef_compress geometry (cluster {cluster}, slice "
                f"{slice_cols}, kept {kept}) at cols={cols} breaks the "
                f"kernel's cluster/slice rules")
        if kept * 4 > SMEM_OPTIN_BYTES:
            issues.append(
                f"ef_compress keeps {kept} columns = {kept * 4} B of "
                f"dynamic shared memory per block, above the "
                f"{SMEM_OPTIN_BYTES} B a block may opt in to")
    return issues


def _frame(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return t.contiguous().view(rows, cols)


def _scales_to_rows(scales, lead_shape, rows, layout=None):
    """Broadcast granular scales over the buffer's leading view dims, then
    repeat them onto frame sub-rows when the frame folds wider views."""
    s = torch.broadcast_to(scales.to(torch.float32),
                           tuple(lead_shape) + (1,)).reshape(-1)
    if s.shape[0] != rows:
        if s.shape[0] == 0 or rows % s.shape[0]:
            raise ValueError(
                f"cannot spread {s.shape[0]} scale rows over a {rows}-row "
                f"kernel frame; scales {tuple(scales.shape)} over lead dims "
                f"{tuple(lead_shape)}"
                + (f", layout {layout}" if layout is not None else ""))
        s = s[:, None].expand(-1, rows // s.shape[0]).reshape(-1)
    return s.contiguous()


@functools.lru_cache(maxsize=None)
def _filled(value: float, n: int, device: str) -> torch.Tensor:
    """(n,) f32 of ``value`` on ``device``, made once: a scale divides by
    a tensor, never by a Python number, because CUDA turns a divide by a
    host scalar into a multiply by its reciprocal (not the reference's f32
    divide)."""
    return torch.full((n,), value, dtype=torch.float32,
                      device=torch.device(device))


def _scale_groups(shape, mode: C.ScaleMode, rest_factor: int, denoms,
                  stack: int, device: str):
    """The scale groups of ``stack`` stacked frames of buffers of
    ``shape`` (the view, an inner slice, or a server chunk with its lead
    of 1): (each group's f32 denominator (G,), the scales' shape, that of
    ``compressor._scales``: (stack, 1, ..., 1) for tensor, (stack, chunks,
    1, ...) for chunk, (stack, chunks, A/n, 1, ...) for row). Group g is
    rows [g * R/G, (g + 1) * R/G) of the R-row frame. ``denoms`` are the
    tensor- and chunk-mode denominators of :func:`_worker_counts`; a row
    scale is divided by the full rest extent (padding is whole rows, zero
    in the masked row sums)."""
    C.validate_scale_mode(mode)
    ndim = len(shape)
    if mode == "tensor":
        return denoms[0], (stack,) + (1,) * ndim
    if mode == "chunk":
        return denoms[1].reshape(-1), (stack, shape[0]) + (1,) * (ndim - 1)
    out = (stack,) + tuple(shape[:2]) + (1,) * (ndim - 2)
    rest = max(int(np.prod(shape[2:])) * rest_factor, 1)
    return _filled(float(rest), int(np.prod(out)), device), out


def _two_pass(z2, e2, cnts, denoms, scale_shape):
    """The two-pass compress of a frame whose rows fall into
    ``denoms.numel()`` equal groups: (packed, scales in ``scale_shape``,
    err)."""
    group_rows = z2.shape[0] // denoms.numel()
    _, scales = onebit.abs_rowsum_scales(z2, e2, cnts, group_rows, denoms)
    packed2, err2 = onebit.ef_quantize(z2, e2, scales, cnts, group_rows)
    return packed2, scales.view(scale_shape), err2


def ef_compress_view(z, err, layout: C.LeafLayout, mode: C.ScaleMode,
                     inner_index=None):
    """Worker-side EF compress of stacked views (stack, *view_shape), or
    with ``inner_index`` (one per stacked worker) of the inner
    reduce-scatter slices they own (stack, *slice_shape): the frame
    shrinks to the slice's rows // n_inner rows and the row counts and
    denominators are those of each worker's own slice. ``z + err`` is
    fused into the kernels. Returns (packed, scales, err).

    Row scales on a 2-D view fall back to chunk scales, as in
    ``compressor._scales``; on a 3-D view they are one scale per frame row,
    and the single-pass kernel computes them."""
    rows, cols = C.view_rows_cols(layout)
    stack, vs = z.shape[0], layout.view_shape
    ndim = len(vs)
    if inner_index is None:
        bshape = vs
    else:
        bshape, rows = layout.slice_shape, rows // layout.n_inner
        inner_index = tuple(int(j) for j in inner_index)
        if len(inner_index) != stack:
            raise ValueError(f"{len(inner_index)} inner indices for a "
                             f"stack of {stack} workers")
    eff = "chunk" if (mode == "row" and ndim == 2) else mode
    z2, e2 = _frame(z, stack * rows, cols), _frame(err, stack * rows, cols)
    cnts, *denoms = _worker_counts(layout, stack, inner_index,
                                   str(z.device))
    if eff == "row" and ndim == 3 and layout.rest_factor == 1:
        packed2, srow, err2 = onebit.ef_compress(z2, e2, cnts)
        scales = srow.view((stack,) + bshape[:2] + (1,))
    else:
        packed2, scales, err2 = _two_pass(z2, e2, cnts, *_scale_groups(
            bshape, eff, layout.rest_factor, denoms, stack, str(z.device)))
    return (packed2.view((stack,) + bshape[:-1] + (-1,)), scales,
            err2.view(z.shape))


def server_compress_view(avg, err, layout: C.LeafLayout, mode: C.ScaleMode,
                         worker_index):
    """Server-side EF compress of the chunk each stacked worker serves:
    ``avg`` and ``err`` are (stack, 1, *chunk_shape), worker w serving
    chunk ``worker_index[w]``. Returns (packed, scales, err). Row scales on
    a 2-D view are per element, which no kernel takes (the caller keeps
    ``codecs._server_compress`` for them, as the reference does)."""
    C.validate_scale_mode(mode)
    ys = tuple(avg.shape)
    stack = ys[0]
    if mode == "row" and len(ys) == 3:
        raise ValueError("row scales on a 2-D view are per element on the "
                         "server side; use codecs._server_compress")
    rows_all, cols = C.view_rows_cols(layout)
    rows = stack * (rows_all // layout.n)
    cnts, denom = _server_counts(layout, tuple(int(w) for w in worker_index),
                                 str(avg.device))
    z2, e2 = _frame(avg, rows, cols), _frame(err, rows, cols)
    if mode == "row":
        groups = _scale_groups(ys[1:], mode, layout.rest_factor, None, stack,
                               str(avg.device))
    else:
        groups = denom, (stack,) + (1,) * (len(ys) - 1)
    packed2, scales, err2 = _two_pass(z2, e2, cnts, *groups)
    return (packed2.view(ys[:-1] + (ys[-1] // 8,)), scales, err2.view(ys))


def decompress_view(packed, scales, layout: C.LeafLayout):
    """Unpack-times-scale of a view-shaped packed buffer (the all_to_all
    receive or the gathered chunk results) of stacked workers."""
    rows, cols = C.view_rows_cols(layout)
    rows = (rows * int(np.prod(packed.shape[:-1]))
            // int(np.prod(layout.view_shape[:-1])))
    p2 = _frame(packed, rows, cols // 8)
    srow = _scales_to_rows(scales, packed.shape[:-1], rows, layout)
    out2 = onebit.decompress(p2, srow)
    return out2.view(tuple(packed.shape[:-1]) + (layout.pack_count,))


def fused_local_step_view_(g, m, u, v, lr, beta1, eps, layout: C.LeafLayout,
                           kind: str = "adam", into_grad: bool = False,
                           u_out=None):
    """Fused local half-step over stacked comm views, keyed on the base
    kind: "adam" and "lamb" share the variance kernel (``v`` needed; the
    caller scales a LAMB delta by its trust afterwards, as the
    reference does), "sgd" the kernel without (``v`` ignored). Updates
    ``m`` and ``u`` (contiguous view-shaped state, f32 or bf16) in place,
    or writes u' into ``u_out`` (an f32 buffer of the view's shape), and
    returns the f32 delta in view shape: written over the gradient's
    frame with ``into_grad`` where the gradient is f32 (it is dead after
    the step), else a new tensor. The gradient may be bf16 (the
    parameter dtype); each dtype routes to its kernel instance, and any
    other dtype raises."""
    for name, t in (("m", m), ("u", u), ("u_out", u_out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused local step: {name} must be contiguous "
                             f"to be updated in place")
    rows, cols = C.view_rows_cols(layout)
    rows *= g.shape[0]
    gf = _frame(g, rows, cols)
    d = gf if into_grad and gf.dtype == torch.float32 else None
    uof = None if u_out is None else _frame(u_out, rows, cols)
    if kind == "sgd":
        mf, uf = (_frame(a, rows, cols) for a in (m, u))
        d = fused_adam.fused_local_step_sgd_(gf, mf, uf, lr, beta1, d, uof)
    elif kind in ("adam", "lamb"):
        mf, uf, vf = (_frame(a, rows, cols) for a in (m, u, v))
        d = fused_adam.fused_local_step_(gf, mf, uf, vf, lr, beta1, eps, d,
                                         uof)
    else:
        raise ValueError(f"unknown base kind {kind!r} for the fused local "
                         f"step")
    return d.view(g.shape)
