"""View-level dispatch: comm views of stacked workers -> 2-D frames ->
kernels. PyTorch port of the unsharded part of
``src/repro/kernels/dispatch.py``.

    ef_compress_view      <->  compressor.ef_compress (z + err fused in)
    server_compress_view  <->  codecs._server_compress
    decompress_view       <->  compressor.decompress
    fused_local_step_view <->  the local half-step of the 0/1 Adam base

Every tensor carries a leading dim of stacked workers. Their frames stack
along rows, so each phase of each leaf is one launch however many workers
the process simulates. Padding travels as per-row true counts
(``compressor.view_row_counts``), so scales and error feedback are
pad-exact. Only the two-pass branch with tensor scales is ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import compressor as C
from repro_torch.kernels import fused_adam, onebit


@functools.lru_cache(maxsize=None)
def _worker_counts(layout: C.LeafLayout, stack: int, device: str):
    """Row counts of ``stack`` stacked worker frames, int32 on device."""
    cnt = np.tile(C.view_row_counts(layout), stack)
    return torch.as_tensor(cnt, device=torch.device(device))


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


def _combine_scales(rowsum, layout: C.LeafLayout, mode: C.ScaleMode,
                    stack: int):
    """Masked per-row L1 sums of stacked frames -> per-worker scales
    shaped like ``compressor._scales``: (stack, 1, ..., 1)."""
    C.validate_scale_mode(mode)
    total, _ = C.true_counts(layout)
    s = rowsum.view(stack, -1).sum(1) / (total * layout.rest_factor)
    return s.view((stack,) + (1,) * len(layout.view_shape))


def ef_compress_view(z, err, layout: C.LeafLayout, mode: C.ScaleMode):
    """Worker-side EF compress of stacked views (stack, *view_shape):
    ``z + err`` is fused into the kernels. Returns (packed, scales, err)."""
    rows, cols = C.view_rows_cols(layout)
    stack, vs = z.shape[0], layout.view_shape
    z2, e2 = _frame(z, stack * rows, cols), _frame(err, stack * rows, cols)
    cnts = _worker_counts(layout, stack, str(z.device))
    rowsum = onebit.abs_rowsum(z2, e2, cnts)
    scales = _combine_scales(rowsum, layout, mode, stack)
    srow = _scales_to_rows(scales, (stack,) + vs[:-1], stack * rows, layout)
    packed2, err2 = onebit.ef_quantize(z2, e2, srow, cnts)
    return (packed2.view((stack,) + vs[:-1] + (-1,)), scales,
            err2.view(z.shape))


def server_compress_view(avg, err, layout: C.LeafLayout, mode: C.ScaleMode,
                         worker_index):
    """Server-side EF compress of the chunk each stacked worker serves:
    ``avg`` and ``err`` are (stack, 1, *chunk_shape), worker w serving
    chunk ``worker_index[w]``. Returns (packed, scales, err)."""
    C.validate_scale_mode(mode)
    ys = tuple(avg.shape)
    stack = ys[0]
    rows_all, cols = C.view_rows_cols(layout)
    rows = stack * (rows_all // layout.n)
    cnts, denom = _server_counts(layout, tuple(int(w) for w in worker_index),
                                 str(avg.device))
    z2, e2 = _frame(avg, rows, cols), _frame(err, rows, cols)
    rowsum = onebit.abs_rowsum(z2, e2, cnts)
    s = rowsum.view(stack, -1).sum(1) / denom
    scales = s.view((stack,) + (1,) * (len(ys) - 1))
    srow = _scales_to_rows(scales, ys[:-1], rows, layout)
    packed2, err2 = onebit.ef_quantize(z2, e2, srow, cnts)
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


def fused_local_step_view(g, m, u, v, lr, beta1, eps, layout: C.LeafLayout):
    """Fused 0/1 Adam local half-step over stacked comm views; returns
    (m', u', delta) in view shape."""
    rows, cols = C.view_rows_cols(layout)
    rows *= g.shape[0]
    f = [_frame(a, rows, cols) for a in (g, m, u, v)]
    outs = fused_adam.fused_local_step(*f, lr, beta1, eps)
    return tuple(o.view(g.shape) for o in outs)
