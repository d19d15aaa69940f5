"""Error-feedback 1-bit compression building blocks (paper Eq. 4,
Algorithm 2), PyTorch port of ``src/repro/core/compressor.py``.

A leaf's *comm view* is

    natural leaf (.., A, ..)  --pad/move/reshape-->  view (n, A_pad/n, *rest)

where ``n`` is the worker count and the leading axis enumerates the chunks
of the chunked AllReduce (worker j serves chunk j). The layout is chosen
per leaf from its tensor-parallel spec (:func:`make_layout`), so views,
EF state and wire bytes match the reference leaf for leaf.

Tensors here carry any number of leading worker dims before the view
(a simulated run stacks its n workers on dim 0); layout metadata is plain
numpy. All three scale granularities are ported (``"tensor"``, the
paper's Eq. 4, plus ``"chunk"`` and ``"row"``); tensor-parallel sharded
leaves are not yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

ScaleMode = str  # "tensor" | "chunk" | "row"
SCALE_MODES = ("tensor", "chunk", "row")


def validate_scale_mode(mode: ScaleMode) -> ScaleMode:
    """Fail fast on a bad scale mode, at config-build time."""
    if mode not in SCALE_MODES:
        raise ValueError(
            f"unknown scale_mode {mode!r}; choose from {list(SCALE_MODES)}")
    return mode


# ---------------------------------------------------------------------------
# Leaf layouts (static metadata, identical to the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafLayout:
    shape: Tuple[int, ...]        # natural (unpadded) leaf shape
    n: int                        # worker count (number of chunks)
    flatten: bool                 # True -> leaf treated as 1-D
    split_axis: int               # axis chunked across workers
    padded: int                   # split axis size after padding
    view_shape: Tuple[int, ...]   # (n, padded//n, *rest)
    rest_factor: int = 1
    n_inner: int = 1

    @property
    def pad(self) -> int:
        base = (int(np.prod(self.shape)) if self.flatten
                else self.shape[self.split_axis])
        return self.padded - base

    @property
    def chunk_shape(self) -> Tuple[int, ...]:
        return self.view_shape[1:]

    @property
    def pack_count(self) -> int:
        return self.view_shape[-1]

    @property
    def n_outer(self) -> int:
        return self.n // self.n_inner

    @property
    def slice_shape(self) -> Tuple[int, ...]:
        return (self.n_outer,) + self.chunk_shape

    @property
    def ef_worker_shape(self) -> Tuple[int, ...]:
        return self.slice_shape


def _is_sharded(spec, axis: int) -> bool:
    if spec is None:
        return False
    entries = tuple(spec)
    return axis < len(entries) and entries[axis] is not None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_layout(shape: Sequence[int], spec, n: int,
                n_inner: int = 1) -> LeafLayout:
    """Comm view of a leaf whose tensor-parallel spec is ``spec`` (a tuple
    of per-axis entries, None entries replicated, or None).

    Replicated leaves flatten and pad to an ``n*128`` quantum; a leaf with
    a sharded axis splits along its largest unsharded axis. With no tensor
    parallelism running the spec still decides the view, exactly as in
    the reference, so layouts compare leaf for leaf.

    ``n_inner`` (pods of ``n_inner`` workers) leaves the view as it is and
    records how its ``n`` chunks group into ``n_inner`` reduce-scatter
    slices of ``n // n_inner`` outer chunks each."""
    shape = tuple(int(s) for s in shape)
    if n_inner < 1 or n % n_inner:
        raise ValueError(f"n_inner={n_inner} must divide n={n}")
    replicated = spec is None or all(e is None for e in tuple(spec))
    if len(shape) == 0:
        padded = _round_up(1, n * 128)
        return LeafLayout(shape=(), n=n, flatten=True, split_axis=0,
                          padded=padded, view_shape=(n, padded // n),
                          n_inner=n_inner)
    if replicated:
        padded = _round_up(int(np.prod(shape)), n * 128)
        return LeafLayout(shape=shape, n=n, flatten=True, split_axis=0,
                          padded=padded, view_shape=(n, padded // n),
                          n_inner=n_inner)
    candidates = [a for a in range(len(shape)) if not _is_sharded(spec, a)]
    if not candidates:
        raise ValueError(
            f"leaf {shape} with spec {spec} has no replicated axis to chunk "
            f"over")
    split_axis = max(candidates, key=lambda a: shape[a])
    rest = [shape[a] for a in range(len(shape)) if a != split_axis]
    if rest:
        if rest[-1] % 8 != 0:
            raise ValueError(
                f"leaf {shape} spec {spec}: last view dim {rest[-1]} not a "
                f"multiple of 8; cannot bit-pack")
        padded = _round_up(shape[split_axis], n)
    else:
        padded = _round_up(shape[split_axis], n * 8)
    return LeafLayout(shape=shape, n=n, flatten=False, split_axis=split_axis,
                      padded=padded, view_shape=(n, padded // n, *rest),
                      n_inner=n_inner)


def to_view(x: torch.Tensor, layout: LeafLayout) -> torch.Tensor:
    """Natural leaf (with any leading worker dims) -> comm view."""
    lead = tuple(x.shape[:x.dim() - len(layout.shape)])
    if layout.flatten:
        flat = x.reshape(lead + (-1,))
        if layout.pad:
            flat = torch.nn.functional.pad(flat, (0, layout.pad))
        return flat.reshape(lead + layout.view_shape)
    ax = len(lead) + layout.split_axis
    if layout.pad:
        pads = [0, 0] * (x.dim() - ax - 1) + [0, layout.pad]
        x = torch.nn.functional.pad(x, pads)
    x = torch.movedim(x, ax, len(lead))
    return x.reshape(lead + layout.view_shape)


def from_view(v: torch.Tensor, layout: LeafLayout) -> torch.Tensor:
    """Comm view (with any leading worker dims) -> natural leaf."""
    lead = tuple(v.shape[:v.dim() - len(layout.view_shape)])
    if layout.flatten:
        total = int(np.prod(layout.shape)) if layout.shape else 1
        return v.reshape(lead + (-1,))[..., :total].reshape(
            lead + layout.shape)
    rest = [layout.shape[a] for a in range(len(layout.shape))
            if a != layout.split_axis]
    x = v.reshape(lead + (layout.padded, *rest))
    x = torch.movedim(x, len(lead), len(lead) + layout.split_axis)
    if layout.pad:
        x = x.narrow(len(lead) + layout.split_axis, 0,
                     layout.shape[layout.split_axis])
    return x


def pad_mask(layout: LeafLayout, device=None,
             dtype=torch.float32) -> Optional[torch.Tensor]:
    """0 at padded view positions, broadcastable against the view:
    shape (n, padded//n, 1, ...); None when the leaf has no pad."""
    if layout.pad == 0:
        return None
    a = np.arange(layout.padded).reshape(layout.view_shape[:2])
    base = (int(np.prod(layout.shape)) if layout.flatten
            else layout.shape[layout.split_axis])
    m = (a < base).astype(np.float32)
    m = m.reshape(m.shape + (1,) * (len(layout.view_shape) - 2))
    return torch.as_tensor(m, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# View <-> 2-D kernel frame
# ---------------------------------------------------------------------------

# Widest frame handed to the kernels. The reference folds wider flatten
# views (a TPU VMEM bound); the port keeps the same fold so frames, row
# counts and scales line up with it row for row.
FRAME_MAX_COLS = 8192


def view_rows_cols(layout: LeafLayout) -> Tuple[int, int]:
    """(rows, cols) of one worker's 2-D frame of a comm view; flatten
    views wider than FRAME_MAX_COLS fold each chunk row into k rows."""
    vs = layout.view_shape
    rows, cols = int(np.prod(vs[:-1])), int(vs[-1])
    if layout.flatten and cols > FRAME_MAX_COLS:
        assert cols % 128 == 0, layout
        m = cols // 128
        k = -(-m // (FRAME_MAX_COLS // 128))
        while m % k:
            k += 1
        rows, cols = rows * k, 128 * (m // k)
    return rows, cols


def view_row_counts(layout: LeafLayout) -> np.ndarray:
    """True (unpadded) element count per frame row, int32 (rows,)."""
    rows, cols = view_rows_cols(layout)
    if layout.flatten:
        base = int(np.prod(layout.shape)) if layout.shape else 1
        starts = np.arange(rows, dtype=np.int64) * cols
        cnt = np.clip(base - starts, 0, cols)
    else:
        base = layout.shape[layout.split_axis]
        vs = layout.view_shape
        group = int(np.prod(vs[2:-1], dtype=np.int64)) if len(vs) > 3 else 1
        pos = np.arange(layout.n * vs[1], dtype=np.int64)
        cnt = np.repeat((pos < base).astype(np.int64), group) * cols
    return cnt.astype(np.int32)


def chunk_row_counts(layout: LeafLayout) -> np.ndarray:
    """Row counts of the server chunk each worker owns, int32 (n, rows//n)."""
    rows, _ = view_rows_cols(layout)
    return view_row_counts(layout).reshape(layout.n, rows // layout.n)


def slice_row_counts(layout: LeafLayout) -> np.ndarray:
    """Row counts of the reduce-scatter slice each intra-pod worker owns,
    int32 (n_inner, rows // n_inner): the slices are contiguous equal
    blocks of frame rows (:func:`chunk_row_counts` one level up)."""
    rows, _ = view_rows_cols(layout)
    return view_row_counts(layout).reshape(layout.n_inner,
                                           rows // layout.n_inner)


def slice_true_counts(layout: LeafLayout) -> Tuple[np.ndarray, np.ndarray]:
    """(#real elements of each inner slice (n_inner,), #real elements of
    each outer chunk within it (n_inner, n_outer)), float64. A flat layout
    gives :func:`true_counts` with a leading axis of one, which is what
    makes the ``n_inner == 1`` two-level path bitwise the flat one."""
    _, per_chunk = true_counts(layout)
    grouped = per_chunk.reshape(layout.n_inner, layout.n_outer)
    return grouped.sum(axis=1), grouped


def true_counts(layout: LeafLayout) -> Tuple[float, np.ndarray]:
    """(#real elements of the leaf, #real elements per chunk (n,)).

    Closed form over the n chunks: the step calls this on every sync, and
    a mask over the padded split axis would cost tens of milliseconds of
    host time on gpt2's 25M-element position table."""
    vs = layout.view_shape
    rest = int(np.prod(vs[2:])) if len(vs) > 2 else 1
    base = (int(np.prod(layout.shape)) if layout.flatten
            else layout.shape[layout.split_axis])
    split = np.clip(base - np.arange(vs[0], dtype=np.int64) * vs[1], 0,
                    vs[1])
    per_chunk = split.astype(np.float64) * rest
    return float(per_chunk.sum()), per_chunk


# ---------------------------------------------------------------------------
# Sign packing (big-endian: element 0 in the MSB, like jnp.packbits)
# ---------------------------------------------------------------------------

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_signs(v: torch.Tensor) -> torch.Tensor:
    """Sign bits (v >= 0, so +0 and -0 pack as 1) along the last axis,
    8 per byte; the last dim must be a multiple of 8."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=v.device)
    b8 = (v >= 0).to(torch.uint8).reshape(
        v.shape[:-1] + (v.shape[-1] // 8, 8))
    return (b8 * w).sum(-1, dtype=torch.uint8)


def unpack_signs(p: torch.Tensor, count: int,
                 dtype=torch.float32) -> torch.Tensor:
    """Packed bytes -> +-1 values of last-axis length ``count``."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=p.device)
    bits = ((p[..., None] >> shifts) & 1).reshape(
        p.shape[:-1] + (p.shape[-1] * 8,))[..., :count]
    return bits.to(dtype) * 2.0 - 1.0


# ---------------------------------------------------------------------------
# 1-bit compression with error feedback, whole-view formulation
# ---------------------------------------------------------------------------

def _view_dims(z: torch.Tensor, layout: LeafLayout) -> Tuple[int, ...]:
    return tuple(range(z.dim() - len(layout.view_shape), z.dim()))


def _scales(z, layout: LeafLayout, mode: ScaleMode, mask) -> torch.Tensor:
    """L1-mean magnitudes at the requested granularity (pad-exact), shaped
    against the view: tensor (*lead, 1, ..., 1), chunk (*lead, n, 1, ...),
    row (*lead, n, A/n, 1, ...). Row scales on a 2-D (flatten) view would
    be per element; the worker side falls back to chunk scales there, as
    the reference does."""
    validate_scale_mode(mode)
    az = z.abs()
    if mask is not None:
        az = az * mask
    total, per_chunk = true_counts(layout)
    rf = layout.rest_factor
    dims = _view_dims(z, layout)
    if mode == "row" and len(dims) == 2:
        mode = "chunk"
    if mode == "tensor":
        denom = torch.tensor(total * rf, dtype=z.dtype, device=z.device)
        return az.sum(dim=dims, keepdim=True) / denom
    if mode == "chunk":
        cnt = np.maximum(per_chunk * rf, 1.0).reshape(
            (-1,) + (1,) * (len(dims) - 1))
        return (az.sum(dim=dims[1:], keepdim=True)
                / torch.as_tensor(cnt, dtype=z.dtype, device=z.device))
    rest = int(np.prod(layout.view_shape[2:])) * rf
    return (az.sum(dim=dims[2:], keepdim=True)
            / torch.tensor(float(rest), dtype=z.dtype, device=z.device))


def ef_compress(z, layout: LeafLayout, mode: ScaleMode, mask):
    """One EF compression pass over a comm view that already includes the
    incoming error. Returns (packed uint8, scales, residual error)."""
    scales = _scales(z, layout, mode, mask)
    packed = pack_signs(z)
    signs = torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
    err = z - signs * scales
    if mask is not None:
        err = err * mask
    return packed, scales, err


def _slice_scales(z, layout: LeafLayout, mode: ScaleMode, mask,
                  inner_index) -> torch.Tensor:
    """:func:`_scales` of stacked inner slices (*lead, n_outer, A/n,
    *rest), worker ``w`` owning slice ``inner_index[w]`` (one index per
    leading element): the denominators are that slice's true counts,
    clamped to 1 because a whole slice of a tiny leaf can be padding."""
    validate_scale_mode(mode)
    az = z.abs()
    if mask is not None:
        az = az * mask
    totals, per_chunk = slice_true_counts(layout)
    rf = layout.rest_factor
    dims = _view_dims(z, layout)
    lead = tuple(z.shape[:dims[0]])
    j = np.asarray(inner_index).reshape(lead)
    if mode == "row" and len(dims) == 2:
        mode = "chunk"
    if mode == "tensor":
        denom = np.maximum(totals * rf, 1.0)[j].reshape(
            lead + (1,) * len(dims))
        return (az.sum(dim=dims, keepdim=True)
                / torch.as_tensor(denom, dtype=z.dtype, device=z.device))
    if mode == "chunk":
        cnt = np.maximum(per_chunk * rf, 1.0)[j].reshape(
            lead + (-1,) + (1,) * (len(dims) - 1))
        return (az.sum(dim=dims[1:], keepdim=True)
                / torch.as_tensor(cnt, dtype=z.dtype, device=z.device))
    rest = int(np.prod(layout.view_shape[2:])) * rf
    return (az.sum(dim=dims[2:], keepdim=True)
            / torch.tensor(float(rest), dtype=z.dtype, device=z.device))


def ef_compress_slice(z, layout: LeafLayout, mode: ScaleMode, mask,
                      inner_index):
    """Worker-side EF compression of stacked inner slices
    (``layout.slice_shape`` after the leading dims), the incoming error
    already added; ``mask`` is the slices' pad mask or None. Same contract
    as :func:`ef_compress`, with per-slice denominators."""
    scales = _slice_scales(z, layout, mode, mask, inner_index)
    packed = pack_signs(z)
    signs = torch.where(z >= 0, 1.0, -1.0).to(z.dtype)
    err = z - signs * scales
    if mask is not None:
        err = err * mask
    return packed, scales, err


def decompress(packed, scales, count: int, dtype=torch.float32):
    """Inverse of the quantizer: scale * sign."""
    return unpack_signs(packed, count, dtype) * scales.to(dtype)


def compressed_bytes_levels(layout: LeafLayout, mode: ScaleMode,
                            inner_itemsize: int = 2, codec=None) -> dict:
    """Bytes one worker SENDS on one sync, per level. ``inner``: the
    uncompressed intra-pod phases at the wire dtype (``inner_itemsize``),
    the reduce-scatter sending n_inner - 1 of the n_inner slices and the
    all_gather the decoded own slice to the n_inner - 1 pod-mates.
    ``outer``: Algorithm 2 across pods over the owned slice, (n_outer - 1)
    chunks of the codec's payload each way. A flat layout has ``inner``
    0 and ``outer`` the flat exchange's bytes."""
    from repro_torch.core.codecs import make_codec   # codecs imports us
    wb = make_codec("sign1bit" if codec is None else codec).wire_bytes(
        layout, mode)
    chunk_elems = int(np.prod(layout.chunk_shape))
    ni, no = layout.n_inner, layout.n_outer
    return {"inner": 2 * (ni - 1) * no * chunk_elems * inner_itemsize,
            "outer": (no - 1) * (wb["scatter"] + wb["gather"])}


def compressed_bytes(layout: LeafLayout, mode: ScaleMode,
                     inner_itemsize: int = 2, codec=None) -> int:
    """Bytes one worker SENDS on one sync of this leaf, both levels (the
    flat exchange: the scatter keeps its own chunk and the gather sends
    this worker's chunk to the n-1 others, each chunk as the codec's
    payload, default sign1bit)."""
    lv = compressed_bytes_levels(layout, mode, inner_itemsize, codec)
    return lv["inner"] + lv["outer"]


def fullprec_bytes_levels(layout: LeafLayout, itemsize: int) -> dict:
    """Bytes one worker sends on a full-precision round, per level: the
    intra-pod reduce-scatter and all_gather move 2 (n_inner-1)/n_inner of
    the view, the inter-pod exchange 2 (n_outer-1)/n_outer of the owned
    slice (1/n_inner of the view)."""
    ni, no = layout.n_inner, layout.n_outer
    elems = int(np.prod(layout.view_shape))
    return {"inner": 2 * (ni - 1) * (elems // ni) * itemsize,
            "outer": 2 * (no - 1) * (elems // ni // no) * itemsize}
