"""Wire formats of the error-feedback exchange, PyTorch port of
``src/repro/core/codecs.py``: sign1bit, topk, qint8, qint4 and identity.

* ``encode_worker(z, err, layout, mode, inner_index) -> (payload,
  err')`` — one EF pass over each stacked worker's full comm view, or,
  with ``inner_index``, over the inner reduce-scatter slice it owns;
* ``encode_server(avg, err, layout, mode, widx) -> (payload, err')``
  — the pass over the chunk each worker serves (payload leaves carry a
  chunk dim of 1 for the all_gather);
* ``decode(payload, layout) -> dense f32`` — the chunk dim is kept;
* ``decode_mean(payload, layout)`` — the server's mean over the senders
  of the received chunks, dim 1 (a codec may fuse it into its decode);
* ``wire_bytes(layout, mode)`` — bytes of one chunk's payload per phase;
* ``payload_spec(layout)`` — the declared ``(leaf name, wire dtype)``
  pairs of each phase's payload, in emission order.

Payloads are dicts whose leaves all carry the chunk dim right after the
worker stack dim, so the exchange maps collectives over them. The sign1bit
codec runs through the kernels (``repro_torch.kernels.dispatch``: CUDA on
the card, their plain versions on the CPU), except where the reference
itself takes its plain path: row scales on a 2-D (flatten) view make the
server side's scales per element, which no kernel takes, so that server
compress and the decode of its gathered result run as plain torch ops on
every device. :func:`_server_compress` and ``core.compressor.ef_compress``
/ ``decompress`` are the same math over whole views, the formulation the
tests hold the kernel path to.

The dense error-feedback codecs (topk, qint8, qint4) reach no kernel in
the reference either: they are plain torch ops on every device, over
each stacked worker's chunks as rows, with padded positions masked to
zero before they are encoded.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compressor as C
from repro_torch.kernels.fused_adam import fma


def _chunk_elems(layout: C.LeafLayout) -> int:
    return int(np.prod(layout.chunk_shape)) if layout.chunk_shape else 1


class Codec:
    """Base class / protocol for exchange wire formats."""

    name: str = "?"
    needs_ef: bool = True      # False -> exact codec, EF state untouched

    def encode_worker(self, z, err, layout, mode, inner_index=None):
        raise NotImplementedError

    def encode_server(self, avg, err, layout, mode, worker_index):
        raise NotImplementedError

    def decode(self, payload, layout):
        raise NotImplementedError

    def decode_mean(self, payload, layout):
        return self.decode(payload, layout).mean(dim=1)

    def wire_bytes(self, layout, mode) -> Dict[str, int]:
        raise NotImplementedError

    def payload_spec(self, layout
                     ) -> Dict[str, Tuple[Tuple[str, torch.dtype], ...]]:
        """Declared wire format: ``{"scatter": ..., "gather": ...}``, each
        the ordered ``(leaf name, wire dtype)`` pairs of that phase's
        payload. The order is the emission order: the exchange issues one
        collective per payload leaf in the dict's insertion order, which
        every codec keeps sorted, the reference's (``jax.tree``) order.
        The communication audit (``repro_torch.analysis.ir_audit``) holds
        the collectives a step records to this declaration, names and
        dtypes, so a codec whose payloads disagree with it fails."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sign1BitCodec(Codec):
    """Packed sign bits + L1-mean magnitudes (paper Eq. 4, Algorithm 2).

    Payload ``{"packed": uint8, "scales": f32}``, the scales broadcast to
    one row per chunk so both leaves route through the same all_to_all."""

    name = "sign1bit"

    def encode_worker(self, z, err, layout, mode, inner_index=None):
        from repro_torch.kernels import dispatch as K
        packed, scales, err_w = K.ef_compress_view(z, err, layout, mode,
                                                   inner_index)
        # one scale row per chunk (n of them, or n_outer of a slice)
        bscales = scales.expand(
            tuple(z.shape[:2]) + tuple(scales.shape[2:])).to(torch.float32)
        return {"packed": packed, "scales": bscales}, err_w

    def encode_server(self, avg, err, layout, mode, worker_index):
        if mode == "row" and len(layout.view_shape) == 2:
            # per-element scales: the reference's own plain (non-kernel)
            # path, which the kernels cannot take; plain torch ops here on
            # every device
            mask = _server_mask(layout, tuple(int(w) for w in worker_index),
                                str(avg.device))
            packed_s, scales_s, err_s = _server_compress(
                (avg + err)[:, None], layout, mode, mask)
        else:
            from repro_torch.kernels import dispatch as K
            packed_s, scales_s, err_s = K.server_compress_view(
                avg[:, None], err[:, None], layout, mode, worker_index)
        return ({"packed": packed_s, "scales": scales_s.to(torch.float32)},
                err_s[:, 0])

    def decode(self, payload, layout):
        packed, scales = payload["packed"], payload["scales"]
        if scales.shape[-1] == 1:
            from repro_torch.kernels import dispatch as K
            return K.decompress_view(packed, scales, layout)
        # per-element scales (row mode on a 2-D view, gathered from the
        # server side): the reference's plain path, plain torch ops here
        return C.decompress(packed, scales, layout.pack_count)

    def payload_spec(self, layout):
        leaves = (("packed", torch.uint8), ("scales", torch.float32))
        return {"scatter": leaves, "gather": leaves}

    def wire_bytes(self, layout, mode):
        C.validate_scale_mode(mode)
        chunk_packed = _chunk_elems(layout) // 8
        if mode in ("tensor", "chunk"):
            scatter_scales = gather_scales = 1
        elif len(layout.view_shape) == 2:
            # row scales on a flatten view: chunk scales on the worker
            # side, per-element scales on the server side
            scatter_scales, gather_scales = 1, layout.view_shape[1]
        else:
            scatter_scales = gather_scales = layout.view_shape[1]
        return {"scatter": chunk_packed + 4 * scatter_scales,
                "gather": chunk_packed + 4 * gather_scales}


@functools.lru_cache(maxsize=None)
def _server_mask(layout, widx: tuple, device: str):
    """Pad mask of the chunk each stacked worker serves, (stack, 1,
    *chunk mask dims), or None without padding (cached: no per-call
    host work)."""
    m = C.pad_mask(layout, device=torch.device(device))
    return None if m is None else m[list(widx)][:, None]


def _server_compress(y, layout, mode, mask):
    """EF-compress the server chunk of each stacked worker: ``y`` is
    (stack, 1, *chunk_shape), ``mask`` the chunk's pad mask or None. One
    scale per chunk for tensor and chunk modes, one per chunk row for row
    mode, which is one per element on a 2-D view."""
    C.validate_scale_mode(mode)
    az = y.abs()
    if mask is not None:
        az = az * mask
    rest = layout.rest_factor * int(np.prod(y.shape[3:]))
    if mode == "row":
        if y.dim() > 3:
            denom = torch.tensor(float(max(rest, 1)), dtype=y.dtype,
                                 device=y.device)
            scales = az.sum(dim=tuple(range(3, y.dim())),
                            keepdim=True) / denom
        else:
            scales = az
    else:
        dims = tuple(range(1, y.dim()))
        if mask is None:
            denom = torch.tensor(float(az[0].numel() * layout.rest_factor),
                                 dtype=y.dtype, device=y.device)
        else:
            denom = (mask.sum(dim=dims, keepdim=True) * rest).clamp_min(1.0)
        scales = az.sum(dim=dims, keepdim=True) / denom
    packed = C.pack_signs(y)
    signs = torch.where(y >= 0, 1.0, -1.0).to(y.dtype)
    err = y - signs * scales
    if mask is not None:
        err = err * mask
    return packed, scales, err


@dataclasses.dataclass(frozen=True)
class IdentityCodec(Codec):
    """Exact exchange at full precision; leaves the EF state untouched."""

    name = "identity"
    needs_ef = False

    def encode_worker(self, z, err, layout, mode, inner_index=None):
        return {"values": z}, None

    def encode_server(self, avg, err, layout, mode, worker_index):
        return {"values": avg[:, None]}, None

    def decode(self, payload, layout):
        return payload["values"]

    def payload_spec(self, layout):
        leaves = (("values", torch.float32),)
        return {"scatter": leaves, "gather": leaves}

    def wire_bytes(self, layout, mode):
        ce = _chunk_elems(layout) * 4
        return {"scatter": ce, "gather": ce}


def resolve_with_quantize(codec, quantize: bool):
    """The deprecated ``quantize=False`` rule of ``CompressedDP``: ``None`` resolves to the default for the flag;
    ``quantize=False`` forces the exact mean unless a codec other than
    sign1bit is set (an explicit ``"sign1bit"``, by name or instance, is
    indistinguishable from the default and is rewritten too)."""
    if codec is None:
        return "sign1bit" if quantize else "identity"
    if not quantize and getattr(codec, "name", codec) == "sign1bit":
        return "identity"
    return codec


@functools.lru_cache(maxsize=None)
def _worker_mask(layout, inner_index, device: str):
    """Pad mask of the buffer each stacked worker encodes, broadcastable
    against it, or None without padding (cached): the view's mask
    (n, A/n, 1, ...) when flat; with ``inner_index`` (one per stacked
    worker) the mask of the inner slice each owns, (stack, n_outer, A/n,
    1, ...)."""
    m = C.pad_mask(layout, device=torch.device(device))
    if m is None or inner_index is None:
        return m
    m = m.reshape((layout.n_inner, layout.n_outer) + tuple(m.shape[1:]))
    return m[list(inner_index)]


class _DenseEFCodec(Codec):
    """Error feedback around a plain masked ``_encode(z, layout, mask) ->
    (payload, err)`` over a (stack, lead, *chunk) buffer: the worker pass
    folds the incoming error into the buffer, the server pass also adds
    the chunk dim of 1. A codec of this kind implements ``_encode``,
    ``decode`` and ``wire_bytes``."""

    def _encode(self, z, layout, mask):
        raise NotImplementedError

    def encode_worker(self, z, err, layout, mode, inner_index=None):
        j = None if inner_index is None else tuple(int(i) for i in
                                                   inner_index)
        return self._encode(z + err.to(z.dtype), layout,
                            _worker_mask(layout, j, str(z.device)))

    def encode_server(self, avg, err, layout, mode, worker_index):
        y = (avg + err.to(avg.dtype))[:, None]
        mask = _server_mask(layout, tuple(int(w) for w in worker_index),
                            str(avg.device))
        payload, e = self._encode(y, layout, mask)
        return payload, e[:, 0]


def _rows(z, layout):
    """(stack, lead, *chunk) -> (stack * lead, chunk elements)."""
    return z.reshape(z.shape[0] * z.shape[1], _chunk_elems(layout))


@dataclasses.dataclass(frozen=True)
class TopKCodec(_DenseEFCodec):
    """Ship the ``density`` fraction of largest-magnitude elements of
    each chunk as (int32 index, f32 value) pairs; the rest stays in the
    error buffer. ``k`` is fixed per layout (``ceil(density *
    chunk_elems)``). Padded positions are zeroed before the selection, so
    they are picked only when a chunk has fewer than ``k`` true elements,
    and then carry exact zeros."""

    density: float = 0.01
    name = "topk"

    def __post_init__(self):
        if not 0.0 < self.density <= 1.0:
            raise ValueError(
                f"topk density must be in (0, 1], got {self.density}")

    def k_for(self, layout: C.LeafLayout) -> int:
        ce = _chunk_elems(layout)
        return max(1, min(ce, int(math.ceil(self.density * ce))))

    def _encode(self, z, layout, mask):
        stack, lead = z.shape[:2]
        if mask is not None:
            z = z * mask.to(z.dtype)
        zf = _rows(z, layout)
        k = self.k_for(layout)
        idx = top_k_indices(zf.abs(), k)
        val = torch.gather(zf, 1, idx)
        # the residual: zf with the shipped elements zeroed
        err = zf.scatter(1, idx, 0.0).reshape(z.shape)
        return ({"idx": idx.to(torch.int32).reshape(stack, lead, k),
                 "val": val.reshape(stack, lead, k)}, err)

    def decode(self, payload, layout):
        idx, val = payload["idx"], payload["val"]
        stack, lead, k = idx.shape
        dense = torch.zeros((stack * lead, _chunk_elems(layout)),
                            dtype=torch.float32, device=val.device)
        dense.scatter_(1, idx.reshape(-1, k).long(),
                       val.reshape(-1, k).to(torch.float32))
        return dense.reshape((stack, lead) + tuple(layout.chunk_shape))

    def payload_spec(self, layout):
        leaves = (("idx", torch.int32), ("val", torch.float32))
        return {"scatter": leaves, "gather": leaves}

    def wire_bytes(self, layout, mode):
        per = self.k_for(layout) * (4 + 4)     # int32 index + f32 value
        return {"scatter": per, "gather": per}


def top_k_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (rows, k) of the ``k`` largest of each row of ``a``, equal
    values taken lowest index first, in ``jax.lax.top_k``'s order
    (descending value, ties by ascending index): the reference's
    selection and payload, on every device. (``torch.topk`` breaks ties
    differently on the card and on the CPU, and the two-level exchange's
    bf16 phases make ties at the k-th value common.)"""
    if a.device.type == "meta":
        # the selection below reads counts on the host; a meta tensor
        # (the audit's shape derivation) has only its shape
        return torch.empty((a.shape[0], k), dtype=torch.int64,
                           device=a.device)
    kth = torch.topk(a, k, dim=1).values[:, -1:]
    take = a > kth
    tie = a == kth
    room = k - take.sum(dim=1, keepdim=True)
    # only rows with more ties than room pay for the scan over the row
    over = (tie.sum(dim=1, keepdim=True) > room).reshape(-1).nonzero()
    if over.numel():
        r = over.reshape(-1)
        tie[r] &= torch.cumsum(tie[r], dim=1) <= room[r]
    idx = (take | tie).nonzero()[:, 1].reshape(a.shape[0], k)
    # a stable sort keeps equal values in ascending index order
    order = torch.sort(a.gather(1, idx), dim=1, descending=True,
                       stable=True).indices
    return idx.gather(1, order)


_KNUTH = 2654435761        # the reference's uint32 multiplier
_MASK32 = 0xFFFFFFFF


def _hash_dither(x: torch.Tensor) -> torch.Tensor:
    """Deterministic U[0, 1) dither from the value's own f32 bits, the
    reference's Knuth multiplicative hash and xor-fold in uint32
    arithmetic: ``h = bits * 2654435761 mod 2**32; h ^= h >> 16;
    (h >> 8) / 2**24``. torch has no uint32 multiply on every device, so
    the product is taken in int64 over the multiplier's 16-bit halves (no
    partial product reaches 2**49), then reduced mod 2**32. Exact zeros
    dither to exactly 0."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    b = b & _MASK32
    h = (b * (_KNUTH & 0xFFFF)
         + (((b * (_KNUTH >> 16)) & 0xFFFF) << 16)) & _MASK32
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


@dataclasses.dataclass(frozen=True)
class QIntCodec(_DenseEFCodec):
    """Integer quantization: one max-abs scale per chunk, codes in
    ``[-qmax, qmax]`` by stochastic rounding (``floor(z/s + dither)``),
    the rounding error kept by error feedback. ``bits=4`` packs two
    offset-binary codes per byte, high nibble first."""

    bits: int = 8

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"qint bits must be 4 or 8, got {self.bits}")

    @property
    def name(self):
        return f"qint{self.bits}"

    @property
    def qmax(self) -> int:
        return 127 if self.bits == 8 else 7

    def _encode(self, z, layout, mask):
        stack, lead = z.shape[:2]
        if mask is not None:
            z = z * mask.to(z.dtype)
        zf = _rows(z, layout).to(torch.float32)
        qmax = float(self.qmax)
        # as XLA compiles the reference's (jax 0.9.0, CPU): the divide by
        # the constant qmax becomes a multiply by its f32 reciprocal, and
        # the residual zf - q*s one FMA
        s = zf.abs().amax(dim=1, keepdim=True) * float(np.float32(1 / qmax))
        s_safe = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.clamp(torch.floor(zf / s_safe + _hash_dither(zf)),
                        -qmax, qmax)
        err = fma(q, -s, zf).to(z.dtype).reshape(z.shape)
        scale = s.reshape(stack, lead, 1)
        if self.bits == 8:
            return {"q": q.to(torch.int8).reshape(stack, lead, -1),
                    "scale": scale}, err
        u = (q + qmax).to(torch.uint8)          # offset binary in [0, 14]
        pair = u.reshape(stack * lead, -1, 2)
        packed = pair[..., 0] * 16 + pair[..., 1]
        return {"q": packed.reshape(stack, lead, -1), "scale": scale}, err

    def _codes(self, q):
        """Payload codes (stack, lead, bytes) -> f32 codes (stack, lead,
        chunk elements)."""
        if self.bits == 4:
            q = torch.stack([q // 16, q % 16], dim=-1).reshape(
                q.shape[0], q.shape[1], -1).to(torch.float32) - float(
                    self.qmax)
        return q.to(torch.float32)

    def decode(self, payload, layout):
        q, s = self._codes(payload["q"]), payload["scale"]
        return (q * s.to(torch.float32)).reshape(
            tuple(q.shape[:2]) + tuple(layout.chunk_shape))

    def decode_mean(self, payload, layout):
        """The server's mean of the senders' decoded chunks, as XLA fuses
        the reference's decode into its mean (jax 0.9.0, CPU): the first
        product, then one FMA per further sender in sender order, then a
        multiply by the f32 reciprocal of their number."""
        q, s = self._codes(payload["q"]), payload["scale"].to(torch.float32)
        acc = q[:, 0] * s[:, 0]
        for i in range(1, q.shape[1]):
            acc = fma(q[:, i], s[:, i], acc)
        acc = acc * float(np.float32(1.0 / q.shape[1]))
        return acc.reshape((q.shape[0],) + tuple(layout.chunk_shape))

    def payload_spec(self, layout):
        qdt = torch.int8 if self.bits == 8 else torch.uint8
        leaves = (("q", qdt), ("scale", torch.float32))
        return {"scatter": leaves, "gather": leaves}

    def wire_bytes(self, layout, mode):
        ce = _chunk_elems(layout)
        per = (ce if self.bits == 8 else ce // 2) + 4   # codes + f32 scale
        return {"scatter": per, "gather": per}


_FACTORIES = {
    "sign1bit": lambda arg: Sign1BitCodec(),
    "topk": lambda arg: TopKCodec(density=0.01 if arg is None
                                  else float(arg)),
    "qint8": lambda arg: QIntCodec(bits=8),
    "qint4": lambda arg: QIntCodec(bits=4),
    "identity": lambda arg: IdentityCodec(),
}

CODEC_NAMES = tuple(sorted(_FACTORIES))

# which codecs take a ``codec_arg``, and what it means
CODEC_ARGS = {"topk": "density in (0, 1] (default 0.01)"}


def make_codec(spec, arg: Optional[float] = None) -> Codec:
    """Resolve a codec name (with its optional argument) or pass an
    instance through. Raises ``ValueError`` naming the registry on an
    unknown name, and on a ``codec_arg`` given to a codec that takes
    none; an instance with an ``arg`` is re-made through the registry."""
    if isinstance(spec, Codec):
        if arg is None:
            return spec
        if spec.name in _FACTORIES and spec.name in CODEC_ARGS:
            return _FACTORIES[spec.name](arg)
        raise ValueError(
            f"codec {spec.name!r} takes no codec_arg (got {arg!r}); only "
            f"{sorted(CODEC_ARGS)} are parameterized: {CODEC_ARGS}")
    if not isinstance(spec, str) or spec not in _FACTORIES:
        raise ValueError(
            f"unknown codec {spec!r}; choose from {list(CODEC_NAMES)}")
    if arg is not None and spec not in CODEC_ARGS:
        raise ValueError(
            f"codec {spec!r} takes no codec_arg (got {arg!r}); only "
            f"{sorted(CODEC_ARGS)} are parameterized: {CODEC_ARGS}")
    return _FACTORIES[spec](arg)
