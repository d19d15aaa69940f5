"""Wire formats of the error-feedback exchange, PyTorch port of
``src/repro/core/codecs.py`` (sign1bit and identity).

* ``encode_worker(z, err, layout, mode, inner_index) -> (payload,
  err')`` — one EF pass over each stacked worker's full comm view, or,
  with ``inner_index``, over the inner reduce-scatter slice it owns;
* ``encode_server(avg, err, layout, mode, widx) -> (payload, err')``
  — the pass over the chunk each worker serves (payload leaves carry a
  chunk dim of 1 for the all_gather);
* ``decode(payload, layout) -> dense f32`` — the chunk dim is kept;
* ``wire_bytes(layout, mode)`` — bytes of one chunk's payload per phase.

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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.core import compressor as C


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

    def wire_bytes(self, layout, mode) -> Dict[str, int]:
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

    def wire_bytes(self, layout, mode):
        ce = _chunk_elems(layout) * 4
        return {"scatter": ce, "gather": ce}


_FACTORIES = {"sign1bit": Sign1BitCodec, "identity": IdentityCodec}
_LATER = ("topk", "qint8", "qint4")


def make_codec(spec) -> Codec:
    """Resolve a codec name or pass an instance through."""
    if isinstance(spec, Codec):
        return spec
    if spec in _LATER:
        raise NotImplementedError(
            f"codec {spec!r} is not ported yet; topk and qint8/qint4 come "
            f"with a later slice of the port (ROADMAP queue 1, item 10)")
    if spec not in _FACTORIES:
        raise ValueError(f"unknown codec {spec!r}; choose from "
                         f"{sorted(_FACTORIES) + list(_LATER)}")
    return _FACTORIES[spec]()
