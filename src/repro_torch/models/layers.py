"""Parameter templates and elementary layers, PyTorch port of
``src/repro/models/layers.py``.

A module builds a *template*: a nested dict whose leaves are :class:`PD`
descriptors. Parameters, tensor-parallel specs and the DP mask all derive
from it, so they agree by construction. An expert-parallel leaf
(``dp=False``, its ``ep_axis`` split over the workers) stays out of the
data-parallel exchange. The specs matter even without
tensor parallelism: ``core.compressor.make_layout`` chooses each leaf's
comm view from them, exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PD:
    """Param descriptor: shape, init, tensor-parallel spec, DP membership."""

    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 0.02
    spec: Optional[tuple] = None  # per-axis 'model' entries, or None
    dp: bool = True
    ep_axis: Optional[int] = None  # expert-parallel axis (dp=False
                                   # leaves): split over the workers


def _map(tmpl, fn, prefix=()):
    if isinstance(tmpl, dict):
        return {k: _map(v, fn, prefix + (k,)) for k, v in tmpl.items()}
    return fn(prefix, tmpl)


# elements a chunk of an expert-parallel block's draw (a multiple of 16)
_BLOCK_CHUNK = 1 << 24


def _seed(seed: int, path) -> int:
    return ((seed * 1_000_003 + zlib.crc32("/".join(path).encode()))
            & 0x7FFFFFFFFFFF)


def _draw_block(pd: PD, g, n: int, i: int, device, dtype):
    """Block ``i`` of ``n`` along ``pd.ep_axis`` of ``torch.randn(pd.shape,
    generator=g) * pd.scale``, drawn in chunks of _BLOCK_CHUNK elements
    and copied out piece by piece, so the host never holds the whole
    leaf. The values are the whole draw's: the CPU's normal fill draws
    one uniform an element in order and transforms them 16 at a time
    (its tail of under 16 from 16 more uniforms), so chunks that start at
    multiples of 16, the last one at least 16 long, give the same
    numbers. The draw stops after the block's last element."""
    a = pd.ep_axis
    inner = math.prod(pd.shape[a + 1:])
    row = pd.shape[a] * inner                 # one index of the dims before
    width = row // n                          # the block's part of a row
    lo = i * width
    total = math.prod(pd.shape)
    stop = total - row + lo + width           # after the last row's block
    out = torch.empty(total // n, device=device, dtype=dtype)
    pos = 0
    while pos < stop:
        end = min(pos + _BLOCK_CHUNK, total)
        if 0 < total - end < 16:
            end = total
        x = torch.randn(end - pos, generator=g).mul_(pd.scale)
        for r in range(pos // row, (end - 1) // row + 1):
            a0, a1 = max(pos, r * row + lo), min(end, r * row + lo + width)
            if a0 < a1:
                dst = r * width + a0 - r * row - lo
                out[dst:dst + a1 - a0].copy_(x[a0 - pos:a1 - pos])
        pos = end
    shape = list(pd.shape)
    shape[a] //= n
    return out.view(shape)


def init_params(template, seed: int, device=None, dtype=torch.float32,
                ep_block=None):
    """Materialize a template. Each leaf draws from its own CPU generator
    seeded from ``seed`` and its path, so the values do not depend on the
    device or on the order of leaves. (The reference draws from jax's
    threefry; its values come across through ``repro_torch.interop``.)
    A generator fills its tensor on one core, so the leaves are drawn on
    a pool of threads, one leaf a thread. ``ep_block=(n, i)``: each
    expert-parallel leaf keeps only block ``i`` of ``n`` along its
    ``ep_axis`` (a process's experts), with the values of the whole
    draw (:func:`_draw_block`)."""
    def make(path, pd: PD):
        cut = ep_block is not None and pd.ep_axis is not None
        if pd.init in ("zeros", "ones"):
            shape = list(pd.shape)
            if cut:
                shape[pd.ep_axis] //= ep_block[0]
            x = (torch.zeros if pd.init == "zeros" else torch.ones)(shape)
        else:
            g = torch.Generator().manual_seed(_seed(seed, path))
            if cut:
                return _draw_block(pd, g, *ep_block, device, dtype)
            x = torch.randn(pd.shape, generator=g).mul_(pd.scale)
        return x.to(device=device, dtype=dtype)

    leaves = []
    _map(template, lambda path, pd: leaves.append((path, pd)))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        made = dict(zip((p for p, _ in leaves),
                        ex.map(lambda item: make(*item), leaves)))
    return _map(template, lambda path, _: made[path])


def param_shapes(template):
    return _map(template, lambda _, pd: tuple(pd.shape))


def local_shapes(template, ep_degree: int):
    """Each leaf's shape on one worker of an expert-parallel degree of
    ``ep_degree``: an expert-parallel leaf holds ``E / ep_degree``
    experts along its ``ep_axis``, every other leaf its whole shape."""
    def f(_, pd: PD):
        sh = list(pd.shape)
        if pd.ep_axis is not None:
            sh[pd.ep_axis] //= ep_degree
        return tuple(sh)
    return _map(template, f)


def param_specs(template):
    return _map(template, lambda _, pd: pd.spec)


def dp_mask(template):
    return _map(template, lambda _, pd: pd.dp)


def ep_axes(template):
    """Each leaf's expert-parallel axis (None: a leaf of every worker)."""
    return _map(template, lambda _, pd: pd.ep_axis)


def stack_template(tmpl, n: int):
    """Prepend a layer-stacking axis to every PD of a template."""
    def f(_, pd: PD) -> PD:
        spec = pd.spec if pd.spec is not None else (None,) * len(pd.shape)
        ep = None if pd.ep_axis is None else pd.ep_axis + 1
        return dataclasses.replace(pd, shape=(n, *pd.shape),
                                   spec=(None, *spec), ep_axis=ep)
    return _map(tmpl, f)


def model_dim_spec(dim: int, mesh_axis: str = "model"):
    """Shard ``dim`` over 'model' iff the production TP degree (16)
    divides it — the rule the reference's templates use."""
    return mesh_axis if dim % 16 == 0 else None


# ---------------------------------------------------------------------------
# Elementary ops
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    """The reference's RMSNorm: in f32, ``x * rsqrt(mean(x^2) + eps)``
    times the gain ``1 + scale`` (scale initialized to zeros)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def norm_template(cfg_norm: str, d: int):
    if cfg_norm == "rmsnorm":
        return {"scale": PD((d,), "zeros")}
    return {"scale": PD((d,), "ones"), "bias": PD((d,), "zeros")}


def apply_norm(p, x, cfg_norm: str):
    if cfg_norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def mlp_template(d: int, ff: int, kind: str,
                 layers_axis: Optional[int] = None):
    """SwiGLU or GELU MLP params, optionally stacked over a layers axis."""
    def st(shape, spec):
        if layers_axis is None:
            return shape, spec
        return (layers_axis, *shape), (None, *spec)
    ffs = model_dim_spec(ff)
    if kind == "swiglu":
        s1, p1 = st((d, ff), (None, ffs))
        s3, p3 = st((d, ff), (None, ffs))
        s2, p2 = st((ff, d), (ffs, None))
        return {"w_gate": PD(s1, spec=p1), "w_up": PD(s3, spec=p3),
                "w_down": PD(s2, spec=p2)}
    s1, p1 = st((d, ff), (None, ffs))
    s2, p2 = st((ff, d), (ffs, None))
    sb1, pb1 = st((ff,), (ffs,))
    sb2, pb2 = st((d,), (None,))
    return {"w_in": PD(s1, spec=p1), "b_in": PD(sb1, "zeros", spec=pb1),
            "w_out": PD(s2, spec=p2), "b_out": PD(sb2, "zeros", spec=pb2)}


def apply_mlp(p, x, kind: str):
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return h @ p["w_out"] + p["b_out"]
