"""Token positions and rotary embedding, PyTorch port of the standard and
partial (ChatGLM) paths of ``src/repro/models/rope.py`` (M-RoPE is not
ported: ROADMAP item 4).

The reference's attention rotates q and k whenever ``cfg.rope != "none"``,
so GPT-2 (``rope="learned"``) gets the rotary embedding on top of its
learned position table; the port does the same.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _freqs(dim: int, theta: float, device: torch.device):
    """Inverse frequencies of ``dim`` rotated pairs at base ``theta``,
    computed on the CPU and moved to ``device`` once per (dim, theta,
    device) (no copy per call)."""
    return (1.0 / (theta ** (torch.arange(0, dim, dtype=torch.float32)
                             / dim))).to(device)


def apply_rope(x, positions, theta=10000.0, fraction=1.0):
    """Rotate the first ``int(D * fraction)`` dims (rounded down to even)
    of x (B, S, H, D) by positions (B, S) at base ``theta``, and pass the
    rest through; the two halves of the rotated part form the pairs, as
    in the reference."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    inv = _freqs(half, float(theta), x.device)
    ang = positions.to(torch.float32)[..., None] * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:rot]
    parts = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
    if rot < d:
        parts.append(x[..., rot:])
    return torch.cat(parts, dim=-1)


def text_positions(batch: int, seq: int, offset=0, device=None):
    """(batch, seq) int32 positions ``offset .. offset + seq - 1``.
    ``offset`` is an int, or a (batch,) tensor with one offset per row
    (the scheduler's slots decode at their own positions; the reference
    gets them by ``vmap`` over ``decode``)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        return offset.to(torch.int32)[:, None] + pos[None, :]
    return (pos + offset)[None, :].expand(batch, seq)
