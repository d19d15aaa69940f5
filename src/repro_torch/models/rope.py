"""Token positions and rotary embedding, PyTorch port of
``src/repro/models/rope.py``: the standard and partial (ChatGLM) paths,
and Qwen2-VL's M-RoPE, whose positions are (3, B, S) temporal / height /
width streams, each stream rotating its own band of the head dim's pairs
(``sections``).

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


@functools.lru_cache(maxsize=None)
def _bands(sections, device: torch.device):
    """The stream (0 t, 1 h, 2 w) of each rotated pair under M-RoPE."""
    return torch.cat([torch.full((s,), i, dtype=torch.long)
                      for i, s in enumerate(sections)]).to(device)


def apply_rope(x, positions, theta=10000.0, fraction=1.0, sections=None):
    """Rotate the first ``int(D * fraction)`` dims (rounded down to even)
    of x (B, S, H, D) by positions (B, S) at base ``theta``, and pass the
    rest through; the two halves of the rotated part form the pairs, as
    in the reference. ``sections`` (M-RoPE): positions are (3, B, S) and
    pair i turns at the position of the stream its band gives
    (``sections`` pairs to each stream in turn, summing to the pairs).
    Without ``sections``, (3, B, S) positions rotate by stream 0."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    inv = _freqs(half, float(theta), x.device)
    if sections is not None:
        if positions.dim() != 3 or sum(sections) != half:
            raise ValueError(f"M-RoPE needs (3, B, S) positions and sections "
                             f"summing to {half} pairs; got positions of "
                             f"shape {tuple(positions.shape)}, sections "
                             f"{tuple(sections)}")
        pos = positions[_bands(tuple(sections), positions.device)]
        ang = pos.movedim(0, -1).to(torch.float32) * inv[None, None, :]
    else:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions.to(torch.float32)[..., None] * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:rot]
    parts = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
    if rot < d:
        parts.append(x[..., rot:])
    return torch.cat(parts, dim=-1)


def _offset_index(seq: int, offset, device):
    """(1 or B, seq) int32 indices ``offset .. offset + seq - 1``;
    ``offset`` an int or a (B,) tensor with one offset per row."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        return offset.to(device=device, dtype=torch.int32)[:, None] + pos
    return (pos + offset)[None, :]


def text_positions(batch: int, seq: int, offset=0, device=None):
    """(batch, seq) int32 positions ``offset .. offset + seq - 1``.
    ``offset`` is an int, or a (batch,) tensor with one offset per row
    (the scheduler's slots decode at their own positions; the reference
    gets them by ``vmap`` over ``decode``)."""
    return _offset_index(seq, offset, device).expand(batch, seq)


def mrope_positions(batch: int, seq: int, n_vision: int, grid_h: int,
                    offset=0, device=None):
    """Qwen2-VL's (3, batch, seq) int32 positions, as the reference's: the
    first ``n_vision`` indices are the vision prefix, at temporal 0 on a
    (h, w) grid of rows of ``grid_h``; text positions continue on all
    three streams at ``ceil(n_vision / grid_h) + (i - n_vision)``.
    ``offset`` as in :func:`text_positions` (an int, or one per row)."""
    idx = _offset_index(seq, offset, device)
    g = max(grid_h, 1)
    is_vis = idx < n_vision
    vis = torch.clamp_max(idx, max(n_vision - 1, 0))
    base = (n_vision + grid_h - 1) // g if n_vision else 0
    text = base + (idx - n_vision)
    pos = torch.stack([torch.where(is_vis, 0, text),
                       torch.where(is_vis, vis // g, text),
                       torch.where(is_vis, vis % g, text)])
    return pos.expand(3, batch, seq)
