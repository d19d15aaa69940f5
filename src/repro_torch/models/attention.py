"""Grouped-query attention, PyTorch port of the training path of
``src/repro/models/attention.py``: the template, the additive mask and
``dot_attn``. Below ``ModelConfig.blockwise_threshold`` the reference
never takes its flash-style path, so that, the KV-cache decode and MLA
wait for later slices.

Layouts follow the reference: activations (B, S, D), per-head tensors
(B, S, H, hd). The two attention products are plain ``torch.einsum``
matrix products, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import rope as R
from repro_torch.models.layers import PD, model_dim_spec

NEG_INF = -1e30
_PAD_SENTINEL = 2 ** 29  # key positions >= this are padding


def gqa_template(d, n_heads, n_kv, head_dim, bias=False, stack=None):
    hs = model_dim_spec(n_heads * head_dim)
    ks = model_dim_spec(n_kv * head_dim)

    def st(shape, spec, init="normal"):
        if stack is None:
            return PD(shape, init, spec=spec)
        return PD((stack, *shape), init, spec=(None, *spec))

    t = {"wq": st((d, n_heads * head_dim), (None, hs)),
         "wk": st((d, n_kv * head_dim), (None, ks)),
         "wv": st((d, n_kv * head_dim), (None, ks)),
         "wo": st((n_heads * head_dim, d), (hs, None))}
    if bias:
        t["bq"] = st((n_heads * head_dim,), (hs,), "zeros")
        t["bk"] = st((n_kv * head_dim,), (ks,), "zeros")
        t["bv"] = st((n_kv * head_dim,), (ks,), "zeros")
    return t


def _mask_bias(q_pos, k_pos, kind: str):
    """Additive f32 mask (Sq, Sk): 0 where the query may attend to the
    key, NEG_INF elsewhere. ``kind="causal"``: valid keys not after the
    query; ``kind="bidir"``: every valid key (the reference's kinds of
    the same names)."""
    if kind not in ("causal", "bidir"):
        raise NotImplementedError(f"mask kind {kind!r} is not ported yet")
    ok = (k_pos < _PAD_SENTINEL)[None, :].expand(q_pos.shape[0], -1)
    if kind == "causal":
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def dot_attn(q, k, v, bias):
    """q (B,Sq,H,hd), k (B,Sk,K,hd), v (B,Sk,K,dv), bias (Sq,Sk)."""
    B, Sq, H, hd = q.shape
    K, dv = k.shape[2], v.shape[3]
    qg = q.reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    s = s / math.sqrt(hd) + bias
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return o.reshape(B, Sq, H, dv)


def gqa_forward(p, cfg, x, positions):
    """Training-path GQA attention over (B, S, D), causal or bidirectional
    as ``cfg.causal`` says; returns (out, None)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.rope != "none":
        # as in the reference: any rope setting but "none" rotates q, k
        q = R.apply_rope(q, positions)
        k = R.apply_rope(k, positions)
    pos = positions[0]
    kind = "causal" if cfg.causal else "bidir"
    o = dot_attn(q, k, v, _mask_bias(pos, pos, kind))
    return o.reshape(B, S, H * hd) @ p["wo"], None
