"""Grouped-query attention, PyTorch port of the dense path of
``src/repro/models/attention.py``: the template, the additive mask
(causal, sliding-window and bidirectional), ``dot_attn``, the flash-style
``blockwise_attn`` (taken at S >= ``ModelConfig.blockwise_threshold``)
and the KV-cache ``decode_attn``, over a full cache or a ring of
``window`` slots; whisper's cross-attention (``gqa_forward``'s
``kv_override``) and qwen2-vl's M-RoPE; and DeepSeek-V2's multi-head
latent attention (:func:`mla_forward`) with its latent cache and the
absorbed decode (:func:`mla_absorbed_decode`).

The prefill mask reads the query positions of stream 0, row 0: with
M-RoPE's (3, B, S) positions that is the temporal stream, on which the
whole vision prefix sits at 0, so the prefix attends both ways inside
itself, as in the reference. A decode step masks by its cache slot.

Layouts follow the reference: activations (B, S, D), per-head tensors
(B, S, H, hd), KV caches (B, S_max, K, hd). The attention products are
plain ``torch.einsum`` matrix products, as the reference leaves them to
XLA (its own docstring leaves a fused kernel for later).

Caches are written in place (the reference donates its cache buffers):
a decode step writes k/v at ``cache_pos``, a prefill writes ``[0, S)``.
``cache_pos`` may be a (B,) tensor, one position per row: each row is
written and masked at its own position, the scheduler's vmapped decode
of the reference computed batched. A sliding layer whose cache holds
exactly ``window`` slots keeps a ring: position p lives in slot
``p % window`` (keys are rotated at their absolute positions, so slot
order does not matter).
"""
from __future__ import annotations

import math

import numpy as np
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


def mla_template(d, n_heads, kv_lora, qk_nope, qk_rope, v_dim, stack=None):
    """Multi-head latent attention params (the reference's, leaf for
    leaf): the query projection, the down-projection to the latent plus
    the shared rope key, the latent's RMSNorm gain and the up-projections
    to per-head keys and values."""
    hq = model_dim_spec(n_heads * (qk_nope + qk_rope))
    hu = model_dim_spec(n_heads * qk_nope)
    hv = model_dim_spec(n_heads * v_dim)

    def st(shape, spec):
        if stack is None:
            return PD(shape, spec=spec)
        return PD((stack, *shape), spec=(None, *spec))

    return {"wq": st((d, n_heads * (qk_nope + qk_rope)), (None, hq)),
            "w_dkv": st((d, kv_lora + qk_rope), (None, None)),
            "kv_norm": st((kv_lora,), (None,)),
            "w_uk": st((kv_lora, n_heads * qk_nope), (None, hu)),
            "w_uv": st((kv_lora, n_heads * v_dim), (None, hv)),
            "wo": st((n_heads * v_dim, d), (hv, None))}


def _mask_bias(q_pos, k_pos, kind: str, window: int = 0):
    """Additive f32 mask (Sq, Sk): 0 where the query may attend to the
    key, NEG_INF elsewhere, as the reference's kinds of the same names:
    ``bidir`` every valid key; ``causal`` valid keys not after the query;
    ``sliding`` with a ``window`` those of them less than ``window``
    positions back (``0 <= q - k < window``)."""
    if kind not in ("causal", "sliding", "bidir"):
        raise ValueError(f"mask kind {kind!r}: causal, sliding or bidir")
    ok = (k_pos < _PAD_SENTINEL)[None, :].expand(q_pos.shape[0], -1)
    if kind != "bidir":
        rel = q_pos[:, None] - k_pos[None, :]
        ok = ok & (rel >= 0)
        if kind == "sliding" and window:
            ok = ok & (rel < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def _mm_dtype(a, b):
    """The dtype ``jnp`` promotes a product of ``a`` and ``b`` to
    (``torch.einsum`` refuses mixed operands)."""
    return torch.promote_types(a.dtype, b.dtype)


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


def blockwise_attn(q, k, v, q_pos, k_pos, kind, window=0, bq=512,
                   bk=1024):
    """Flash-style attention: query blocks of ``bq``, and for each an
    online softmax over KV blocks of ``bk``, so memory is O(bq * bk) per
    step whatever the length. As the reference's ``lax.map`` /
    ``lax.scan``: queries pad with position -1 and keys with
    ``2**29``, every KV block is visited (masked ones too), scores are
    *multiplied* by ``1 / sqrt(hd)`` (``dot_attn`` divides) and the
    result is ``acc / max(den, 1e-30)``."""
    B, Sq, H, hd = q.shape
    Sk, K, dv = k.shape[1], k.shape[2], v.shape[3]
    g = H // K
    bq, bk = min(bq, Sq), min(bk, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    F = torch.nn.functional
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * bq - Sq))
    qposp = F.pad(q_pos, (0, nq * bq - Sq), value=-1)
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * bk - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * bk - Sk))
    kposp = F.pad(k_pos, (0, nk * bk - Sk), value=_PAD_SENTINEL)
    # the reference's f32 ``1.0 / jnp.sqrt(hd)``
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    out = []
    for i in range(nq):
        qg = qp[:, i * bq:(i + 1) * bq].reshape(B, bq, K, g, hd)
        qpos_i = qposp[i * bq:(i + 1) * bq]
        acc = torch.zeros((B, K, g, bq, dv), dtype=torch.float32,
                          device=q.device)
        mx = torch.full((B, K, g, bq), NEG_INF, dtype=torch.float32,
                        device=q.device)
        den = torch.zeros((B, K, g, bq), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            kj = kp[:, j * bk:(j + 1) * bk]
            vj = vp[:, j * bk:(j + 1) * bk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj).to(torch.float32)
            s = s * scale
            s = s + _mask_bias(qpos_i, kposp[j * bk:(j + 1) * bk], kind,
                               window)
            new_mx = torch.maximum(mx, s.amax(dim=-1))
            p = torch.exp(s - new_mx[..., None])
            corr = torch.exp(mx - new_mx)
            den = den * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vj.dtype), vj)
            acc = acc * corr[..., None].to(acc.dtype) + pv.to(torch.float32)
            mx = new_mx
        o = acc / torch.clamp_min(den[..., None], 1e-30)
        out.append(o.movedim(3, 1).reshape(B, bq, K * g, dv).to(q.dtype))
    return torch.cat(out, dim=1)[:, :Sq]


def decode_attn(q, k_cache, v_cache, pos, kind="causal", window=0,
                ring=False):
    """One query position per row against a (B, S, K, hd) cache, at
    ``pos`` (an int, or a (B,) tensor per row). Keys at positions
    ``<= pos`` (``kind`` causal and, as in the reference, bidir), and for
    ``sliding`` only those ``> pos - window``. ``ring=True``: the cache is
    a ring of S == window slots holding the last S positions; a slot is
    valid once written (``slot <= pos`` or ``pos >= S``)."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        p = pos.to(device=q.device, dtype=torch.int32)[:, None]
    else:
        p = int(pos)
    if ring:
        ok = (kpos <= p) | (p >= S)
    else:
        ok = kpos <= p
        if kind == "sliding" and window:
            ok = ok & (kpos > p - window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(ok, zero, NEG_INF)                 # (B or 1, S)
    qg = q.reshape(B, 1, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(_mm_dtype(q, k_cache)),
                     k_cache.to(_mm_dtype(q, k_cache))).to(torch.float32)
    s = s / math.sqrt(hd) + bias[:, None, None, None, :]
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache)
    return o.reshape(B, 1, H, hd)


def _write_cache(cache, k, v, cache_pos, ring=0):
    """Write the new keys and values into the layer's cache in place: a
    prefill (``cache_pos`` None or 0 with S > 1) at ``[0, S)``, a decode
    step at ``cache_pos`` (an int, or a (B,) tensor: row b at
    ``cache_pos[b]``). ``ring``: the cache is a ring of that many slots,
    position p goes to slot ``p % ring`` (a prefill keeps its last
    ``ring`` positions). Values are cast to the cache's dtype."""
    ck, cv = cache["k"], cache["v"]
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        slot = cache_pos.to(device=k.device, dtype=torch.long)
        if ring:
            slot = slot % ring
        idx = (torch.arange(k.shape[0], device=k.device), slot)
        ck.index_put_(idx, k[:, 0].to(ck.dtype))
        cv.index_put_(idx, v[:, 0].to(cv.dtype))
        return {"k": ck, "v": cv}
    p, S = int(cache_pos or 0), k.shape[1]
    if ring:
        lo = max(0, S - ring)
        slots = (torch.arange(p + lo, p + S, device=k.device) % ring)
        ck[:, slots] = k[:, lo:].to(ck.dtype)
        cv[:, slots] = v[:, lo:].to(cv.dtype)
    else:
        ck[:, p:p + S] = k
        cv[:, p:p + S] = v
    return {"k": ck, "v": cv}


def query_positions(positions):
    """The positions a prefill masks by: stream 0 of (3, B, S) M-RoPE
    positions, then row 0 (the reference's ``qpos0``)."""
    if positions.dim() == 3:
        positions = positions[0]
    return positions[0] if positions.dim() == 2 else positions


def gqa_forward(p, cfg, x, positions, *, kind=None, window=0, cache=None,
                cache_pos=None, kv_override=None, use_blockwise=False):
    """GQA attention over (B, S, D). ``kind``: causal, sliding (with
    ``window``) or bidir; by default causal or bidirectional as
    ``cfg.causal`` says. q and k are rotated at ``cfg.rope_theta`` over
    ``cfg.rope_fraction`` of the head dim (M-RoPE: by ``positions``' three
    streams over ``cfg.mrope_sections``). Returns (out, the layer's
    cache or None).

    ``cache``: the layer's {"k", "v"} (B, S_max, K, hd), written in place
    (a ring when a sliding layer's cache holds exactly ``window`` slots,
    as in the reference); with S == 1 and a ``cache_pos`` this is a decode
    step against the cache, else a prefill that fills it and attends over
    the new keys alone. ``use_blockwise``: the flash-style path.

    ``kv_override``: (k, v) of shape (B, S_enc, K, hd) computed elsewhere
    (whisper's cross-attention): only ``bq`` is added, nothing is rotated,
    no cache is taken, and every query attends to every key
    (bidirectional over key positions ``0 .. S_enc - 1``)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    if kind is None:
        kind = "causal" if cfg.causal else "bidir"
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, H, hd)
    if kv_override is not None:
        if cache is not None:
            raise ValueError("kv_override (cross-attention) takes no cache")
        k, v = kv_override
        kpos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        o = dot_attn(q, k, v, _mask_bias(query_positions(positions), kpos,
                                          "bidir"))
        return o.reshape(B, S, H * hd) @ p["wo"], None
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.rope != "none":
        # as in the reference: any rope setting but "none" rotates q, k
        rot = (cfg.rope_theta, cfg.rope_fraction) + (
            (cfg.mrope_sections,) if cfg.rope == "mrope" else ())
        q = R.apply_rope(q, positions, *rot)
        k = R.apply_rope(k, positions, *rot)
    new_kv = None
    if cache is not None:
        ring = (window if kind == "sliding" and window > 0
                and cache["k"].shape[1] == window else 0)
        new_kv = _write_cache(cache, k, v, cache_pos, ring)
        if S == 1 and cache_pos is not None:
            o = decode_attn(q, new_kv["k"], new_kv["v"], cache_pos, kind,
                            window, ring=bool(ring))
            o = o.reshape(B, S, H * hd)
            return o.to(_mm_dtype(o, p["wo"])) @ p["wo"], new_kv
    pos = query_positions(positions)
    if use_blockwise:
        o = blockwise_attn(q, k, v, pos, pos, kind, window)
    else:
        o = dot_attn(q, k, v, _mask_bias(pos, pos, kind, window))
    return o.reshape(B, S, H * hd) @ p["wo"], new_kv


def _write_latent(cache, ckv, kr, pos):
    """Write the latent and the roped shared key into the layer's MLA
    cache in place, cast to its dtype, at ``[pos, pos + S)``; ``pos`` an
    int, or for one position a row a (B,) tensor."""
    cc, ckr = cache["ckv"], cache["kr"]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        idx = (torch.arange(ckv.shape[0], device=ckv.device),
               pos.to(device=ckv.device, dtype=torch.long))
        cc.index_put_(idx, ckv[:, 0].to(cc.dtype))
        ckr.index_put_(idx, kr[:, 0].to(ckr.dtype))
    else:
        p, S = int(pos), ckv.shape[1]
        cc[:, p:p + S] = ckv
        ckr[:, p:p + S] = kr
    return {"ckv": cc, "kr": ckr}


def mla_absorbed_decode(p, cfg, qn, qr, cache, pos):
    """One query position per row against the layer's latent cache, the
    reference's absorbed form: ``qlat = qn . w_uk`` per head, scores
    ``qlat . ckv + qr . kr`` in f32 times ``1/sqrt(dn + dr)``, keys at
    positions ``<= pos`` (an int, or a (B,) tensor per row), the softmax
    cast to the cache's dtype, the latent context ``w . ckv``, then
    ``w_uv`` and ``wo``. The cache is never expanded to per-head keys and
    values. qn (B, 1, H, dn), qr (B, 1, H, dr); returns (B, 1, d)."""
    B, _, H, dn = qn.shape
    dr, dv, r = cfg.mla_qk_rope, cfg.mla_v_dim, cfg.kv_lora_rank
    cc, ckr = cache["ckv"], cache["kr"]
    qlat = torch.einsum("bqhd,rhd->bqhr", qn, p["w_uk"].reshape(r, H, dn))
    t = _mm_dtype(qlat, cc)
    s = (torch.einsum("bqhr,bsr->bhqs", qlat.to(t), cc.to(t))
         + torch.einsum("bqhd,bsd->bhqs", qr.to(t), ckr.to(t))
         ).to(torch.float32)
    # the reference's f32 ``1.0 / jnp.sqrt(dn + dr)``
    s = s * float(np.float32(1.0) / np.sqrt(np.float32(dn + dr)))
    kpos = torch.arange(cc.shape[1], dtype=torch.int32, device=qn.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        ok = kpos[None, :] <= pos.to(device=qn.device,
                                     dtype=torch.int32)[:, None]
    else:
        ok = (kpos <= int(pos))[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=qn.device)
    s = s + torch.where(ok, zero, NEG_INF)[:, None, None, :]
    w = torch.softmax(s, dim=-1).to(cc.dtype)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, cc)              # latent context
    wuv = p["w_uv"].reshape(r, H, dv)
    t = _mm_dtype(ctx, wuv)
    o = torch.einsum("bqhr,rhd->bqhd", ctx.to(t), wuv.to(t))
    o = o.reshape(B, 1, H * dv)
    return o.to(_mm_dtype(o, p["wo"])) @ p["wo"]


def mla_forward(p, cfg, x, positions, *, cache=None, cache_pos=None,
                use_blockwise=False):
    """Multi-head latent attention over (B, S, D), the reference's
    ``mla_forward``: keys and values expanded from the RMS-normed latent
    per head, the rope part of the key shared by the heads, causal,
    scores at ``1/sqrt(dn + dr)``. Returns (out, the layer's cache or
    None).

    ``cache``: the layer's {"ckv": (B, S_max, kv_lora_rank), "kr": (B,
    S_max, qk_rope)}, the compressed KV, written in place. With S == 1
    and a ``cache_pos`` a decode step (:func:`mla_absorbed_decode`, the
    new latent written at ``cache_pos`` first); else a prefill that
    writes ``[0, S)`` and attends over the expanded keys and values as
    training does."""
    from repro_torch.models.layers import rms_norm
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, r = (cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_dim,
                     cfg.kv_lora_rank)
    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    dkv = x @ p["w_dkv"]
    ckv, kr = dkv[..., :r], dkv[..., r:]
    ckv = rms_norm(ckv, p["kv_norm"])
    qr = R.apply_rope(qr, positions, cfg.rope_theta)
    kr = R.apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    new_cache = None
    if cache is not None:
        decode = S == 1 and cache_pos is not None
        new_cache = _write_latent(cache, ckv, kr,
                                  cache_pos if decode else 0)
        if decode:
            return mla_absorbed_decode(p, cfg, qn, qr, new_cache,
                                       cache_pos), new_cache
    kn = torch.einsum("bsr,rhd->bshd", ckv, p["w_uk"].reshape(r, H, dn))
    v = torch.einsum("bsr,rhd->bshd", ckv, p["w_uv"].reshape(r, H, dv))
    k = torch.cat([kn, kr[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    qfull = torch.cat([qn, qr], dim=-1)
    pos = query_positions(positions)
    if use_blockwise:
        o = blockwise_attn(qfull, k, v, pos, pos, "causal")
    else:
        o = dot_attn(qfull, k, v, _mask_bias(pos, pos, "causal"))
    return o.reshape(B, S, H * dv) @ p["wo"], new_cache
