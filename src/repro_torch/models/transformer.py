"""Transformer assembly, PyTorch port of ``src/repro/models/
transformer.py``: gpt2 and bert (learned positions, gelu, layernorm),
the rotary family (granite, phi4, chatglm3's partial rotary, gemma3's
5:1 sliding:global layers; rmsnorm, swiglu), the moe family
(llama4-scout; deepseek-v2 with multi-head latent attention and a dense
first layer), the state-space family (mamba2; zamba2 with its shared
attention block), the vlm (qwen2-vl: M-RoPE and the vision prefix) and
the encoder-decoder (whisper: the encoder and cross-attention).

    model_template(cfg, ep_workers)       -> PD tree (the params' source)
    forward(params, cfg, batch, comm)     -> (logits over the padded
                                              vocab, MoE aux loss)
    lm_loss(params, cfg, batch, comm)     -> (mean NLL over the loss
                                              mask + aux_loss_weight *
                                              aux, metrics)
    encode(params, cfg, frames)           -> the encoder's output
    init_cache(cfg, batch, max_seq)       -> zeroed KV cache
    prefill(params, cfg, batch, cache, comm) -> (last logits, cache)
    decode(params, cfg, tokens, cache, pos, enc_out, comm, groups)
                                          -> (logits, cache)

At S >= ``cfg.blockwise_threshold`` attention takes the flash-style
``attention.blockwise_attn``, as in the reference. With ``cfg.remat``
each layer runs under ``torch.utils.checkpoint`` (non-reentrant) when
gradients are recorded: its activations are recomputed in the backward,
bit for bit the run without it. ``prefill`` and ``decode`` write the
cache in place and run without autograd. With ``cfg.window_cache``
(gemma3) the cache is split: each sliding layer keeps a ring of
``sliding_window`` slots, the global layers a compact stack; ``decode``
runs through it as the reference's ``_decoder_scan_window_decode``, and
``prefill`` fills it too (the reference's prefill cannot take the split
cache: its layer scan refuses stacks of unequal length). MLA keeps the
compressed KV (the latent and the rope key, 576 values a token and
layer at deepseek-v2's widths) and decodes in the absorbed form;
``decode(groups=B)`` routes each row's token alone through the MoE
layers, as the reference's Scheduler does.

The vlm (qwen2-vl) takes the batch's ``vision_embeds`` (B, N, d), which
replace the first N rows of the token embeddings (so ``embed`` gets its
gradient through the text positions alone), and (3, B, S) M-RoPE
positions (:func:`repro_torch.models.rope.mrope_positions`); a decode
step has no vision input and continues the text positions.

The encoder-decoder (whisper) encodes the batch's ``frames`` (B,
enc_frames, d) plus the encoder's ``pos_embed`` through
:func:`_blocks` with the encoder's own config (bidirectional, no
rotation; each layer checkpointed under ``cfg.remat``) and its final
norm. Each decoder layer then runs a cross-attention step after its
self-attention: its ``cross.norm``, and attention whose keys and values
are ``enc_out @ cross.attn.wk / wv`` with no bias (the reference's; so
``cross.attn.bk`` and ``bv`` get a gradient of exactly zero), computed
for every layer before the layer loop. ``prefill`` takes ``enc_out``
from the batch or encodes its ``frames``; ``decode`` takes ``enc_out=``
and recomputes every layer's cross keys and values from it on each
call, as the reference does. Both families keep the dense {"k", "v"}
cache over the decoder layers.

The state-space family (mamba2; zamba2, the hybrid) runs its stacked
layers through :func:`_ssm_scan`: each layer's norm, Mamba2 block
(:mod:`repro_torch.models.ssm`) and residual, and for the hybrid one
shared attention + MLP block (``shared_attn``, one set of weights)
applied after every ``attn_every``-th layer, its n-th application
reading and writing slot n of the shared KV cache. Its cache is the
reference's: {"ssm": {"h", "conv_x", "conv_B", "conv_C"}} stacked over
the layers in f32, plus for the hybrid {"shared": {"k", "v"}} of shape
(n_attn_apps, B, max_seq, n_kv, hd); every leaf written in place.

A MoE model's ``first_k_dense`` layers are a stack of their own
(``dense_blocks``) run before ``blocks``, whose MLP is a
:func:`~repro_torch.models.moe.moe_forward` layer; its aux losses are
summed over the layers. ``comm`` is the expert-parallel comm of a
process (see :mod:`repro_torch.models.moe`), None elsewhere.

Layer weights stay stacked on a leading layers axis, as in the reference:
that keeps the leaves and their comm layouts identical. The layer loop
unbinds the stack; autograd stacks the layers' gradients back.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rope as R
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PD, apply_mlp, apply_norm,
                                       mlp_template, model_dim_spec,
                                       norm_template, stack_template)


def _block_template(cfg: ModelConfig, n_layers: int, moe: bool = False,
                    ep_workers: int = 1):
    """One stacked run of decoder blocks."""
    d = cfg.d_model
    t = {"attn_norm": stack_template(norm_template(cfg.norm_type, d),
                                     n_layers),
         "mlp_norm": stack_template(norm_template(cfg.norm_type, d),
                                    n_layers)}
    if cfg.attn_type == "mla":
        t["attn"] = A.mla_template(d, cfg.n_heads, cfg.kv_lora_rank,
                                   cfg.mla_qk_nope, cfg.mla_qk_rope,
                                   cfg.mla_v_dim, stack=n_layers)
    else:
        t["attn"] = A.gqa_template(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                   bias=cfg.attn_bias, stack=n_layers)
    if moe:
        t["moe"] = MOE.moe_template(d, cfg.moe_d_ff or cfg.d_ff,
                                    cfg.n_experts, cfg.n_shared_experts,
                                    ep_workers, stack=n_layers)
    else:
        t["mlp"] = mlp_template(d, cfg.d_ff, cfg.mlp_type,
                                layers_axis=n_layers)
    return t


def _ssm_block_template(cfg: ModelConfig, n_layers: int):
    return {"norm": stack_template(norm_template(cfg.norm_type,
                                                 cfg.d_model), n_layers),
            "ssm": SSM.ssm_template(cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                                    cfg.ssm_head_dim, cfg.ssm_state,
                                    cfg.ssm_groups, cfg.conv_kernel,
                                    stack=n_layers)}


def model_template(cfg: ModelConfig, ep_workers: int = 1):
    """The parameter template; ``ep_workers``: the expert-parallel degree
    (expert leaves are ``dp=False`` above 1)."""
    d, V = cfg.d_model, cfg.padded_vocab
    vs = model_dim_spec(V)
    t = {"embed": PD((V, d), spec=(vs, None), scale=0.02),
         "final_norm": norm_template(cfg.norm_type, d)}
    if not cfg.tie_embeddings:
        t["lm_head"] = PD((d, V), spec=(None, vs))
    if cfg.rope == "learned":
        t["pos_embed"] = PD((cfg.max_seq, d), scale=0.02)
    if cfg.family in ("ssm", "hybrid"):
        t["blocks"] = _ssm_block_template(cfg, cfg.n_layers)
        if cfg.attn_every:
            t["shared_attn"] = {
                "norm": norm_template(cfg.norm_type, d),
                "attn": A.gqa_template(d, cfg.n_heads, cfg.n_kv, cfg.hd),
                "mlp_norm": norm_template(cfg.norm_type, d),
                "mlp": mlp_template(d, cfg.d_ff, cfg.mlp_type),
            }
        return t
    if cfg.first_k_dense:
        t["dense_blocks"] = _block_template(cfg, cfg.first_k_dense)
    t["blocks"] = _block_template(cfg, cfg.n_layers - cfg.first_k_dense,
                                  moe=cfg.n_experts > 0,
                                  ep_workers=ep_workers)
    if cfg.enc_layers:
        # whisper: the encoder, and a cross-attention block per decoder
        # layer
        t["encoder"] = {
            "blocks": _block_template(
                dataclasses.replace(cfg, n_experts=0), cfg.enc_layers),
            "pos_embed": PD((cfg.enc_frames, d), scale=0.02),
            "final_norm": norm_template(cfg.norm_type, d)}
        t["cross"] = {
            "norm": stack_template(norm_template(cfg.norm_type, d),
                                   cfg.n_layers),
            "attn": A.gqa_template(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                   bias=cfg.attn_bias, stack=cfg.n_layers)}
    return t


def _positions(cfg: ModelConfig, B: int, S: int, offset=0, device=None):
    """(B, S) text positions, or (3, B, S) M-RoPE positions for the vlm;
    ``offset`` an int or a (B,) tensor per row."""
    if cfg.rope == "mrope":
        return R.mrope_positions(B, S, cfg.vision_tokens, cfg.vision_grid_h,
                                 offset, device)
    return R.text_positions(B, S, offset, device)


def _embed(params, cfg: ModelConfig, tokens, offset=0, vision_embeds=None):
    """Token embeddings plus, for learned positions, the positions
    ``offset .. offset + S - 1``, ``offset`` an int or a (B,) tensor per
    row. The reference's ``dynamic_slice`` clamps a read past the table
    without a word; the port raises for an int offset (callers with
    per-row offsets check ``max_seq`` up front, as ``serve.Server``
    does). For the vlm, ``vision_embeds`` (B, N, d) replace the first N
    rows."""
    h = params["embed"][tokens].to(cfg.compute_dtype)
    if cfg.rope == "learned":
        S = tokens.shape[1]
        pe = params["pos_embed"]
        if isinstance(offset, torch.Tensor) and offset.dim() == 1:
            idx = offset.to(torch.long)[:, None] + torch.arange(
                S, device=offset.device)
            h = h + pe[idx].to(h.dtype)
        else:
            offset = int(offset)
            if offset + S > pe.shape[0]:
                raise ValueError(
                    f"positions {offset}..{offset + S - 1} run past the "
                    f"learned position table (max_seq {pe.shape[0]})")
            h = h + pe[offset:offset + S][None].to(h.dtype)
    if vision_embeds is not None and cfg.vision_tokens:
        n = vision_embeds.shape[1]
        if n > h.shape[1]:
            raise ValueError(f"{n} vision embeddings do not fit a sequence "
                             f"of {h.shape[1]}")
        h = torch.cat([vision_embeds.to(h.dtype), h[:, n:]], dim=1)
    return h


def _logits(params, cfg: ModelConfig, h):
    h = apply_norm(params["final_norm"], h, cfg.norm_type)
    if cfg.tie_embeddings:
        return h @ params["embed"].T.to(h.dtype)
    return h @ params["lm_head"].to(h.dtype)


def _layers(blocks, n: int):
    """Stacked block tree -> one tree per layer. ``unbind`` makes the
    backward one stack of the per-layer gradients per leaf."""
    out = [{} for _ in range(n)]
    for k, v in blocks.items():
        parts = _layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for l in range(n):
            out[l][k] = parts[l]
    return out


def _layer_flags(cfg: ModelConfig):
    """Each layer's attention: 1 sliding, 0 global (the model's own causal
    or bidirectional kind). gemma3: every ``global_every``-th layer
    global, the rest sliding; a window alone makes every layer sliding.
    (The layers of ``blocks``; a dense prefix is global.)"""
    L = cfg.n_layers - cfg.first_k_dense
    if cfg.sliding_window and cfg.global_every:
        return [0 if (i + 1) % cfg.global_every == 0 else 1
                for i in range(L)]
    return [1 if cfg.sliding_window else 0] * L


def _layer(lp, cfg: ModelConfig, h, positions, kind, window, cache=None,
           cache_pos=None, use_blockwise=False, comm=None, cross_kv=None,
           groups=1):
    """One pre-norm block: attention of ``kind`` (or MLA); with
    ``cross_kv`` (this layer's cross keys and values) the cross-attention
    step over ``lp["cross_norm"]`` / ``lp["cross_attn"]``; then the MLP or
    the MoE layer (its tokens routed in ``groups`` groups of rows).
    Returns (h, the MoE layer's metrics or None)."""
    hn = apply_norm(lp["attn_norm"], h, cfg.norm_type)
    if cfg.attn_type == "mla":
        ao, _ = A.mla_forward(lp["attn"], cfg, hn, positions, cache=cache,
                              cache_pos=cache_pos,
                              use_blockwise=use_blockwise)
    else:
        ao, _ = A.gqa_forward(lp["attn"], cfg, hn, positions, kind=kind,
                              window=window, cache=cache,
                              cache_pos=cache_pos,
                              use_blockwise=use_blockwise)
    h = h + ao
    if cross_kv is not None:
        cn = apply_norm(lp["cross_norm"], h, cfg.norm_type)
        co, _ = A.gqa_forward(lp["cross_attn"], cfg, cn, positions,
                              kind="bidir", kv_override=cross_kv)
        h = h + co
    hm = apply_norm(lp["mlp_norm"], h, cfg.norm_type)
    if "moe" in lp:
        mo, met = MOE.moe_forward(lp["moe"], hm, top_k=cfg.top_k,
                                  n_experts=cfg.n_experts,
                                  capacity_factor=cfg.capacity_factor,
                                  comm=comm, groups=groups)
        return h + mo, met
    return h + apply_mlp(lp["mlp"], hm, cfg.mlp_type), None


def _layer_caches(cfg: ModelConfig, cache):
    """Each layer's slice of ``cache`` (views, written in place), in
    layer order: of the dense or MLA stack by the global layer number (a
    dense prefix takes the first ``first_k_dense`` slots, as the
    reference splits the stack and concatenates it back), or with the
    split window cache a sliding layer's ring and a global layer's slot
    of the compact stack."""
    if cache is None:
        return [None] * cfg.n_layers
    if "local" not in cache:
        return [{k: c[l] for k, c in cache.items()}
                for l in range(cfg.n_layers)]
    out, g = [], 0
    for l, flag in enumerate(_layer_flags(cfg)):
        part, i = ("local", l) if flag else ("global", g)
        g += 1 - flag
        out.append({k: c[i] for k, c in cache[part].items()})
    return out


def _cross_kv(params, cfg: ModelConfig, enc_out):
    """Each decoder layer's cross-attention keys and values, (B, S_enc, K,
    hd) each, from ``enc_out`` by ``cross.attn.wk`` / ``wv`` (no bias), as
    the reference computes them for every layer before its layer scan;
    None for a model without an encoder or without ``enc_out``."""
    if enc_out is None or "cross" not in params:
        return None
    B, Se, _ = enc_out.shape
    attn = params["cross"]["attn"]
    return [((enc_out @ wk).reshape(B, Se, cfg.n_kv, cfg.hd),
             (enc_out @ wv).reshape(B, Se, cfg.n_kv, cfg.hd))
            for wk, wv in zip(attn["wk"].unbind(0), attn["wv"].unbind(0))]


def _blocks(params, cfg: ModelConfig, h, positions, cache=None,
            cache_pos=None, use_blockwise=False, comm=None, moe_stats=None,
            enc_out=None, groups=1):
    """The decoder (or encoder) blocks, layer by layer: the dense prefix,
    then ``blocks``; layer ``l`` reads and writes its cache in place
    (:func:`_layer_caches`). With ``enc_out`` (whisper) each layer of
    ``blocks`` runs its cross-attention step (:func:`_cross_kv`). Under
    ``cfg.remat``, with gradients recorded, each layer is checkpointed.
    Returns (h, the summed MoE aux loss); each MoE layer's metrics are
    appended to ``moe_stats``, its tokens routed in ``groups`` groups of
    rows (:func:`~repro_torch.models.moe.moe_forward`)."""
    base = "causal" if cfg.causal else "bidir"
    remat = cfg.remat and torch.is_grad_enabled()
    caches = _layer_caches(cfg, cache)
    n_main = cfg.n_layers - cfg.first_k_dense
    main = _layers(params["blocks"], n_main)
    cross_kv = _cross_kv(params, cfg, enc_out)
    if cross_kv is not None:
        cross = _layers(params["cross"], n_main)
        for lp, cp in zip(main, cross):
            lp["cross_norm"], lp["cross_attn"] = cp["norm"], cp["attn"]
    runs = []
    if cfg.first_k_dense:
        runs.append((_layers(params["dense_blocks"], cfg.first_k_dense),
                     [0] * cfg.first_k_dense, [None] * cfg.first_k_dense))
    runs.append((main, _layer_flags(cfg), cross_kv or [None] * n_main))
    auxes, l = [], 0
    for layers, flags, ckvs in runs:
        for lp, flag, ckv in zip(layers, flags, ckvs):
            kind, window = (("sliding", cfg.sliding_window) if flag
                            else (base, 0))
            if remat:
                h, met = checkpoint(_layer, lp, cfg, h, positions, kind,
                                    window, None, None, use_blockwise, comm,
                                    ckv, use_reentrant=False)
            else:
                h, met = _layer(lp, cfg, h, positions, kind, window,
                                caches[l], cache_pos, use_blockwise, comm,
                                ckv, groups)
            if met is not None:
                auxes.append(met["aux_loss"])
                if moe_stats is not None:
                    moe_stats.append(met)
            l += 1
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=h.device))
    return h, aux


def _ssm_layer(lp, shared, cfg: ModelConfig, h, positions, with_attn,
               state=None, decode=False, slot=None, cache_pos=None,
               use_blockwise=False):
    """One layer of the state-space family: norm, Mamba2 block, residual;
    then, where ``with_attn``, the shared attention + MLP block over its
    KV slot ``slot`` (None in training). ``state`` (the layer's SSM
    state) and ``slot`` are written in place."""
    so, _ = SSM.ssm_forward(lp["ssm"], cfg,
                            apply_norm(lp["norm"], h, cfg.norm_type),
                            state=state, decode=decode)
    h = h + so
    if with_attn:
        an = apply_norm(shared["norm"], h, cfg.norm_type)
        ao, _ = A.gqa_forward(shared["attn"], cfg, an, positions,
                              kind="causal", cache=slot, cache_pos=cache_pos,
                              use_blockwise=use_blockwise)
        h = h + ao
        mn = apply_norm(shared["mlp_norm"], h, cfg.norm_type)
        h = h + apply_mlp(shared["mlp"], mn, cfg.mlp_type)
    return h


def _ssm_scan(params, cfg: ModelConfig, h, positions, cache=None,
              cache_pos=None, decode=False, use_blockwise=False):
    """The state-space family's layers, as the reference's ``_ssm_scan``:
    layer ``l`` reads and writes its slice of ``cache["ssm"]``; the
    shared block fires after every ``attn_every``-th layer, its n-th
    application on slot n of ``cache["shared"]``. Under ``cfg.remat``,
    with gradients recorded, each layer (the shared block included) is
    checkpointed."""
    remat = cfg.remat and torch.is_grad_enabled()
    shared = params.get("shared_attn")
    app = 0
    for l, lp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        with_attn = bool(shared is not None and cfg.attn_every
                         and (l + 1) % cfg.attn_every == 0)
        state = slot = None
        if cache is not None:
            state = {k: c[l] for k, c in cache["ssm"].items()}
            if with_attn:
                slot = {k: c[app] for k, c in cache["shared"].items()}
        if remat:
            h = checkpoint(_ssm_layer, lp, shared, cfg, h, positions,
                           with_attn, None, False, None, None,
                           use_blockwise, use_reentrant=False)
        else:
            h = _ssm_layer(lp, shared, cfg, h, positions, with_attn, state,
                           decode, slot, cache_pos, use_blockwise)
        app += with_attn
    return h


def encode(params, cfg: ModelConfig, frames):
    """Whisper's encoder over the stub frame embeddings (B, enc_frames,
    d): plus the encoder's position table, its blocks bidirectional and
    unrotated (each checkpointed under ``cfg.remat``), its final norm."""
    enc = params["encoder"]
    h = (frames.to(cfg.compute_dtype)
         + enc["pos_embed"][None].to(cfg.compute_dtype))
    ecfg = dataclasses.replace(cfg, causal=False, rope="none", n_experts=0,
                               first_k_dense=0, sliding_window=0,
                               n_layers=cfg.enc_layers)
    B, S, _ = h.shape
    h, _ = _blocks(enc, ecfg, h, R.text_positions(B, S, device=h.device))
    return apply_norm(enc["final_norm"], h, cfg.norm_type)


def forward(params, cfg: ModelConfig, batch, comm=None, moe_stats=None):
    """Training forward: (logits (B, S, padded_vocab), the summed MoE aux
    loss, 0 for a dense model). The vlm reads the batch's
    ``vision_embeds``, the encoder-decoder its ``frames``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(params, cfg, tokens, 0, batch.get("vision_embeds"))
    positions = _positions(cfg, B, S, device=tokens.device)
    use_bw = S >= cfg.blockwise_threshold
    if cfg.family in ("ssm", "hybrid"):
        h = _ssm_scan(params, cfg, h, positions, use_blockwise=use_bw)
        return _logits(params, cfg, h), torch.zeros(
            (), dtype=torch.float32, device=h.device)
    enc_out = encode(params, cfg, batch["frames"]) if cfg.enc_layers else None
    h, aux = _blocks(params, cfg, h, positions, use_blockwise=use_bw,
                     comm=comm, moe_stats=moe_stats, enc_out=enc_out)
    return _logits(params, cfg, h), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed decode cache: {"k", "v"} of shape (L, B, max_seq, K, hd),
    the reference's dense layout, so caches compare leaf for leaf. With
    ``cfg.window_cache`` (a sliding window and global layers) the
    reference's split cache: {"local": {"k", "v"} (L, B, window, K, hd),
    "global": {"k", "v"} (G, B, max_seq, K, hd)}; only the sliding
    layers' rings of "local" are used, as in the reference. The
    state-space family: {"ssm": each layer's state stacked, in f32 (not
    ``dtype``)}, and for the hybrid {"shared": {"k", "v"} (n_attn_apps,
    B, max_seq, K, hd)}. Multi-head latent attention: the compressed KV,
    {"ckv": (L, B, max_seq, kv_lora_rank), "kr": (L, B, max_seq,
    qk_rope)}; a dense prefix takes the first slots of either stack."""
    if cfg.family in ("ssm", "hybrid"):
        one = SSM.init_ssm_state(cfg, batch, torch.float32, device)
        cache = {"ssm": {k: torch.zeros((cfg.n_layers, *x.shape),
                                        dtype=x.dtype, device=device)
                         for k, x in one.items()}}
        if cfg.attn_every:
            cache["shared"] = {
                k: torch.zeros((cfg.n_attn_apps, batch, max_seq, cfg.n_kv,
                                cfg.hd), dtype=dtype, device=device)
                for k in ("k", "v")}
        return cache
    if cfg.attn_type == "mla":
        return {k: torch.zeros((cfg.n_layers, batch, max_seq, w),
                               dtype=dtype, device=device)
                for k, w in (("ckv", cfg.kv_lora_rank),
                             ("kr", cfg.mla_qk_rope))}

    def kv(*shape):
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    K, hd = cfg.n_kv, cfg.hd
    if cfg.window_cache and cfg.sliding_window and cfg.global_every:
        return {"local": kv(cfg.n_layers, batch, cfg.sliding_window, K, hd),
                "global": kv(cfg.n_global_layers, batch, max_seq, K, hd)}
    return kv(cfg.n_layers, batch, max_seq, K, hd)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, cache, comm=None):
    """Process the prompts (B, S), write their keys and values into
    ``cache[..., :S]`` in place (a ring keeps the last ``window``; MLA
    its latent and rope key; the state-space family: each layer's final
    state, from the cached ``h``, and its last conv inputs); returns
    (logits of the last position (B, 1, padded_vocab), cache). The vlm
    reads the batch's ``vision_embeds`` if it has them; the
    encoder-decoder its ``enc_out``, or else encodes its ``frames``.
    ``comm``: a process's expert-parallel comm (see ``forward``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(params, cfg, tokens, 0, batch.get("vision_embeds"))
    positions = _positions(cfg, B, S, device=tokens.device)
    use_bw = S >= cfg.blockwise_threshold
    if cfg.family in ("ssm", "hybrid"):
        h = _ssm_scan(params, cfg, h, positions, cache=cache, cache_pos=0,
                      use_blockwise=use_bw)
    else:
        enc_out = batch.get("enc_out")
        if cfg.enc_layers and enc_out is None:
            enc_out = encode(params, cfg, batch["frames"])
        h, _ = _blocks(params, cfg, h, positions, cache=cache, cache_pos=0,
                       use_blockwise=use_bw, comm=comm, enc_out=enc_out)
    return _logits(params, cfg, h[:, -1:]), cache


@torch.no_grad()
def decode(params, cfg: ModelConfig, tokens, cache, pos, enc_out=None,
           comm=None, groups=1, moe_stats=None):
    """One decode step: tokens (B, 1) at position ``pos`` (an int, or a
    (B,) tensor with each row's own position); writes their keys and
    values (MLA: its latent, then the absorbed decode) into the cache in
    place. ``enc_out``: the encoder-decoder's encoder output (B, S_enc,
    d), from which every layer's cross keys and values are computed
    again. ``comm``: a process's expert-parallel comm; ``groups``: the
    MoE layers route the rows in that many groups (``groups=B``: each row
    alone, as the reference's Scheduler decodes each slot inside its
    ``vmap``; 1: over the whole batch, as its ``decode``); ``moe_stats``
    collects each MoE layer's metrics. Returns (logits (B, 1,
    padded_vocab), cache)."""
    B = tokens.shape[0]
    h = _embed(params, cfg, tokens, pos)
    positions = _positions(cfg, B, 1, offset=pos, device=tokens.device)
    if cfg.family in ("ssm", "hybrid"):
        h = _ssm_scan(params, cfg, h, positions, cache=cache, cache_pos=pos,
                      decode=True)
    else:
        h, _ = _blocks(params, cfg, h, positions, cache=cache, cache_pos=pos,
                       comm=comm, moe_stats=moe_stats, enc_out=enc_out,
                       groups=groups)
    return _logits(params, cfg, h), cache


def lm_loss(params, cfg: ModelConfig, batch, comm=None, moe_stats=None):
    """Cross-entropy of the labels: the mean over every position, or with
    a ``loss_mask`` in the batch (masked LM) ``sum(nll * mask) /
    max(sum(mask), 1)``, plus ``cfg.aux_loss_weight`` times the MoE aux
    loss for a MoE model. ``logsumexp`` runs over the padded vocab, pad
    columns included, exactly as in the reference."""
    logits, aux = forward(params, cfg, batch, comm=comm,
                          moe_stats=moe_stats)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.to(torch.float32)
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    total = loss + cfg.aux_loss_weight * aux if cfg.n_experts else loss
    return total, {"nll": loss, "aux": aux}
