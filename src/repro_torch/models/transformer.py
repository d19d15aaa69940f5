"""Dense transformer assembly (gpt2 decoders, bert encoders), PyTorch port
of the dense path of ``src/repro/models/transformer.py``.

    model_template(cfg)                   -> PD tree (the params' source)
    forward(params, cfg, batch)           -> (logits over the padded
                                              vocab, aux)
    lm_loss(params, cfg, batch)           -> (mean NLL over the loss
                                              mask, metrics)
    init_cache(cfg, batch, max_seq)       -> zeroed KV cache
    prefill(params, cfg, batch, cache)    -> (last logits, cache)
    decode(params, cfg, tokens, cache, pos) -> (logits, cache)

At S >= ``cfg.blockwise_threshold`` attention takes the flash-style
``attention.blockwise_attn``, as in the reference. ``prefill`` and
``decode`` write the cache in place and run without autograd. The
MLA, window-cache, SSM and dense-prefix caches of the reference belong
to families the port does not run yet.

Layer weights stay stacked on a leading layers axis, as in the reference:
that keeps the leaves (19 for gpt2, 20 for bert with its untied
``lm_head``) and their comm layouts identical. The layer
loop unbinds the stack; autograd stacks the layers' gradients back.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import rope as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PD, apply_mlp, apply_norm,
                                       mlp_template, model_dim_spec,
                                       norm_template, stack_template)


def _block_template(cfg: ModelConfig, n_layers: int):
    d = cfg.d_model
    return {
        "attn_norm": stack_template(norm_template(cfg.norm_type, d),
                                    n_layers),
        "mlp_norm": stack_template(norm_template(cfg.norm_type, d),
                                   n_layers),
        "attn": A.gqa_template(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                               bias=cfg.attn_bias, stack=n_layers),
        "mlp": mlp_template(d, cfg.d_ff, cfg.mlp_type, layers_axis=n_layers),
    }


def model_template(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"only the dense family is ported yet ({cfg.name})")
    if cfg.rope != "learned":
        raise NotImplementedError("only learned positions (gpt2, bert) are "
                                  "ported yet")
    d, V = cfg.d_model, cfg.padded_vocab
    vs = model_dim_spec(V)
    t = {"embed": PD((V, d), spec=(vs, None), scale=0.02),
         "final_norm": norm_template(cfg.norm_type, d)}
    if not cfg.tie_embeddings:
        t["lm_head"] = PD((d, V), spec=(None, vs))
    t["pos_embed"] = PD((cfg.max_seq, d), scale=0.02)
    t["blocks"] = _block_template(cfg, cfg.n_layers)
    return t


def _embed(params, cfg: ModelConfig, tokens, offset=0):
    """Token embeddings plus the learned positions ``offset ..
    offset + S - 1``, ``offset`` an int or a (B,) tensor per row. The
    reference's ``dynamic_slice`` clamps a read past the table without a
    word; the port raises for an int offset (callers with per-row offsets
    check ``max_seq`` up front, as ``serve.Server`` does)."""
    h = params["embed"][tokens].to(cfg.compute_dtype)
    S = tokens.shape[1]
    pe = params["pos_embed"]
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        idx = offset.to(torch.long)[:, None] + torch.arange(
            S, device=offset.device)
        return h + pe[idx].to(h.dtype)
    offset = int(offset)
    if offset + S > pe.shape[0]:
        raise ValueError(f"positions {offset}..{offset + S - 1} run past "
                         f"the learned position table (max_seq "
                         f"{pe.shape[0]})")
    return h + pe[offset:offset + S][None].to(h.dtype)


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


def _blocks(params, cfg: ModelConfig, h, positions, cache=None,
            cache_pos=None, use_blockwise=False):
    """The decoder (or encoder) blocks, layer by layer; layer ``l`` reads
    and writes ``cache[...][l]`` in place."""
    for l, lp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        lc = None if cache is None else {k: c[l] for k, c in cache.items()}
        hn = apply_norm(lp["attn_norm"], h, cfg.norm_type)
        ao, _ = A.gqa_forward(lp["attn"], cfg, hn, positions, cache=lc,
                              cache_pos=cache_pos,
                              use_blockwise=use_blockwise)
        h = h + ao
        hm = apply_norm(lp["mlp_norm"], h, cfg.norm_type)
        h = h + apply_mlp(lp["mlp"], hm, cfg.mlp_type)
    return h


def forward(params, cfg: ModelConfig, batch):
    """Training forward: (logits (B, S, padded_vocab), aux loss)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(params, cfg, tokens)
    positions = R.text_positions(B, S, device=tokens.device)
    h = _blocks(params, cfg, h, positions,
                use_blockwise=S >= cfg.blockwise_threshold)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(params, cfg, h), aux


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed decode cache: {"k", "v"} of shape (L, B, max_seq, K, hd),
    the reference's dense layout, so caches compare leaf for leaf."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, cache):
    """Process the prompts (B, S), write their keys and values into
    ``cache[..., :S]`` in place; returns (logits of the last position (B,
    1, padded_vocab), cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed(params, cfg, tokens)
    positions = R.text_positions(B, S, device=tokens.device)
    h = _blocks(params, cfg, h, positions, cache=cache, cache_pos=0,
                use_blockwise=S >= cfg.blockwise_threshold)
    return _logits(params, cfg, h[:, -1:]), cache


@torch.no_grad()
def decode(params, cfg: ModelConfig, tokens, cache, pos):
    """One decode step: tokens (B, 1) at position ``pos`` (an int, or a
    (B,) tensor with each row's own position); writes their keys and
    values into the cache in place. Returns (logits (B, 1, padded_vocab),
    cache)."""
    B = tokens.shape[0]
    h = _embed(params, cfg, tokens, pos)
    positions = R.text_positions(B, 1, offset=pos, device=tokens.device)
    h = _blocks(params, cfg, h, positions, cache=cache, cache_pos=pos)
    return _logits(params, cfg, h), cache


def lm_loss(params, cfg: ModelConfig, batch):
    """Cross-entropy of the labels: the mean over every position, or with
    a ``loss_mask`` in the batch (masked LM) ``sum(nll * mask) /
    max(sum(mask), 1)``. ``logsumexp`` runs over the padded vocab, pad
    columns included, exactly as in the reference."""
    logits, aux = forward(params, cfg, batch)
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
    return loss, {"nll": loss, "aux": aux}
