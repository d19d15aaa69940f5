"""Dense transformer assembly (gpt2 decoders, bert encoders), PyTorch port
of the training path of ``src/repro/models/transformer.py``.

    model_template(cfg)          -> PD tree (the single source of params)
    forward(params, cfg, batch)  -> (logits over the padded vocab, aux)
    lm_loss(params, cfg, batch)  -> (mean NLL over the loss mask, metrics)

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


def _embed(params, cfg: ModelConfig, tokens):
    h = params["embed"][tokens].to(cfg.compute_dtype)
    return h + params["pos_embed"][:tokens.shape[1]][None].to(h.dtype)


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


def forward(params, cfg: ModelConfig, batch):
    """Training forward: (logits (B, S, padded_vocab), aux loss)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S >= cfg.blockwise_threshold:
        raise NotImplementedError(
            f"S={S} >= blockwise_threshold: the reference switches to its "
            f"flash-style attention there, which is not ported yet")
    h = _embed(params, cfg, tokens)
    positions = R.text_positions(B, S, device=tokens.device)
    for lp in _layers(params["blocks"], cfg.n_layers):
        hn = apply_norm(lp["attn_norm"], h, cfg.norm_type)
        ao, _ = A.gqa_forward(lp["attn"], cfg, hn, positions)
        h = h + ao
        hm = apply_norm(lp["mlp_norm"], h, cfg.norm_type)
        h = h + apply_mlp(lp["mlp"], hm, cfg.mlp_type)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(params, cfg, h), aux


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
