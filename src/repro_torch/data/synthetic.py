"""Deterministic synthetic LM stream, PyTorch port of
``src/repro/data/synthetic.py``.

A latent bigram process: each token moves to one of 4 fixed successors
(the same numpy ``_bigram_table`` as the reference), with 10% uniform
noise. ``kind="lm"`` gives next-token batches; ``kind="mlm"`` masked-LM
batches: labels are the input tokens, a ``mlm_mask_frac`` share of them
is replaced by 0 ([MASK]) and ``loss_mask`` marks those positions. Draws
come from a ``torch.Generator`` seeded by (seed, step), so the stream is a
pure function of both, but its bits differ from the reference's threefry
draws; parity tests feed the reference's batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    kind: str = "lm"             # lm | mlm
    mlm_mask_frac: float = 0.15

    def __post_init__(self):
        if self.kind not in ("lm", "mlm"):
            raise NotImplementedError(f"data kind {self.kind!r} is not "
                                      f"ported yet (lm, mlm)")


def _bigram_table(vocab: int, seed: int) -> np.ndarray:
    """Random bigram transition targets: tok -> 4 candidates."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, size=(vocab, 4)).astype(np.int32)


class SyntheticLM:
    """Latent bigram LM stream; ~2 bits of predictable structure/token."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = device
        self.table = torch.from_numpy(
            _bigram_table(cfg.vocab, cfg.seed)).long()

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
        g = torch.Generator().manual_seed(cfg.seed * 1_000_003 + step)
        first = torch.randint(0, V, (B,), generator=g)
        choice = torch.randint(0, 4, (B, S), generator=g)
        noise = torch.rand((B, S), generator=g) < 0.1
        nz = torch.randint(0, V, (B, S), generator=g)
        toks = torch.empty((B, S), dtype=torch.long)
        tok = first
        for s in range(S):
            tok = torch.where(noise[:, s], nz[:, s],
                              self.table[tok, choice[:, s]])
            toks[:, s] = tok
        tokens = torch.cat([first[:, None], toks[:, :-1]], dim=1)
        out = {"tokens": tokens, "labels": toks}
        if cfg.kind == "mlm":
            mask = torch.rand((B, S), generator=g) < cfg.mlm_mask_frac
            out = {"tokens": torch.where(mask, 0, tokens), "labels": tokens,
                   "loss_mask": mask.to(torch.float32)}
        return {k: v.to(self.device) for k, v in out.items()}


def add_model_inputs(batch, model_cfg, device=None):
    """Add to ``batch`` (B rows of S tokens) the inputs beside the tokens
    that the reference's CLI, FleetSim and audit feed every batch: zero
    ``frames`` (B, enc_frames, d) for an encoder-decoder, zero
    ``vision_embeds`` (B, vision_tokens, d) for the vlm, and for a
    bidirectional model without a ``loss_mask`` one of ones (next-token
    batches with every position in the loss). Returns ``batch``."""
    B, S = batch["tokens"].shape
    d = model_cfg.d_model
    if model_cfg.enc_layers:
        batch["frames"] = torch.zeros((B, model_cfg.enc_frames, d),
                                      device=device)
    if model_cfg.vision_tokens:
        batch["vision_embeds"] = torch.zeros(
            (B, model_cfg.vision_tokens, d), device=device)
    if not model_cfg.causal and "loss_mask" not in batch:
        batch["loss_mask"] = torch.ones((B, S), device=device)
    return batch
