"""Model configuration, PyTorch port of ``src/repro/models/config.py``.

Only the fields the dense family (gpt2 decoders, bert encoders) reads are
ported; the MoE, SSM, MLA, encoder-decoder and vision options of the
reference arrive with the slices that port those families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    attn_bias: bool = False
    rope: str = "learned"        # only "learned" positions are ported
    causal: bool = True          # False = bidirectional (bert)
    mlp_type: str = "gelu"       # only the gelu MLP is ported
    norm_type: str = "layernorm"  # only layernorm is ported
    tie_embeddings: bool = False  # False: a separate lm_head leaf
    max_seq: int = 8192
    vocab_pad_multiple: int = 256
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    blockwise_threshold: int = 8192   # flash-style attention at S >= this
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m
