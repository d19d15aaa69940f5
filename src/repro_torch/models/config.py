"""Model configuration, PyTorch port of ``src/repro/models/config.py``.

The fields of the dense family are ported: gpt2 and bert (learned
positions, gelu, layernorm) and the rotary family (granite, phi4,
chatglm3's partial rotary and QKV bias, gemma3's sliding windows and
window cache; rmsnorm, swiglu, remat); and those of the moe family:
the experts, the router's top-k and capacity, the shared experts, the
dense prefix (``first_k_dense``) and DeepSeek-V2's multi-head latent
attention (``attn_type="mla"``); and those of the state-space family:
Mamba2's SSD layer (``ssm_*``, ``conv_kernel``) and zamba2's shared
attention block (``attn_every``). Defaults are the reference's. A config
of another family (the encoder-decoder, the vlm), or with M-RoPE, is
refused by :func:`unported` (ROADMAP item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention
    attn_type: str = "gqa"       # gqa | mla
    attn_bias: bool = False
    rope: str = "standard"       # none | standard | partial | learned
                                 # (mrope not ported)
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    sliding_window: int = 0      # >0 enables local attention
    global_every: int = 0        # gemma3: every k-th layer is global
    causal: bool = True          # False = bidirectional (bert)

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    mla_qk_nope: int = 128
    mla_qk_rope: int = 64
    mla_v_dim: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    first_k_dense: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # SSM (Mamba2) / hybrid (Zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4
    attn_every: int = 0          # zamba2: shared attn block every k layers

    # serving
    window_cache: bool = False   # sliding-window layers keep only
                                 # ``window`` KV slots (a ring), global
                                 # layers a compact stack

    # misc
    mlp_type: str = "swiglu"     # swiglu | gelu
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    tie_embeddings: bool = False  # False: a separate lm_head leaf
    max_seq: int = 8192
    vocab_pad_multiple: int = 256
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    remat: bool = False          # recompute each layer in the backward
    blockwise_threshold: int = 8192   # flash-style attention at S >= this
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_global_layers(self) -> int:
        if not self.global_every:
            return 0
        return self.n_layers // self.global_every

    @property
    def n_attn_apps(self) -> int:
        """Hybrid: how many times the shared attention block fires."""
        if not self.attn_every:
            return 0
        return self.n_layers // self.attn_every


def unported(cfg: ModelConfig) -> Optional[str]:
    """What of ``cfg`` the port does not run yet, or None."""
    if cfg.rope == "mrope":
        return "M-RoPE"
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        return f"the {cfg.family} family"
    return None
