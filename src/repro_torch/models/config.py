"""Model configuration, PyTorch port of ``src/repro/models/config.py``.

The fields of the dense family are ported: gpt2 and bert (learned
positions, gelu, layernorm) and the rotary family (granite, phi4,
chatglm3's partial rotary and QKV bias, gemma3's sliding windows and
window cache; rmsnorm, swiglu, remat); and those of the moe family:
the experts, the router's top-k and capacity, the shared experts, the
dense prefix (``first_k_dense``) and DeepSeek-V2's multi-head latent
attention (``attn_type="mla"``); and those of the state-space family:
Mamba2's SSD layer (``ssm_*``, ``conv_kernel``) and zamba2's shared
attention block (``attn_every``); and those of the vlm (qwen2-vl's
M-RoPE sections and vision prefix) and of the encoder-decoder (whisper's
encoder depth and frames). Defaults are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    rope: str = "standard"       # none | standard | partial | mrope |
                                 # learned
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # rotated pairs per t/h/w stream
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

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500

    # vlm stub (qwen2-vl): vision embeddings replace the sequence's prefix
    vision_tokens: int = 0
    vision_grid_h: int = 32

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


def cut_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut to ``n_layers`` layers, widths unchanged; a config with
    an encoder keeps ``n_layers`` encoder layers too (the port's
    ``--layers``; the reference has no such cut)."""
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        enc_layers=n_layers if cfg.enc_layers else 0)
