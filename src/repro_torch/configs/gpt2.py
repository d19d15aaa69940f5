"""GPT-2 117M, the paper's own generative pre-training benchmark
[Radford 2019]; same FULL and SMOKE configs as ``src/repro/configs/gpt2.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gpt2", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    vocab=50257, head_dim=64,
    rope="learned", mlp_type="gelu", norm_type="layernorm",
    attn_bias=True, max_seq=32768, tie_embeddings=True,
    citation="Radford et al. 2019",
)

SMOKE = ModelConfig(
    name="gpt2-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    head_dim=32, rope="learned", mlp_type="gelu", norm_type="layernorm",
    attn_bias=True, max_seq=128, tie_embeddings=True,
    citation="Radford et al. 2019",
)

base.register("gpt2", base.ArchSpec(config=FULL, smoke=SMOKE))
