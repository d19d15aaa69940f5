"""chatglm3-6b [dense], arXiv:2406.12793 (GLM team): 28 layers,
d_model=4096, 32 heads GQA kv=2, d_ff=13696, vocab=65024, partial rotary
(half the head dim), SwiGLU, RMSNorm, QKV bias. Same FULL and SMOKE
configs as ``src/repro/configs/chatglm3_6b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, d_ff=13696,
    vocab=65024, head_dim=128,
    rope="partial", rope_fraction=0.5, attn_bias=True,
    mlp_type="swiglu", norm_type="rmsnorm", max_seq=32768, remat=True,
    citation="arXiv:2406.12793",
)

SMOKE = ModelConfig(
    name="chatglm3-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, rope="partial", rope_fraction=0.5, attn_bias=True,
    max_seq=128, citation="arXiv:2406.12793",
)

base.register("chatglm3-6b", base.ArchSpec(config=FULL, smoke=SMOKE))
