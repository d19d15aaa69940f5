"""phi4-mini-3.8b [dense], arXiv:2412.08905 (Microsoft): 32 layers,
d_model=3072, 24 heads GQA kv=8, d_ff=8192, vocab=200064, RoPE + SwiGLU +
RMSNorm, untied embeddings. Same FULL and SMOKE configs as
``src/repro/configs/phi4_mini_3p8b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
    vocab=200064, head_dim=128,
    mlp_type="swiglu", norm_type="rmsnorm", max_seq=32768, remat=True,
    citation="arXiv:2412.08905",
)

SMOKE = ModelConfig(
    name="phi4-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, max_seq=128, citation="arXiv:2412.08905",
)

base.register("phi4-mini-3.8b", base.ArchSpec(config=FULL, smoke=SMOKE))
