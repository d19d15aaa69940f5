"""granite-3-8b [dense], hf:ibm-granite/granite-3.0-2b-base family (8B):
40 layers, d_model=4096, 32 heads GQA kv=8, d_ff=12800, vocab=49155,
RoPE + SwiGLU + RMSNorm. Same FULL and SMOKE configs as
``src/repro/configs/granite_3_8b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12800,
    vocab=49155, head_dim=128,
    mlp_type="swiglu", norm_type="rmsnorm", max_seq=32768, remat=True,
    citation="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, max_seq=128, citation="hf:ibm-granite/granite-3.0-2b-base",
)

base.register("granite-3-8b", base.ArchSpec(config=FULL, smoke=SMOKE))
