"""zamba2-1.2b [hybrid], arXiv:2411.15242 (Zyphra): 38 Mamba2 layers
(d_model=2048, ssm_state=64, d_inner=4096, 64 heads of dim 64) and one
shared attention + MLP block (32 heads, kv 32, d_ff 8192) applied after
every 6th layer, each application with its own KV cache slot. Same FULL
and SMOKE configs as ``src/repro/configs/zamba2_1p2b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_chunk=256, conv_kernel=4, attn_every=6,
    norm_type="rmsnorm", max_seq=524288, remat=True,
    citation="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    head_dim=32, ssm_state=16, ssm_head_dim=32, ssm_expand=2,
    ssm_chunk=8, conv_kernel=4, attn_every=2, max_seq=128,
    citation="arXiv:2411.15242",
)

base.register("zamba2-1.2b", base.ArchSpec(config=FULL, smoke=SMOKE))
