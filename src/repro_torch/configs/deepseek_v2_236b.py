"""deepseek-v2-236b [moe+MLA] — arXiv:2405.04434 (DeepSeek-AI).

60 layers, d_model=5120, 128 heads MLA with kv_lora_rank=512
(qk_nope=128, qk_rope=64, v=128), vocab=102400, 160 routed experts top-6
+ 2 shared experts (moe d_ff=1536), first layer dense (d_ff=12288).
Experts expert-parallel over the worker axes (160/16 = 10 per DP group
single-pod, 5 per group multi-pod), dp=False for the optimizer.
The MLA cache stores the 512-dim latent + 64-dim rope key — the paper's
93% KV-cache reduction — and decode uses the absorbed-matmul form.
long_500k skipped (full attention).

Same FULL and SMOKE configs as ``src/repro/configs/deepseek_v2_236b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv=128, d_ff=12288,
    vocab=102400,
    attn_type="mla", kv_lora_rank=512, mla_qk_nope=128, mla_qk_rope=64,
    mla_v_dim=128,
    n_experts=160, top_k=6, n_shared_experts=2, moe_d_ff=1536,
    first_k_dense=1, capacity_factor=1.25,
    mlp_type="swiglu", norm_type="rmsnorm", max_seq=32768, remat=True,
    citation="arXiv:2405.04434",
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    attn_type="mla", kv_lora_rank=32, mla_qk_nope=16, mla_qk_rope=8,
    mla_v_dim=16,
    n_experts=4, top_k=2, n_shared_experts=1, moe_d_ff=96,
    first_k_dense=1, capacity_factor=2.0, max_seq=128,
    citation="arXiv:2405.04434",
)

base.register("deepseek-v2-236b", base.ArchSpec(config=FULL, smoke=SMOKE))
