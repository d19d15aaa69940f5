"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E.

48 layers, d_model=5120, 40 heads GQA kv=8, d_ff=8192 per expert,
vocab=202048, 16 routed experts top-1 + 1 shared expert. Early fusion is
multimodal input handling — modeled text-only here per the backbone-only
carve-out. Experts are expert-parallel over the worker axes (16 experts /
16 data-parallel groups single-pod); expert leaves are dp=False for the
optimizer (no DP gradient exchange to compress — DESIGN
§Arch-applicability). long_500k skipped (full/chunked attention;
no sub-quadratic variant implemented).

Same FULL and SMOKE configs as ``src/repro/configs/llama4_scout_17b_a16e.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, head_dim=128,
    n_experts=16, top_k=1, n_shared_experts=1, moe_d_ff=8192,
    capacity_factor=1.25,
    mlp_type="swiglu", norm_type="rmsnorm", max_seq=32768, remat=True,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, n_experts=4, top_k=1, n_shared_experts=1, moe_d_ff=192,
    capacity_factor=2.0, max_seq=128,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)

base.register("llama4-scout-17b-a16e", base.ArchSpec(config=FULL, smoke=SMOKE))
