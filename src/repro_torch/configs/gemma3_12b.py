"""gemma3-12b [dense], hf:google/gemma-3-1b-pt family card (12B variant):
48 layers, d_model=3840, 16 heads GQA kv=8 with head_dim=256,
d_ff=15360, vocab=262144, tied embeddings, 5:1 local:global attention
(sliding window 1024; every 6th layer global), one rope_theta of 1e6 for
both (the reference's recorded simplification of the card's 10k / 1M).
Same FULL and SMOKE configs as ``src/repro/configs/gemma3_12b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, d_ff=15360,
    vocab=262144, head_dim=256,
    sliding_window=1024, global_every=6, rope_theta=1_000_000.0,
    tie_embeddings=True,
    mlp_type="swiglu", norm_type="rmsnorm", max_seq=131072, remat=True,
    citation="hf:google/gemma-3-1b-pt",
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, sliding_window=8, global_every=6, tie_embeddings=True,
    max_seq=128, citation="hf:google/gemma-3-1b-pt",
)

base.register("gemma3-12b", base.ArchSpec(config=FULL, smoke=SMOKE))
