"""BERT-Large, the paper's own pre-training benchmark [Devlin et al. 2018]:
24 layers, d_model=1024, 16 heads, d_ff=4096, vocab=30522. Same FULL and
SMOKE configs as ``src/repro/configs/bert_large.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="bert-large", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=4096,
    vocab=30522, head_dim=64, causal=False,
    rope="learned", mlp_type="gelu", norm_type="layernorm",
    attn_bias=True, max_seq=4096,
    citation="arXiv:1810.04805",
)

SMOKE = ModelConfig(
    name="bert-large-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    head_dim=32, causal=False, rope="learned", mlp_type="gelu",
    norm_type="layernorm", attn_bias=True, max_seq=128,
    citation="arXiv:1810.04805",
)

base.register("bert-large", base.ArchSpec(config=FULL, smoke=SMOKE))
