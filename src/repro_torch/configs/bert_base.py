"""BERT-Base, the paper's own pre-training benchmark [Devlin et al. 2018]:
12 layers, d_model=768, 12 heads, d_ff=3072, vocab=30522, a bidirectional
encoder trained with the masked-LM loss (``loss_mask`` in the batch).
Same FULL and SMOKE configs as ``src/repro/configs/bert_base.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="bert-base", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    vocab=30522, head_dim=64, causal=False,
    rope="learned", mlp_type="gelu", norm_type="layernorm",
    attn_bias=True, max_seq=4096,
    citation="arXiv:1810.04805",
)

SMOKE = ModelConfig(
    name="bert-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    head_dim=32, causal=False, rope="learned", mlp_type="gelu",
    norm_type="layernorm", attn_bias=True, max_seq=128,
    citation="arXiv:1810.04805",
)

base.register("bert-base", base.ArchSpec(config=FULL, smoke=SMOKE))
