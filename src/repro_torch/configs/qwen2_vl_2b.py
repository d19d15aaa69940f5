"""qwen2-vl-2b [vlm], arXiv:2409.12191 (Qwen team): 28 layers,
d_model=1536, 12 heads GQA kv=2, d_ff=8960, vocab=151936, M-RoPE
(temporal/height/width bands 16+24+24 over head_dim/2 = 64), QKV bias.
As in the reference, the ViT vision tower and projector are a stub: the
batch's ``vision_embeds`` (B, vision_tokens, d) replace the sequence's
prefix, and M-RoPE gives the prefix a (t, h, w) grid. Same FULL and
SMOKE configs as ``src/repro/configs/qwen2_vl_2b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960,
    vocab=151936, head_dim=128,
    rope="mrope", mrope_sections=(16, 24, 24), attn_bias=True,
    vision_tokens=1024, vision_grid_h=32,
    mlp_type="swiglu", norm_type="rmsnorm", max_seq=32768, remat=True,
    citation="arXiv:2409.12191",
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, rope="mrope", mrope_sections=(4, 6, 6), attn_bias=True,
    vision_tokens=8, vision_grid_h=4, max_seq=128,
    citation="arXiv:2409.12191",
)

base.register("qwen2-vl-2b", base.ArchSpec(config=FULL, smoke=SMOKE))
