"""whisper-large-v3 [audio encoder-decoder], arXiv:2212.04356 (Radford et
al.): 32 encoder and 32 decoder layers, d_model=1280, 20 heads (MHA:
kv=20), d_ff=5120, vocab=51866, GELU MLP, LayerNorm, learned positions,
a cross-attention block in every decoder layer. As in the reference, the
mel-spectrogram and convolutional front end are a stub: the batch's
``frames`` (B, 1500, 1280) are the encoder's input embeddings. Same FULL
and SMOKE configs as ``src/repro/configs/whisper_large_v3.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, enc_layers=32, d_model=1280, n_heads=20, n_kv=20,
    d_ff=5120, vocab=51866, head_dim=64,
    rope="learned", mlp_type="gelu", norm_type="layernorm",
    attn_bias=True, enc_frames=1500, max_seq=32768, remat=True,
    citation="arXiv:2212.04356",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=128, n_heads=4, n_kv=4,
    d_ff=256, vocab=512, head_dim=32,
    rope="learned", mlp_type="gelu", norm_type="layernorm",
    attn_bias=True, enc_frames=16, max_seq=128,
    citation="arXiv:2212.04356",
)

base.register("whisper-large-v3", base.ArchSpec(config=FULL, smoke=SMOKE))
