"""mamba2-2.7b [ssm], arXiv:2405.21060 (Dao & Gu, SSD): 64 layers,
d_model=2560, attention-free, vocab=50280, ssm_state=128, expand=2
(d_inner=5120, 80 heads of dim 64), conv kernel 4, chunk 256. Same FULL
and SMOKE configs as ``src/repro/configs/mamba2_2p7b.py``.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=80, n_kv=80, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=1, ssm_chunk=256, conv_kernel=4,
    norm_type="rmsnorm", max_seq=524288, remat=True,
    citation="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=8, n_kv=8, d_ff=0, vocab=512,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=8,
    conv_kernel=4, max_seq=128, citation="arXiv:2405.21060",
)

base.register("mamba2-2.7b", base.ArchSpec(config=FULL, smoke=SMOKE))
