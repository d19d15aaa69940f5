"""Optimizer config and registry, PyTorch port of ``src/repro/core/api.py``.

Ported: the 0/1 local-step pipelines over the Adam base (``zero_one_adam``,
the paper's recipe) and the momentum-SGD base (``zero_one_sgd``), both
``compressed_dp(base, style="accumulate")``. Every other registry name of
the reference raises ``NotImplementedError`` until its slice lands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import compressor as C
from repro_torch.core import schedules as S
from repro_torch.core.base_steps import adam_base, momentum_sgd_base
from repro_torch.core.comm import Hierarchy
from repro_torch.core.compressed import CompressedDP, compressed_dp

_BASES = {
    "zero_one_adam": lambda c: adam_base(c.beta1, c.beta2, c.eps),
    "zero_one_sgd": lambda c: momentum_sgd_base(c.beta1),
}
REGISTRY_NAMES = tuple(sorted(_BASES))
_LATER = ("adam", "lamb", "momentum_sgd", "one_bit_adam", "one_bit_lamb",
          "zero_one_lamb")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "zero_one_adam"
    lr: Callable = S.ConstantLr(1e-3)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    var_policy: Any = S.AdaptiveFreezePolicy(kappa=16)
    sync_policy: Any = S.LrProportionalSyncPolicy(
        warmup_steps=12500, double_every=32768, max_interval=16)
    scale_mode: C.ScaleMode = "tensor"
    codec: Any = "sign1bit"
    comm_dtype: Any = torch.bfloat16
    hierarchy: Optional[Hierarchy] = None   # two-level (intra-pod x
                                            # inter-pod) exchange

    def __post_init__(self):
        if self.name in _LATER:
            raise NotImplementedError(
                f"optimizer {self.name!r} is not ported yet; only "
                f"{REGISTRY_NAMES} runs in this slice of the port")
        if self.name not in REGISTRY_NAMES:
            raise ValueError(f"unknown optimizer {self.name!r}; choose from "
                             f"{list(REGISTRY_NAMES)}")
        C.validate_scale_mode(self.scale_mode)


def transform_from_config(cfg: OptimizerConfig) -> CompressedDP:
    return compressed_dp(
        _BASES[cfg.name](cfg), style="accumulate",
        lr=cfg.lr, sync_policy=cfg.sync_policy, var_policy=cfg.var_policy,
        scale_mode=cfg.scale_mode, codec=cfg.codec,
        comm_dtype=cfg.comm_dtype, hierarchy=cfg.hierarchy)


def build_optimizer(cfg, param_shapes, *, specs=None, dp_mask=None,
                    n_workers: int):
    """Bind a transform, or a registry-named config, to a parameter tree
    (a nested dict of shapes)."""
    transform = (cfg if isinstance(cfg, CompressedDP)
                 else transform_from_config(cfg))
    return transform(param_shapes, specs=specs, dp_mask=dp_mask,
                     n_workers=n_workers)
