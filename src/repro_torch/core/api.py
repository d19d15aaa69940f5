"""Optimizer config and registry, PyTorch port of ``src/repro/core/api.py``.

Ported, over the Adam base and the momentum-SGD base: the 0/1 local-step
pipelines ``zero_one_adam`` (the paper's recipe) and ``zero_one_sgd``
(``style="accumulate"``), the uncompressed baselines ``adam`` and
``momentum_sgd`` (``style="mean"``), and 1-bit Adam, ``one_bit_adam``
(``style="gradient"`` with a full-precision stage of ``onebit_warmup``
steps). The LAMB names raise ``NotImplementedError`` until their slice
lands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import compressor as C
from repro_torch.core import schedules as S
from repro_torch.core.base_steps import adam_base, momentum_sgd_base
from repro_torch.core.bucketing import PACK_ORDERS
from repro_torch.core.comm import Hierarchy
from repro_torch.core.compressed import CompressedDP, compressed_dp

_LATER = ("lamb", "one_bit_lamb", "zero_one_lamb")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "zero_one_adam"
    lr: Callable = S.ConstantLr(1e-3)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    var_policy: Any = S.AdaptiveFreezePolicy(kappa=16)
    sync_policy: Any = S.LrProportionalSyncPolicy(
        warmup_steps=12500, double_every=32768, max_interval=16)
    onebit_warmup: int = 16000              # 1-bit Adam's full-precision
                                            # stage, in steps
    scale_mode: C.ScaleMode = "tensor"
    codec: Any = "sign1bit"
    comm_dtype: Any = torch.bfloat16
    hierarchy: Optional[Hierarchy] = None   # two-level (intra-pod x
                                            # inter-pod) exchange
    bucket_mb: Optional[float] = None       # fuse the per-leaf exchange
                                            # into buckets of this many
                                            # MiB of f32 elements
                                            # (core.bucketing); None: per
                                            # leaf
    pack_order: str = "flat"                # exchange-unit packing/issue
                                            # order (bucketing.PACK_ORDERS)

    def __post_init__(self):
        if self.bucket_mb is not None and self.bucket_mb <= 0:
            raise ValueError(
                f"bucket_mb must be positive (MiB per fused bucket), got "
                f"{self.bucket_mb!r}")
        if self.pack_order not in PACK_ORDERS:
            raise ValueError(
                f"pack_order must be one of {PACK_ORDERS}, got "
                f"{self.pack_order!r}")
        if self.name in _LATER:
            raise NotImplementedError(
                f"optimizer {self.name!r} is not ported yet; only "
                f"{REGISTRY_NAMES} runs in this slice of the port")
        if self.name not in REGISTRY_NAMES:
            raise ValueError(f"unknown optimizer {self.name!r}; choose from "
                             f"{list(REGISTRY_NAMES)}")
        C.validate_scale_mode(self.scale_mode)


def _shared_kwargs(cfg: OptimizerConfig) -> Dict[str, Any]:
    return dict(lr=cfg.lr, weight_decay=cfg.weight_decay,
                scale_mode=cfg.scale_mode, codec=cfg.codec,
                comm_dtype=cfg.comm_dtype, hierarchy=cfg.hierarchy,
                bucket_mb=cfg.bucket_mb, pack_order=cfg.pack_order)


def _adam(cfg):
    return adam_base(cfg.beta1, cfg.beta2, cfg.eps)


def _sgd(cfg):
    return momentum_sgd_base(cfg.beta1)


def _zero_one(base_fn):
    def build(cfg):
        return compressed_dp(base_fn(cfg), style="accumulate",
                             sync_policy=cfg.sync_policy,
                             var_policy=cfg.var_policy,
                             **_shared_kwargs(cfg))
    return build


def _one_bit(base_fn):
    def build(cfg):
        return compressed_dp(base_fn(cfg), style="gradient",
                             var_policy=S.FixedWarmupPolicy(
                                 cfg.onebit_warmup),
                             **_shared_kwargs(cfg))
    return build


def _mean(base_fn):
    def build(cfg):
        return compressed_dp(base_fn(cfg), style="mean",
                             **_shared_kwargs(cfg))
    return build


_BUILDERS: Dict[str, Callable[[OptimizerConfig], CompressedDP]] = {
    # uncompressed DP baselines (full-precision mean every step)
    "adam": _mean(_adam),
    "momentum_sgd": _mean(_sgd),
    # 1-bit two-stage (full-precision warmup, then EF-compressed gradients)
    "one_bit_adam": _one_bit(_adam),
    # 0/1 local-step pipelines (paper Algorithm 1 over each base)
    "zero_one_adam": _zero_one(_adam),
    "zero_one_sgd": _zero_one(_sgd),
}
REGISTRY_NAMES = tuple(sorted(_BUILDERS))


def transform_from_config(cfg: OptimizerConfig) -> CompressedDP:
    """Resolve a registry name to its unbound composed transform."""
    return _BUILDERS[cfg.name](cfg)


def build_optimizer(cfg, param_shapes, *, specs=None, dp_mask=None,
                    n_workers: int):
    """Bind a transform, or a registry-named config, to a parameter tree
    (a nested dict of shapes)."""
    transform = (cfg if isinstance(cfg, CompressedDP)
                 else transform_from_config(cfg))
    return transform(param_shapes, specs=specs, dp_mask=dp_mask,
                     n_workers=n_workers)
