"""Optimizer config and registry, PyTorch port of ``src/repro/core/api.py``.

Every registry entry of the reference, over the Adam, LAMB and
momentum-SGD bases: the 0/1 local-step pipelines ``zero_one_adam`` (the
paper's recipe), ``zero_one_lamb`` and ``zero_one_sgd``
(``style="accumulate"``), the uncompressed baselines ``adam``, ``lamb``
and ``momentum_sgd`` (``style="mean"``), and 1-bit Adam and 1-bit LAMB,
``one_bit_adam`` and ``one_bit_lamb`` (``style="gradient"`` with a
full-precision stage of ``onebit_warmup`` steps). ``make_optimizer`` is
the reference's deprecation shim for the legacy names.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import compressor as C
from repro_torch.core import schedules as S
from repro_torch.core.base_steps import adam_base, lamb_base, momentum_sgd_base
from repro_torch.core.bucketing import PACK_ORDERS
from repro_torch.core.comm import Hierarchy
from repro_torch.core.compressed import CompressedDP, compressed_dp


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
    quantize: bool = True                   # deprecated: False -> the
                                            # identity codec (warns when the
                                            # optimizer is built)
    codec: Any = "sign1bit"                 # a codecs.CODEC_NAMES entry or
                                            # a Codec instance
    codec_arg: Optional[float] = None       # argument of a parameterized
                                            # codec (topk: density, default
                                            # 0.01)
    store_anchor: bool = True               # True: keep x_{t'}, bitwise
                                            # consensus at syncs; False:
                                            # recover the anchor from u
                                            # (one params copy less)
    comm_dtype: Any = torch.bfloat16
    state_dtype: Any = torch.float32        # m, v, u and the EF state
                                            # (bf16 in production; scalar
                                            # slots stay f32)
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
        if self.name not in REGISTRY_NAMES:
            raise ValueError(f"unknown optimizer {self.name!r}; choose from "
                             f"{list(REGISTRY_NAMES)}")
        C.validate_scale_mode(self.scale_mode)
        from repro_torch.core.codecs import make_codec
        make_codec(self.codec, self.codec_arg)   # validates name and arg


def _shared_kwargs(cfg: OptimizerConfig) -> Dict[str, Any]:
    return dict(lr=cfg.lr, weight_decay=cfg.weight_decay,
                scale_mode=cfg.scale_mode, quantize=cfg.quantize,
                codec=cfg.codec, codec_arg=cfg.codec_arg,
                store_anchor=cfg.store_anchor, comm_dtype=cfg.comm_dtype,
                state_dtype=cfg.state_dtype, hierarchy=cfg.hierarchy,
                bucket_mb=cfg.bucket_mb, pack_order=cfg.pack_order)


def _adam(cfg):
    return adam_base(cfg.beta1, cfg.beta2, cfg.eps)


def _lamb(cfg):
    return lamb_base(cfg.beta1, cfg.beta2, cfg.eps)


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
    "lamb": _mean(_lamb),
    "momentum_sgd": _mean(_sgd),
    # 1-bit two-stage (full-precision warmup, then EF-compressed gradients)
    "one_bit_adam": _one_bit(_adam),
    "one_bit_lamb": _one_bit(_lamb),
    # 0/1 local-step pipelines (paper Algorithm 1 over each base)
    "zero_one_adam": _zero_one(_adam),
    "zero_one_lamb": _zero_one(_lamb),
    "zero_one_sgd": _zero_one(_sgd),
}
REGISTRY_NAMES = tuple(sorted(_BUILDERS))

# names predating the composable API; make_optimizer warns on these
LEGACY_NAMES = ("adam", "one_bit_adam", "zero_one_adam")

_LEGACY_SPELLING = {
    "adam": 'compressed_dp(adam_base(...), style="mean", ...)',
    "one_bit_adam": ('compressed_dp(adam_base(...), style="gradient", '
                     'var_policy=FixedWarmupPolicy(T0), ...)'),
    "zero_one_adam": 'compressed_dp(adam_base(...), ...)',
}


def transform_from_config(cfg: OptimizerConfig) -> CompressedDP:
    """Resolve a registry name to its unbound composed transform."""
    return _BUILDERS[cfg.name](cfg)


def build_optimizer(cfg, param_shapes, *, specs=None, dp_mask=None,
                    n_workers: int, codec=None, codec_arg=None):
    """Bind a transform, or a registry-named config, to a parameter tree
    (a nested dict of shapes). Never warns.

    ``codec`` / ``codec_arg`` override the config's wire format, as the
    reference's: a ``codec_arg`` alone re-parameterizes the configured
    codec; a ``codec`` alone keeps the stored ``codec_arg`` only when it
    names the same codec (switching codecs resets the argument to that
    codec's default). An explicit ``codec`` also clears the deprecated
    ``quantize=False``, with a ``DeprecationWarning``."""
    if codec is not None or codec_arg is not None:
        old_codec = getattr(cfg, "codec", None)
        old_name = getattr(old_codec, "name", old_codec)   # instance -> name
        repl = {}
        if codec is None:
            codec = old_name
        else:
            if codec_arg is None and codec == old_name:
                # keep the configured codec itself: an instance carries its
                # parameters even when the codec_arg field is None
                codec = old_codec
                codec_arg = getattr(cfg, "codec_arg", None)
            if not getattr(cfg, "quantize", True):
                warnings.warn(
                    f"quantize=False is deprecated and overridden by the "
                    f"explicit codec={codec!r} argument",
                    DeprecationWarning, stacklevel=2)
                repl["quantize"] = True
        cfg = dataclasses.replace(cfg, codec=codec, codec_arg=codec_arg,
                                  **repl)
    transform = (cfg if isinstance(cfg, CompressedDP)
                 else transform_from_config(cfg))
    return transform(param_shapes, specs=specs, dp_mask=dp_mask,
                     n_workers=n_workers)


def make_optimizer(cfg, param_shapes, *, specs=None, dp_mask=None,
                   n_workers: int):
    """Deprecation shim for name-based construction: the legacy names
    (``LEGACY_NAMES``) warn with a ``DeprecationWarning`` naming the
    composed spelling, and every name returns the composed optimizer of
    :func:`build_optimizer`."""
    if isinstance(cfg, CompressedDP):
        return build_optimizer(cfg, param_shapes, specs=specs,
                               dp_mask=dp_mask, n_workers=n_workers)
    if cfg.name in LEGACY_NAMES:
        warnings.warn(
            f"make_optimizer(name={cfg.name!r}) is deprecated; build the "
            f"composed transform instead: {_LEGACY_SPELLING[cfg.name]} "
            f"(see repro.core.compressed)", DeprecationWarning,
            stacklevel=2)
    return build_optimizer(cfg, param_shapes, specs=specs, dp_mask=dp_mask,
                           n_workers=n_workers)
