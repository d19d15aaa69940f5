"""Base optimizer steps, PyTorch port of ``src/repro/core/base_steps.py``
(the Adam and momentum-SGD bases).

A base owns the local, per-leaf half of an optimizer: the momentum
update, a preconditioner *linear in its buffer* while its slots stay
frozen between syncs, and the second-moment refresh. The compressed-DP
combinator (``core.compressed``) owns everything distributed.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamBase:
    """Adam's local half-step (no bias correction, paper Eq. 3)."""

    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    kind: ClassVar[str] = "adam"
    has_variance: ClassVar[bool] = True
    sync_slot_names: ClassVar[Tuple[str, ...]] = ()

    def slot_specs(self) -> Dict[str, Tuple[str, float]]:
        """name -> (shape kind, init value)."""
        return {"m": ("view", 0.0), "v": ("view", 0.0)}

    def precond_raw(self, buf, slots):
        return buf / torch.sqrt(slots["v"] + self.eps)

    def precond(self, buf, slots):
        """Parameter movement for a momentum-like buffer; linear in buf."""
        return self.precond_raw(buf, slots)

    def update_variance(self, v, g):
        return self.beta2 * v + (1 - self.beta2) * g * g

    def refresh_sync_slots(self, slots, anchor_nat, ubar_view, gamma_total,
                           layout) -> Dict[str, torch.Tensor]:
        """Slot updates at a sync; Adam refreshes none."""
        return {}


@dataclasses.dataclass(frozen=True)
class MomentumSgdBase:
    """Momentum SGD, the 1-bit-SGD family's base step. No second moment:
    composed with ``compressed_dp`` it skips T_v entirely."""

    beta1: float = 0.9

    kind: ClassVar[str] = "sgd"
    has_variance: ClassVar[bool] = False
    sync_slot_names: ClassVar[Tuple[str, ...]] = ()

    def slot_specs(self) -> Dict[str, Tuple[str, float]]:
        return {"m": ("view", 0.0)}

    def precond_raw(self, buf, slots):
        return buf

    def precond(self, buf, slots):
        return buf

    def refresh_sync_slots(self, slots, anchor_nat, ubar_view, gamma_total,
                           layout) -> Dict[str, torch.Tensor]:
        return {}


def adam_base(beta1: float = 0.9, beta2: float = 0.999,
              eps: float = 1e-8) -> AdamBase:
    return AdamBase(beta1=beta1, beta2=beta2, eps=eps)


def momentum_sgd_base(beta1: float = 0.9) -> MomentumSgdBase:
    return MomentumSgdBase(beta1=beta1)
