"""Base optimizer steps, PyTorch port of ``src/repro/core/base_steps.py``
(the Adam, LAMB and momentum-SGD bases).

A base owns the local, per-leaf half of an optimizer: the momentum
update, a preconditioner *linear in its buffer* while its slots stay
frozen between syncs, and the second-moment refresh. The compressed-DP
combinator (``core.compressed``) owns everything distributed.

Leaves carry the stack of workers on dim 0, so a per-leaf scalar (LAMB's
trust ratio) is a ``(stack,)`` tensor. Its norms sum each worker's
squares over that worker's own contiguous 1-D buffer (:func:`worker_l2`),
so that the reduction has the same shape, and on the card the same
bits, for a worker of a stack as for a process that holds it alone.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Tuple

import torch

from repro_torch.core import compressor as C
from repro_torch.kernels import fused_adam as FA


def worker_l2(x: torch.Tensor) -> torch.Tensor:
    """L2 norm of each stacked worker's leaf (stack, ...) -> (stack,) f32:
    ``sqrt(sum(x*x))`` over each worker's own contiguous 1-D buffer, the
    reference's ``_global_l2`` (no tensor parallelism here). A worker's
    buffer that is not 16-byte aligned is copied first, so that CUDA's
    reduction takes the same vectorized path as for a worker alone."""
    out = []
    for w in range(x.shape[0]):
        xw = x[w].to(torch.float32).reshape(-1)
        if xw.data_ptr() % 16:
            xw = xw.clone()
        out.append((xw * xw).sum())
    return FA.sqrt(torch.stack(out))


def bcast(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-worker (stack,) tensor viewed to broadcast against ``like``
    (stack, ...)."""
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


@dataclasses.dataclass(frozen=True)
class AdamBase:
    """Adam's local half-step (no bias correction, paper Eq. 3)."""

    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    kind: ClassVar[str] = "adam"
    has_variance: ClassVar[bool] = True
    has_trust: ClassVar[bool] = False        # layerwise trust-ratio scaling
    needs_anchor: ClassVar[bool] = False
    sync_slot_names: ClassVar[Tuple[str, ...]] = ()

    def slot_specs(self) -> Dict[str, Tuple[str, float]]:
        """name -> (shape kind, init value). ``view``: a stacked comm view
        per leaf; ``scalar``: one f32 per stacked worker and leaf."""
        return {"m": ("view", 0.0), "v": ("view", 0.0)}

    def precond_raw(self, buf, slots):
        return buf / FA.sqrt(slots["v"] + self.eps)

    def precond(self, buf, slots):
        """Parameter movement for a momentum-like buffer; linear in buf."""
        return self.precond_raw(buf, slots)

    def precond_(self, buf, slots):
        """:meth:`precond` written into ``buf`` itself, the same bits, with
        one temporary of its size (the denominator, rooted in place)."""
        return buf.div_(FA.sqrt_(slots["v"] + self.eps))

    def update_variance(self, v, g):
        """``beta2 * v + ((1 - beta2) * g) * g``, each product and the sum
        rounded as written; two temporaries at a time, not three (a leaf
        of gemma3-12b's embedding is 3.75 GiB)."""
        gg = (1 - self.beta2) * g
        gg.mul_(g)
        return torch.mul(v, self.beta2).add_(gg)

    def update_variance_(self, v, g):
        """:meth:`update_variance` written into ``v`` itself, the same
        roundings in the same order."""
        gg = (1 - self.beta2) * g
        gg.mul_(g)
        return v.mul_(self.beta2).add_(gg)

    def refresh_sync_slots(self, slots, anchor_nat, ubar_view, gamma_total,
                           layout) -> Dict[str, torch.Tensor]:
        """Slot updates at a sync, before the synced movement is taken
        with :meth:`precond`; Adam refreshes none. ``gamma_total`` is the
        step's f32 device tensor (a divide by it is a true divide)."""
        return {}


# The reference's refusal of ``store_anchor=False`` for a base with
# ``needs_anchor`` in the accumulate style (``{base}``: the base's class
# name), raised by ``core.compressed.CompressedDP``.
NEEDS_ANCHOR_TEXT = (
    "{base} refreshes slots at syncs and therefore requires "
    "store_anchor=True in the accumulate style (the anchor recovery path "
    "assumes a fixed preconditioner between syncs)")


@dataclasses.dataclass(frozen=True)
class LambBase(AdamBase):
    """LAMB: Adam's preconditioning scaled by a layerwise trust ratio
    ``clip(||x|| / ||update||)``. In the mean and gradient styles the
    ratio is recomputed every step from the current parameters; in the
    accumulate (0/1) style it is a carried per-leaf slot, frozen between
    syncs and refreshed at each sync from the anchor and the
    rate-normalized aggregate ``ubar / (sum(gamma) * sqrt(v + eps))``,
    which needs the stored anchor."""

    min_trust: float = 0.0
    max_trust: float = 10.0

    kind: ClassVar[str] = "lamb"
    has_trust: ClassVar[bool] = True
    needs_anchor: ClassVar[bool] = True
    sync_slot_names: ClassVar[Tuple[str, ...]] = ("trust",)

    def slot_specs(self):
        return {"m": ("view", 0.0), "v": ("view", 0.0),
                "trust": ("scalar", 1.0)}

    def precond(self, buf, slots):
        return bcast(slots["trust"], buf) * self.precond_raw(buf, slots)

    def precond_(self, buf, slots):
        return super().precond_(buf, slots).mul_(bcast(slots["trust"], buf))

    def trust_ratio(self, x_nat, upd_nat) -> torch.Tensor:
        """Per stacked worker: ``||x|| / ||upd||`` clipped to [min_trust,
        max_trust]; 1.0 wherever either norm is 0."""
        xn, un = worker_l2(x_nat), worker_l2(upd_nat)
        one = torch.ones_like(xn)
        ratio = torch.clamp(xn / torch.where(un > 0, un, one),
                            self.min_trust, self.max_trust)
        return torch.where((xn > 0) & (un > 0), ratio, one)

    def refresh_sync_slots(self, slots, anchor_nat, ubar_view, gamma_total,
                           layout):
        r = ubar_view / FA.sqrt(slots["v"] + self.eps)
        upd_nat = C.from_view(r, layout) / gamma_total
        return {"trust": self.trust_ratio(anchor_nat, upd_nat)}


@dataclasses.dataclass(frozen=True)
class MomentumSgdBase:
    """Momentum SGD, the 1-bit-SGD family's base step. No second moment:
    composed with ``compressed_dp`` it skips T_v entirely."""

    beta1: float = 0.9

    kind: ClassVar[str] = "sgd"
    has_variance: ClassVar[bool] = False
    has_trust: ClassVar[bool] = False
    needs_anchor: ClassVar[bool] = False
    sync_slot_names: ClassVar[Tuple[str, ...]] = ()

    def slot_specs(self) -> Dict[str, Tuple[str, float]]:
        return {"m": ("view", 0.0)}

    def precond_raw(self, buf, slots):
        return buf

    def precond(self, buf, slots):
        return buf

    def precond_(self, buf, slots):
        return buf

    def refresh_sync_slots(self, slots, anchor_nat, ubar_view, gamma_total,
                           layout) -> Dict[str, torch.Tensor]:
        return {}


def adam_base(beta1: float = 0.9, beta2: float = 0.999,
              eps: float = 1e-8) -> AdamBase:
    return AdamBase(beta1=beta1, beta2=beta2, eps=eps)


def lamb_base(beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
              min_trust: float = 0.0, max_trust: float = 10.0) -> LambBase:
    return LambBase(beta1=beta1, beta2=beta2, eps=eps,
                    min_trust=min_trust, max_trust=max_trust)


def momentum_sgd_base(beta1: float = 0.9) -> MomentumSgdBase:
    return MomentumSgdBase(beta1=beta1)
