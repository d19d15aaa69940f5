"""T_u / T_v step policies and learning-rate schedules, PyTorch port of
``src/repro/core/schedules.py``.

The policies are host-side state machines over Python ints: the step
index, the next firing step and the update count are known on the host,
so branching on them costs no device round trip. Learning rates are f32
(numpy) so the device sees the value the reference computes in f32.

* T_v (:class:`AdaptiveFreezePolicy`): the j-th and (j+1)-th variance
  updates are ``2^floor(j/kappa)`` steps apart, and updates stop for good
  once the local-step interval exceeds 1.
* T_u (:class:`LrProportionalSyncPolicy`): sync every step through the
  warmup, then the interval doubles every ``double_every`` steps, capped
  at ``max_interval``.
* The baselines' policies: :class:`FixedWarmupPolicy` (1-bit Adam's
  full-precision stage, the first ``t0`` steps),
  :class:`EveryStepVariancePolicy` and :class:`EveryStepSyncPolicy`.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels.fused_adam import fma_f32


@dataclasses.dataclass(frozen=True)
class AdaptiveFreezePolicy:
    kappa: int = 16
    max_interval_pow: int = 30

    def init(self):
        return (0, 0, False)   # (next update step, updates done, stopped)

    def step(self, state, t: int, local_interval: int):
        nxt, j, stopped = state
        stopped = stopped or local_interval > 1
        fire = t == nxt and not stopped
        if fire:
            nxt = t + (1 << min(j // self.kappa, self.max_interval_pow))
            j += 1
        return fire, (nxt, j, stopped)


@dataclasses.dataclass(frozen=True)
class FixedWarmupPolicy:
    """T_v = {0, ..., t0-1}: 1-bit Adam's full-precision stage."""

    t0: int

    def init(self):
        return ()

    def step(self, state, t: int, local_interval: int):
        return t < self.t0, state


@dataclasses.dataclass(frozen=True)
class EveryStepVariancePolicy:
    """T_v = all steps: original Adam."""

    def init(self):
        return ()

    def step(self, state, t: int, local_interval: int):
        return True, state


@dataclasses.dataclass(frozen=True)
class LrProportionalSyncPolicy:
    warmup_steps: int
    double_every: int
    max_interval: int = 16

    def interval(self, t: int) -> int:
        if t < self.warmup_steps:
            return 1
        expo = min((t - self.warmup_steps) // self.double_every, 30)
        return min(1 << expo, self.max_interval)

    def init(self):
        return (0,)            # next sync step

    def step(self, state, t: int):
        (nxt,) = state
        fire = t >= nxt
        if fire:
            nxt = t + self.interval(t)
        return fire, (nxt,), self.interval(t)


@dataclasses.dataclass(frozen=True)
class EveryStepSyncPolicy:
    """T_u = all steps (no local steps)."""

    def init(self):
        return ()

    def step(self, state, t: int):
        return True, state, 1


@dataclasses.dataclass(frozen=True)
class LinearWarmupExpDecay:
    """Linear warmup, then x``decay`` every ``decay_period`` steps (f32)."""

    peak_lr: float
    warmup_steps: int
    decay: float = 0.99
    decay_period: int = 520

    def __call__(self, t: int) -> np.float32:
        f = np.float32
        tt = f(t)
        if tt < self.warmup_steps:
            return f(f(self.peak_lr) * (tt + f(1))) / f(
                max(self.warmup_steps, 1))
        k = np.floor(f(max(tt - f(self.warmup_steps), f(0)))
                     / f(self.decay_period))
        return f(f(self.peak_lr) * np.power(f(self.decay), f(k)))


@dataclasses.dataclass(frozen=True)
class ConstantLr:
    lr: float

    def __call__(self, t: int) -> np.float32:
        return np.float32(self.lr)


@functools.lru_cache(maxsize=None)
def _cosf():
    """libm's single-precision cosine, which XLA's CPU backend calls for
    an f32 ``cos``."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.restype, lib.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib.cosf


@dataclasses.dataclass(frozen=True)
class LinearWarmupCosine:
    """Linear warmup, then one cosine half-cycle from ``peak_lr`` down to
    ``min_lr`` at ``total_steps`` (f32).

    Written as XLA compiles the reference's formula, so the value is its
    f32 bit for bit: each divide by a constant becomes a multiply by the
    constant's f32 reciprocal (folded into the peak for the warmup), the
    cosine is libm's ``cosf``, and ``min_lr + c * (1 + cos)`` is one
    fused multiply-add."""

    peak_lr: float
    warmup_steps: int
    total_steps: int
    min_lr: float = 1e-5

    def __call__(self, t: int) -> np.float32:
        f = np.float32
        tt = f(t)
        if tt < f(self.warmup_steps):
            rate = f(f(self.peak_lr) * f(f(1) / f(max(self.warmup_steps, 1))))
            return f((tt + f(1)) * rate)
        inv = f(f(1) / f(max(self.total_steps - self.warmup_steps, 1)))
        frac = min(max(f((tt + f(-self.warmup_steps)) * inv), f(0)), f(1))
        cos = f(_cosf()(float(f(frac * f(np.pi)))))
        out = fma_f32(torch.tensor(f(cos + f(1))),
                      float(f(0.5 * (self.peak_lr - self.min_lr))),
                      torch.tensor(f(self.min_lr)))
        return f(out.item())
