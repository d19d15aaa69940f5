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
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
