"""Collectives over the worker (data-parallel) axis, PyTorch port of
``src/repro/core/comm.py``.

The optimizer code is written for a *stack* of workers: every per-worker
tensor carries a leading dim holding the workers this process runs. The
in-process simulator (:class:`SimComm`) holds all ``n`` workers on one
device and turns each collective into an operation on that dim, as the
reference's ``vmap`` regime materializes its worker axis. A process that
runs one worker of a real fleet holds a stack of one.
"""
from __future__ import annotations

import numpy as np
import torch


class Comm:
    """Collectives over a leading dim of stacked workers (protocol)."""

    def size(self) -> int:
        raise NotImplementedError

    def index(self) -> np.ndarray:
        """Worker index of each stacked worker, int (stack,)."""
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(stack, k, ...) -> (stack, n*k, ...): every worker receives the
        concatenation of all workers' ``x`` along dim 1."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(stack, n, ...) -> (stack, n, ...): worker j receives block j of
        every worker, in sender order (split dim 1, concat dim 1)."""
        raise NotImplementedError


class SimComm(Comm):
    """``n`` simulated workers stacked on dim 0 of every tensor."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"SimComm needs n >= 1, got {n}")
        self.n = n

    def size(self) -> int:
        return self.n

    def index(self) -> np.ndarray:
        return np.arange(self.n)

    def _check(self, x):
        if x.shape[0] != self.n:
            raise ValueError(f"expected a stack of {self.n} workers, got "
                             f"leading dim {x.shape[0]}")

    def psum(self, x):
        self._check(x)
        return x.sum(0, keepdim=True).expand_as(x)

    def pmean(self, x):
        self._check(x)
        return x.mean(0, keepdim=True).expand_as(x)

    def all_gather(self, x):
        self._check(x)
        g = x.reshape((1, -1) + tuple(x.shape[2:]))
        return g.expand((self.n,) + tuple(g.shape[1:]))

    def all_to_all(self, x):
        self._check(x)
        if x.shape[1] != self.n:
            raise ValueError(f"all_to_all needs {self.n} blocks on dim 1, "
                             f"got {x.shape[1]}")
        return x.transpose(0, 1)


class NullComm(SimComm):
    """One worker: every collective is the identity."""

    def __init__(self):
        super().__init__(1)
