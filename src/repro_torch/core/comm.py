"""Collectives over the worker (data-parallel) axis, PyTorch port of
``src/repro/core/comm.py``.

The optimizer code is written for a *stack* of workers: every per-worker
tensor carries a leading dim holding the workers this process runs. The
in-process simulator (:class:`SimComm`) holds all ``n`` workers on one
device and turns each collective into an operation on that dim, as the
reference's ``vmap`` regime materializes its worker axis. A process that
runs one worker of a real fleet holds a stack of one (:class:`DistComm`,
the counterpart of the reference's ``mesh_comm``): its collectives go
through ``torch.distributed``, NCCL between cards and gloo on the CPU.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist


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

    def exchange_ms(self):
        """Time the exchange collectives took since the last call, in ms;
        None where they run in process and move nothing."""
        return None


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


class DistComm(Comm):
    """One worker per process over the default ``torch.distributed``
    process group: a stack of one, ``size()`` the world size, ``index()``
    the rank. The exchange collectives move data and reduce nothing, so a
    rank receives bit for bit what :class:`SimComm` gives the simulated
    worker of the same index.

    Each exchange collective on CUDA tensors is bracketed by two CUDA
    events on the current stream (no synchronize); :meth:`exchange_ms`
    reads them. On the CPU, where gloo runs the collective before it
    returns, the host clock times it."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs an initialized process group "
                               "(repro_torch.launch.mesh.init_workers)")
        self.n = dist.get_world_size()
        self.rank = dist.get_rank()
        self._events = []
        self._host_s = 0.0

    def size(self) -> int:
        return self.n

    def index(self) -> np.ndarray:
        return np.array([self.rank])

    def _check(self, x):
        if x.shape[0] != 1:
            raise ValueError(f"a process holds a stack of one worker, got "
                             f"leading dim {x.shape[0]}")

    def _run(self, collective, out, x):
        if x.is_cuda:
            stream = torch.cuda.current_stream(x.device)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
            collective(out, x)
            ev[1].record(stream)
            self._events.append(ev)
        else:
            t0 = time.perf_counter()
            collective(out, x)
            self._host_s += time.perf_counter() - t0
        return out[None]

    def exchange_ms(self) -> float:
        """Summed time of the exchange collectives since the last call:
        each CUDA one from the start to the end event around it on the
        device's clock (waits for the last end event), each CPU one on
        the host's."""
        if self._events:
            self._events[-1][1].synchronize()
        ms = 1e3 * self._host_s + sum(a.elapsed_time(b)
                                      for a, b in self._events)
        self._events, self._host_s = [], 0.0
        return ms

    def psum(self, x):
        self._check(x)
        out = x.clone()
        dist.all_reduce(out)
        return out

    def pmean(self, x):
        return self.psum(x) / self.n

    def all_gather(self, x):
        self._check(x)
        x0 = x[0].contiguous()
        out = x0.new_empty((self.n * x0.shape[0],) + tuple(x0.shape[1:]))
        # all_gather_into_tensor: the name both torch 2.11 and 2.13 have
        # (2.13 would rather it were all_gather_single)
        return self._run(dist.all_gather_into_tensor, out, x0)

    def all_to_all(self, x):
        self._check(x)
        if x.shape[1] != self.n:
            raise ValueError(f"all_to_all needs {self.n} blocks on dim 1, "
                             f"got {x.shape[1]}")
        x0 = x[0].contiguous()
        return self._run(dist.all_to_all_single, torch.empty_like(x0), x0)
