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

Expert parallelism exchanges tokens inside a forward, one worker at a
time: :meth:`Comm.ep_all_to_all` takes one worker's ``(n, ...)`` buffer
(no stack dim). A process holds one worker, so :class:`DistComm` runs it
over its group (timed apart from the optimizer's exchange:
:meth:`DistComm.ep_ms`) and :class:`NullComm` returns it; the simulator
has no worker to exchange with inside one worker's forward and refuses
it (its trainer runs each worker against the merged experts instead,
``repro_torch.models.moe``).

A two-level topology (:class:`Hierarchy`: pods of ``inner`` workers)
splits a comm into an outer and an inner comm (:meth:`Comm.split`). The
flat worker index is outer-major, ``w = k * n_inner + j``: the inner comm
of worker ``w`` is its pod, the contiguous block of workers with the same
``k``, and its outer comm the workers with the same ``j``.

Every exchange collective has an asynchronous form
(:meth:`Comm.all_to_all_async`, :meth:`Comm.all_gather_async`) that
returns a :class:`Handle` at once; its :meth:`Handle.wait` gives the
result. The optimizer's per-unit exchange issues its phases through
them (``core.onebit_allreduce``), so that a unit's collectives run while
later units are still being computed. In process they complete at once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Two-level worker topology: pods of ``inner`` workers on fast links,
    the pods joined by slow ones. The hierarchical exchange reduces
    uncompressed inside each pod and runs Algorithm 2's 1-bit exchange
    only across pods. (The reference's axis names have no counterpart
    here: the port's comms carry none.)"""

    inner: int                                  # workers per pod

    def __post_init__(self):
        if self.inner < 1:
            raise ValueError(f"hierarchy.inner must be >= 1, got "
                             f"{self.inner}")


def norm_hierarchy(h: Optional[Hierarchy], n_workers: int):
    """Validate a hierarchy against the worker count; None where it cannot
    apply (one worker), so that callers take the flat path. ``inner=1`` is
    kept: its two-level path is bit for bit the flat one."""
    if h is None or n_workers <= 1:
        return None
    if n_workers % h.inner:
        raise ValueError(
            f"hierarchy.inner={h.inner} must divide n_workers={n_workers}")
    return h


class Handle:
    """An issued collective: :meth:`wait` returns its result, (stack,
    ...), and orders the caller's later work after it (on a card, the
    current stream at the call waits for it; the host does not). Wait
    once, before the result or the operand is touched again."""

    __slots__ = ("_value", "_wait")

    def __init__(self, value=None, wait=None):
        self._value, self._wait = value, wait

    def wait(self) -> torch.Tensor:
        if self._wait is not None:
            self._value, self._wait = self._wait(), None
        return self._value


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

    def all_gather_async(self, x: torch.Tensor) -> Handle:
        """:meth:`all_gather`, issued: its :class:`Handle` (here complete
        at once)."""
        return Handle(self.all_gather(x))

    def all_to_all_async(self, x: torch.Tensor) -> Handle:
        """:meth:`all_to_all`, issued: its :class:`Handle` (here complete
        at once)."""
        return Handle(self.all_to_all(x))

    def ep_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The expert-parallel exchange of ONE worker's buffer (n, ...):
        block j goes to worker j, and block i of the result came from
        worker i."""
        if self.size() == 1:
            return x
        raise NotImplementedError(
            f"{type(self).__name__} runs the workers of a stack one at a "
            f"time in the forward, so one worker has no peer to exchange "
            f"tokens with: run each worker against the merged experts")

    def ep_residual_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of one worker's expert gradient over the replicas of
        its experts (this comm's group); the identity for one worker."""
        if self.size() == 1:
            return x
        return self.pmean(x[None])[0]

    def exchange_ms(self):
        """Time the exchange collectives took since the last call, in ms;
        None where they run in process and move nothing."""
        return None

    def spans_processes(self) -> bool:
        """Whether the collectives go to other processes (a worker per
        process), rather than run on the stack in this one."""
        return False

    def ep_ms(self):
        """Time the expert-parallel exchanges took since the last call, in
        ms; None where there are none across processes."""
        return None

    def split(self, inner: int):
        """(outer comm, inner comm) of the two-level topology with pods of
        ``inner`` workers, over the same stack of workers."""
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

    def split(self, inner: int):
        if inner < 1 or self.n % inner:
            raise ValueError(f"cannot split {self.n} workers into pods of "
                             f"{inner}")
        no = self.n // inner
        return SimLevelComm(no, inner, 0), SimLevelComm(no, inner, 1)


class SimLevelComm(SimComm):
    """One level of a split :class:`SimComm`: the ``n`` stacked workers
    seen as (n_outer, n_inner), outer-major; the group of a worker is the
    other workers along dim ``axis`` of that grid (0: the outer comm, the
    workers with the same inner index; 1: the inner comm, its pod)."""

    def __init__(self, n_outer: int, n_inner: int, axis: int):
        super().__init__(n_outer * n_inner)
        self.grid, self.axis = (n_outer, n_inner), axis
        self.group = self.grid[axis]

    def size(self) -> int:
        return self.group

    def index(self) -> np.ndarray:
        w = np.arange(self.n)
        return w % self.grid[1] if self.axis else w // self.grid[1]

    def _groups(self, x):
        """``x`` (n, ...) as (other, group, ...): dim 1 enumerates each
        worker's group."""
        self._check(x)
        return x.reshape(self.grid + tuple(x.shape[1:])).movedim(
            self.axis, 1)

    def _ungroup(self, g):
        g = g.movedim(1, self.axis)
        return g.reshape((self.n,) + tuple(g.shape[2:]))

    def psum(self, x):
        g = self._groups(x)
        return self._ungroup(g.sum(1, keepdim=True).expand_as(g))

    def pmean(self, x):
        g = self._groups(x)
        return self._ungroup(g.mean(1, keepdim=True).expand_as(g))

    def all_gather(self, x):
        g = self._groups(x)
        cat = g.reshape((g.shape[0], 1, -1) + tuple(g.shape[3:]))
        return self._ungroup(cat.expand(
            (g.shape[0], self.group) + tuple(cat.shape[2:])))

    def all_to_all(self, x):
        if x.shape[1] != self.group:
            raise ValueError(f"all_to_all needs {self.group} blocks on dim "
                             f"1, got {x.shape[1]}")
        return self._ungroup(self._groups(x).transpose(1, 2))

    def split(self, inner: int):
        raise NotImplementedError("a level of a split comm does not split "
                                  "again")


class NullComm(SimComm):
    """One worker: every collective is the identity."""

    def __init__(self):
        super().__init__(1)

    def split(self, inner: int):
        return NullComm(), NullComm()


def _covered(spans) -> float:
    """The length of the union of the intervals ``spans``."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class DistComm(Comm):
    """One worker per process over a ``torch.distributed`` process group
    (the default group, or ``group`` of a :meth:`split`): a stack of one,
    ``size()`` the group's size, ``index()`` this rank within it. The
    exchange collectives move data and reduce nothing, so a rank receives
    bit for bit what :class:`SimComm` gives the simulated worker of the
    same index.

    Every exchange collective is issued asynchronously
    (``async_op=True``; the synchronous forms wait for it at once) and
    timed where it runs, never by the wait, without a synchronize;
    :meth:`exchange_ms` reads the times. The comms of a split keep their
    events in the world comm's list, so that its :meth:`exchange_ms` is
    every level's time, and each keeps its own sum besides. Under NCCL the
    collective is issued from the world comm's own collective stream,
    which first waits for the caller's stream, records the start event,
    waits for the collective (a stream wait: the host goes on) and
    records the end event, so that the pair brackets the collective
    itself; the caller's stream waits for the end event in
    :meth:`Handle.wait`. One collective stream serializes a rank's
    exchange collectives, of every level, in issue order. Under gloo (CPU
    tensors, or CUDA tensors that gloo stages through the host) the host
    clock times each from its issue to the completion callback of the
    work's future; several may be in flight at once, and
    :meth:`exchange_ms` counts the time any was."""

    def __init__(self, group=None, _root=None):
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs an initialized process group "
                               "(repro_torch.launch.mesh.init_workers)")
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._root = self if _root is None else _root
        self._pending = []    # (event pair, owning comm), on the root only
        self._ms = 0.0
        self._spans = []      # (issue, completion) of each collective
                              # timed on the host clock
        self._ep_pending = []     # event pairs of the EP exchanges
        self._ep_ms = 0.0
        self._levels = {}
        self._nccl = dist.get_backend(group) == "nccl"
        self._streams = {}    # device -> the collective stream (root)

    def size(self) -> int:
        return self.n

    def index(self) -> np.ndarray:
        return np.array([self.rank])

    def spans_processes(self) -> bool:
        return True

    def _check(self, x):
        if x.shape[0] != 1:
            raise ValueError(f"a process holds a stack of one worker, got "
                             f"leading dim {x.shape[0]}")

    def _add(self, ms: float):
        self._ms += ms
        if self._root is not self:
            self._root._ms += ms

    def _call(self, collective, out, x, **kw):
        """The collective itself; a dtype the backend refuses raises,
        naming the backend, the collective and the dtype (a payload is
        never reinterpreted as another dtype)."""
        try:
            return collective(out, x, group=self.group, **kw)
        except RuntimeError as e:
            raise RuntimeError(
                f"{dist.get_backend(self.group)} refused "
                f"{collective.__name__} of a {x.dtype} tensor on "
                f"{x.device}: {e}") from e

    def _run_ep(self, x):
        """Run and time one expert-parallel all_to_all of ``x`` (kept in
        the root's own sum): CUDA events on the current stream around it,
        or the host clock on the CPU, where gloo runs it before it
        returns."""
        root, out = self._root, torch.empty_like(x)
        if x.is_cuda:
            stream = torch.cuda.current_stream(x.device)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
            self._call(dist.all_to_all_single, out, x)
            ev[1].record(stream)
            root._ep_pending.append(ev)
        else:
            t0 = time.perf_counter()
            self._call(dist.all_to_all_single, out, x)
            root._ep_ms += 1e3 * (time.perf_counter() - t0)
        return out

    def _start(self, collective, out, x) -> Handle:
        """Issue one exchange collective with ``async_op=True`` and time
        it (see the class docstring); its handle keeps ``x`` and ``out``
        alive until it is waited."""
        root = self._root
        if x.is_cuda and self._nccl:
            caller = torch.cuda.current_stream(x.device)
            cs = root._streams.get(x.device)
            if cs is None:
                cs = root._streams[x.device] = torch.cuda.Stream(x.device)
            cs.wait_stream(caller)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            with torch.cuda.stream(cs):
                ev[0].record(cs)
                self._call(collective, out, x, async_op=True).wait()
                ev[1].record(cs)
            root._pending.append((ev, self))

            def wait(keep=(x, out)):
                torch.cuda.current_stream(x.device).wait_event(ev[1])
                return out[None]
        else:
            t0 = time.perf_counter()
            work = self._call(collective, out, x, async_op=True)
            done = work.get_future().then(lambda _: time.perf_counter())

            def wait(keep=(x, out)):
                work.wait()
                span = (t0, done.wait())
                self._spans.append(span)
                if root is not self:
                    root._spans.append(span)
                return out[None]
        return Handle(wait=wait)

    def exchange_ms(self) -> float:
        """Summed time of this comm's exchange collectives since the last
        call (the world comm's: of every level): each CUDA one from the
        start to the end event around it on the device's clock (waits for
        the last end event), each CPU one on the host's; of the
        asynchronous ones timed on the host, which may be in flight
        together, the time during which at least one was."""
        root = self._root
        if root._pending:
            root._pending[-1][0][1].synchronize()
            for (a, b), owner in root._pending:
                owner._add(a.elapsed_time(b))
            root._pending = []
        ms, self._ms = self._ms + 1e3 * _covered(self._spans), 0.0
        self._spans = []
        return ms

    def ep_ms(self) -> float:
        """Summed time of the expert-parallel exchanges since the last
        call (of every level), timed as :meth:`exchange_ms`'s."""
        root = self._root
        if root._ep_pending:
            root._ep_pending[-1][1].synchronize()
            root._ep_ms += sum(a.elapsed_time(b)
                               for a, b in root._ep_pending)
            root._ep_pending = []
        ms, root._ep_ms = root._ep_ms, 0.0
        return ms

    def split(self, inner: int):
        """(outer, inner) comms over ``torch.distributed`` subgroups: the
        pods ``[k*inner + j for j]`` and the outer groups ``[k*inner + j
        for k]``. Both families are made on the first call, on every rank
        in the same order (every rank must call it), and kept."""
        if inner not in self._levels:
            if self._root is not self:
                raise NotImplementedError("a level of a split comm does "
                                          "not split again")
            if inner < 1 or self.n % inner:
                raise ValueError(f"cannot split {self.n} ranks into pods "
                                 f"of {inner}")
            no = self.n // inner
            if inner == 1:
                # pods of one: the outer comm is the world, the inner one
                # moves nothing
                self._levels[inner] = (self, NullComm())
            else:
                pod, _ = dist.new_subgroups_by_enumeration(
                    [[k * inner + j for j in range(inner)]
                     for k in range(no)])
                across, _ = dist.new_subgroups_by_enumeration(
                    [[k * inner + j for k in range(no)]
                     for j in range(inner)])
                self._levels[inner] = (DistComm(across, _root=self),
                                       DistComm(pod, _root=self))
        return self._levels[inner]

    def psum(self, x):
        self._check(x)
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def pmean(self, x):
        return self.psum(x) / self.n

    def all_gather(self, x):
        return self.all_gather_async(x).wait()

    def all_to_all(self, x):
        return self.all_to_all_async(x).wait()

    def all_gather_async(self, x):
        x0, out = self._ag_operands(x)
        # all_gather_into_tensor: the name both torch 2.11 and 2.13 have
        # (2.13 would rather it were all_gather_single)
        return self._start(dist.all_gather_into_tensor, out, x0)

    def all_to_all_async(self, x):
        x0 = self._a2a_operand(x)
        return self._start(dist.all_to_all_single, torch.empty_like(x0), x0)

    def _a2a_operand(self, x):
        self._check(x)
        if x.shape[1] != self.n:
            raise ValueError(f"all_to_all needs {self.n} blocks on dim 1, "
                             f"got {x.shape[1]}")
        return x[0].contiguous()

    def _ag_operands(self, x):
        self._check(x)
        x0 = x[0].contiguous()
        return x0, x0.new_empty((self.n * x0.shape[0],)
                                + tuple(x0.shape[1:]))

    def ep_all_to_all(self, x):
        if x.shape[0] != self.n:
            raise ValueError(f"the EP exchange needs {self.n} blocks on dim "
                             f"0, got {x.shape[0]}")
        if self.n == 1:
            return x
        return self._run_ep(x.contiguous())
