"""Process groups of the multi-process regime: one paper-worker per
process, the PyTorch counterpart of ``src/repro/launch/mesh.py`` (where
the reference lays its workers out on a device mesh, the port starts a
process per worker and joins them in a ``torch.distributed`` group).

The backend follows from the device, by rule and never by trying one:

* ``nccl`` for CUDA devices, one rank per card (NCCL refuses two ranks on
  one card): local rank r runs on ``cuda:r``;
* ``gloo`` for the CPU;
* ``gloo`` with CUDA tensors only when the caller asks for it. With an
  indexed device (``cuda:0``) every rank of the node runs on that card;
  that is how one card holds several ranks, and their exchanges then go
  through host memory, so their times are not those of a wire.

Ranks, world size and rendezvous come from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) or from the caller (:func:`spawn`).
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.comm import DistComm, SimComm

BACKENDS = ("nccl", "gloo")


def launched() -> bool:
    """True in a process that a launcher such as torchrun started as one
    rank of a group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, local_world: int) -> None:
    """Raise unless ``local_world`` ranks of one node can run ``backend``
    on ``device``: NCCL only between CUDA devices and one rank per card,
    and a card for every rank that asks for one."""
    dev = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{list(BACKENDS)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no process group for device {dev}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl runs between CUDA devices; use gloo on the "
                         "CPU")
    if backend == "nccl" and dev.index is not None and local_world > 1:
        raise ValueError(
            f"nccl refuses two ranks on one card, and {dev} puts all "
            f"{local_world} ranks on it: pass --device cuda (one card per "
            f"rank), or --backend gloo to share one card")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        need = local_world if dev.index is None else dev.index + 1
        if cards < need:
            raise RuntimeError(
                f"{local_world} ranks on {dev} need {need} CUDA card(s), "
                f"found {cards}")


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda`` maps local rank r to ``cuda:r``; an
    indexed or CPU device is every rank's."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def init_workers(backend=None, device="cuda", *, rank: int = None,
                 world_size: int = None, local_rank: int = None,
                 local_world: int = None, init_method: str = "env://",
                 timeout_s: float = 600.0) -> torch.device:
    """Join this process to the default process group; returns its
    device. Arguments left as None come from torchrun's environment (a
    spawned rank passes them: its local rank and world are its rank and
    world). ``backend`` None picks nccl for CUDA and gloo for the CPU."""
    env = os.environ
    if rank is None:
        rank = int(env["RANK"])
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend or default_backend(device)
    check_backend(backend, device, local_world)
    dev = rank_device(device, local_rank)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dev


def worker_comm() -> DistComm:
    """The comm of this process's worker over the default group."""
    return DistComm()


def file_rendezvous(directory: str) -> str:
    """``init_method`` of a rendezvous through a file in ``directory``
    (which must not hold one yet): no port to pick or collide on."""
    return "file://" + os.path.join(os.path.abspath(directory),
                                    "rendezvous")


def spawn(fn, nprocs: int, args=(), timeout_s: float = 900.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes (start method
    spawn, safe after CUDA is up). A rank that raises makes this raise
    (the others are stopped); ranks still running after ``timeout_s``
    are killed and this raises TimeoutError."""
    ctx = mp.start_processes(fn, args=tuple(args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did "
                                   f"not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


# --- the exchange check (DistComm against SimComm) ---------------------

def exchange_payloads(n: int, device) -> dict:
    """Seeded stacked payloads (n, n, 6, 40) of n workers in f32, bf16,
    uint8, int8 and int32 (every dtype a codec's payload carries), each
    also as a strided (transposed) view; every rank draws the same ones
    and sends its own row."""
    g = torch.Generator().manual_seed(0)
    f = torch.randn((n, n, 6, 40), generator=g)
    u8 = torch.randint(0, 256, (n, n, 6, 40), generator=g,
                       dtype=torch.uint8)
    i8 = torch.randint(-128, 128, (n, n, 6, 40), generator=g,
                       dtype=torch.int8)
    i32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, n, 6, 40), generator=g,
                        dtype=torch.int32)
    out = {}
    for name, x in (("f32", f), ("bf16", f.to(torch.bfloat16)),
                    ("uint8", u8), ("int8", i8), ("int32", i32)):
        out[name] = x.to(device)
        out[name + "_strided"] = out[name].transpose(2, 3)
    return out


def _level_ops(levels, x) -> dict:
    """The collectives of the two comms of a split over payload ``x``:
    each level's all_to_all of the first ``size()`` blocks, and its
    all_gather."""
    out = {}
    for level, comm in zip(("outer", "inner"), levels):
        out[f"{level} all_to_all"] = comm.all_to_all(x[:, :comm.size()])
        out[f"{level} all_gather"] = comm.all_gather(x)
    return out


def exchange_reference(payloads: dict, inner: int = None) -> dict:
    """What SimComm gives each stacked worker for every payload (and,
    with ``inner``, what its split into pods of ``inner`` gives)."""
    out = {}
    for name, x in payloads.items():
        comm = SimComm(x.shape[0])
        out[name] = {"all_to_all": comm.all_to_all(x),
                     "all_gather": comm.all_gather(x)}
        if inner:
            out[name].update(_level_ops(comm.split(inner), x))
    return out


def check_exchange(rank: int, world_size: int, init_method: str, backend,
                   device, out_dir: str, inner: int = None) -> None:
    """Rank entry of the exchange check: DistComm's all_to_all and
    all_gather of this rank's row of every :func:`exchange_payloads` (and
    with ``inner`` those of its split into pods of ``inner``, over process
    subgroups), saved (on the CPU) as ``out_dir/exchange{rank}.pt`` for
    the caller to hold against :func:`exchange_reference`."""
    dev = init_workers(backend, device, rank=rank, world_size=world_size,
                       local_rank=rank, init_method=init_method)
    try:
        comm = worker_comm()
        levels = comm.split(inner) if inner else None
        out = {}
        for name, x in exchange_payloads(world_size, dev).items():
            mine = x[rank:rank + 1]
            ops = {"all_to_all": comm.all_to_all(mine),
                   "all_gather": comm.all_gather(mine)}
            if levels is not None:
                ops.update(_level_ops(levels, mine))
            out[name] = {op: t.cpu() for op, t in ops.items()}
        torch.save(out, os.path.join(out_dir, f"exchange{rank}.pt"))
    finally:
        dist.destroy_process_group()
