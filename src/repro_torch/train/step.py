"""Trainer, PyTorch port of ``src/repro/train/step.py`` (the sim and
single modes, and the multi-process regime that stands in for the
reference's mesh mode).

Every parameter and optimizer-state tensor carries the stack of workers
this process runs on dim 0. The :class:`~repro_torch.core.comm.Comm` the
trainer is given decides the regime, where the reference has a pair of
init/step functions per mode:

* ``SimComm(n)``: ``n`` simulated workers on one device.
  The forward and backward passes run one worker at a time on its slice
  of the global batch, then the optimizer steps all workers at once, so
  each exchange phase of each leaf is one kernel launch for the stack;
* ``NullComm()``: one worker, every collective the identity (the
  reference's ``single`` mode);
* ``DistComm()``: one worker per process, a stack of one, collectives
  through ``torch.distributed`` (``repro_torch.launch.mesh``).

With a hierarchy in the optimizer config (pods of ``inner`` workers) the
trainer splits its comm into the outer and inner comm once, before the
first step (over process subgroups in the multi-process regime); one
worker normalizes the hierarchy away.

Worker ``i`` takes rows ``[i*B/n, (i+1)*B/n)`` of the global batch in
every regime, and with ``micro_batches > 1`` accumulates its gradient
over equal splits of them (:func:`accumulate_grads`).

:meth:`Trainer.save` and :meth:`Trainer.restore` write and read the
checkpoint format both packages share
(:mod:`repro_torch.checkpointing.io`), in the shapes of the reference
trainer's tree for the same mode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import interop
from repro_torch.checkpointing import io as ckpt_io
from repro_torch.core import api as opt_api
from repro_torch.core.comm import Comm, DistComm, NullComm, norm_hierarchy
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dp_mask, init_params, param_shapes,
                                       param_specs)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' (--device cpu) to run the plain versions on "
                "the CPU")
        # the reference is f32 throughout; keep matmuls and convolutions
        # out of TF32 (cuDNN's default is TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


DIST_SAVE = (
    "checkpoints of --mode dist are not ported yet: each rank holds one "
    "worker's state, and gathering the fleet's onto one rank is a later "
    "item (the reference writes its mesh mode's global arrays)")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """``micro_batches``: splits of each worker's share of the batch whose
    gradients are summed in order, then divided by their number. (The
    reference's ``peel_last_microbatch`` reorders no arithmetic; it exists
    for XLA's scheduler, and the eager loop here has nothing to peel.)"""

    micro_batches: int = 1

    def __post_init__(self):
        if self.micro_batches < 1:
            raise ValueError(f"micro_batches must be >= 1, got "
                             f"{self.micro_batches!r}")


def accumulate_grads(loss_fn: Callable, params, batch: Dict[str, torch.Tensor],
                     micro_batches: int):
    """Mean loss and gradients over ``micro_batches`` equal splits of
    ``batch`` (leading dim), as the reference's ``accumulate_grads``: for
    more than one split, zeros + g_1 + ... + g_mb in split order, then one
    f32 divide by mb, and the loss likewise. ``loss_fn(params, batch) ->
    (loss, aux)``; ``params`` is a tree of leaves without a worker dim.
    Returns (loss, gradient tree), both detached."""
    mb = micro_batches
    paths, xs = flatten_tree(params)
    leaves = [x.detach().requires_grad_(True) for x in xs]
    tree = unflatten_tree(paths, leaves)
    if mb <= 1:
        loss, _ = loss_fn(tree, batch)
        gs = torch.autograd.grad(loss, leaves)
        return loss.detach(), unflatten_tree(
            paths, [g.to(torch.float32) for g in gs])
    for k, v in batch.items():
        if v.shape[0] % mb:
            raise ValueError(
                f"per-worker batch leaf {k!r} has {v.shape[0]} rows, which "
                f"is not divisible by micro_batches={mb}; choose a global "
                f"batch size divisible by n_workers * micro_batches")
    per = next(iter(batch.values())).shape[0] // mb
    dev = xs[0].device
    gsum = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
            for x in xs]
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    for j in range(mb):
        loss, _ = loss_fn(tree, {k: v[j * per:(j + 1) * per]
                                 for k, v in batch.items()})
        gs = torch.autograd.grad(loss, leaves)
        for acc, g in zip(gsum, gs):
            acc.add_(g)
        lsum = lsum + loss.detach()
    # a device tensor: CUDA turns a divide by a host scalar into a
    # multiply by its reciprocal, which is not the reference's divide
    d = torch.tensor(float(mb), dtype=torch.float32, device=dev)
    return lsum / d, unflatten_tree(paths, [acc.div_(d) for acc in gsum])


def step_record(step: int, met) -> Dict:
    """One step's record of :meth:`Trainer.step`'s metrics: the stacked
    workers' losses, the step kind (``sync``, ``var``), and its times in
    ms (``step_ms`` the sum of ``fwd_bwd_ms`` and ``optimizer_ms``; the
    exchange's parts where the metrics have them)."""
    rec = {"step": step, "losses": met["losses"].tolist(),
           "sync": met["synced"], "var": met["var_round"],
           "step_ms": met["fwd_bwd_ms"] + met["optimizer_ms"]}
    rec.update({k: met[k] for k in ("fwd_bwd_ms", "optimizer_ms",
                                    "exchange_ms", "exchange_ms_intra",
                                    "exchange_ms_inter") if k in met})
    return rec


class Trainer:
    """Static plan (template, layouts, optimizer) plus the step of the
    workers this process runs."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg, *, comm: Comm,
                 trainer_cfg: TrainerConfig = TrainerConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.trainer_cfg = trainer_cfg
        self.comm = comm
        self.n_workers = comm.size()
        self.hierarchy = norm_hierarchy(opt_cfg.hierarchy, self.n_workers)
        # (outer, inner) comms, made here so that every rank creates its
        # subgroups before the first step, in the same order
        self.levels = (comm.split(self.hierarchy.inner)
                       if self.hierarchy is not None else None)
        self.template = T.model_template(model_cfg)
        self.opt = opt_api.build_optimizer(
            opt_cfg, param_shapes(self.template),
            specs=param_specs(self.template),
            dp_mask=dp_mask(self.template), n_workers=self.n_workers)

    def init(self, seed: int):
        """Stacked params (every worker starts from the same draw, in
        every process) and the optimizer state."""
        params = init_params(self.template, seed, device=self.device,
                             dtype=self.model_cfg.param_dtype)
        paths, leaves = flatten_tree(params)
        stack = len(self.comm.index())
        stacked = [x[None].expand((stack,) + tuple(x.shape)).clone()
                   for x in leaves]
        params = unflatten_tree(paths, stacked)
        return params, self.opt.init(params)

    def grads(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Per-worker loss and gradients of the stacked workers: worker i
        takes rows [i*B/n, (i+1)*B/n) of the global batch. Returns
        (losses (stack,), stacked grads tree)."""
        n = self.n_workers
        paths, xs = flatten_tree(params)
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"global batch {B} is not divisible by "
                             f"{n} workers")
        per = B // n
        widx = self.comm.index()
        gbuf: List[torch.Tensor] = [torch.empty_like(x) for x in xs]
        losses = torch.empty(len(widx), dtype=torch.float32,
                             device=self.device)
        for w, i in enumerate(widx):
            b = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, gs = accumulate_grads(
                lambda p, b_: T.lm_loss(p, self.model_cfg, b_),
                unflatten_tree(paths, [x[w] for x in xs]), b,
                self.trainer_cfg.micro_batches)
            for buf, g in zip(gbuf, flatten_tree(gs)[1]):
                buf[w].copy_(g)
            losses[w] = loss
        return losses, unflatten_tree(paths, gbuf)

    def step(self, params, state, batch):
        """One training step of the stacked workers: (params, state,
        metrics). ``metrics["losses"]`` holds each stacked worker's loss,
        ``metrics["loss"]`` their mean (the fleet's in sim and single
        mode; see :meth:`mean_loss` for a process of a larger fleet).
        The device is synchronized before the step and after each of its
        parts, whose times the metrics give in ms: ``fwd_bwd_ms``,
        ``optimizer_ms`` and ``exchange_ms`` (the part of the optimizer
        spent in the comm's collectives, None in process); with pods of
        more than one worker also ``exchange_ms_intra`` and
        ``exchange_ms_inter``, its intra-pod and inter-pod parts."""
        self._sync()
        t0 = time.perf_counter()
        losses, grads = self.grads(params, batch)
        self._sync()
        t1 = time.perf_counter()
        params, state, met = self.opt.step(self.comm, params, grads, state)
        self._sync()
        t2 = time.perf_counter()
        met["losses"] = losses
        met["loss"] = losses.mean()
        met["fwd_bwd_ms"] = 1e3 * (t1 - t0)
        met["optimizer_ms"] = 1e3 * (t2 - t1)
        met["exchange_ms"] = self.comm.exchange_ms()
        if self.hierarchy is not None and self.hierarchy.inner > 1:
            outer, inner = self.levels
            met["exchange_ms_intra"] = inner.exchange_ms()
            met["exchange_ms_inter"] = outer.exchange_ms()
        return params, state, met

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def checkpoint_stacked(self) -> bool:
        """Whether the checkpoint's leaves carry the worker dim: yes in
        sim mode; in single mode the optimizer state has none (its
        parameters keep the leading 1 of the reference's single mode,
        which is the port's stack of one)."""
        if isinstance(self.comm, DistComm):
            raise NotImplementedError(DIST_SAVE)
        return not isinstance(self.comm, NullComm)

    def checkpoint_tree(self, params, state):
        """``{"params", "state"}`` in the shapes and dtypes of the
        reference trainer's tree for this mode (tensor leaves where they
        are; scalars as numpy arrays)."""
        return {"params": params,
                "state": interop.state_to_reference(
                    state, stacked=self.checkpoint_stacked())}

    def checkpoint_like(self):
        """The checkpoint tree of this trainer on the ``meta`` device: the
        ``like`` tree of ``io.restore``, allocating nothing."""
        stack = len(self.comm.index())
        paths, shapes = flatten_tree(param_shapes(self.template))
        params = unflatten_tree(paths, [
            torch.empty((stack,) + tuple(s), device="meta",
                        dtype=self.model_cfg.param_dtype) for s in shapes])
        return self.checkpoint_tree(params, self.opt.init(params))

    def save(self, path: str, params, state, step: int, meta=None):
        """Write ``{"params", "state"}`` to ``path`` (npz + manifest v2)."""
        ckpt_io.save(path, self.checkpoint_tree(params, state), step=step,
                     meta=meta)

    def restore(self, path: str):
        """Read a checkpoint of this trainer's layout (either package's):
        (params, state, step, meta); the manifest is validated first."""
        tree, step, meta = ckpt_io.restore(path, self.checkpoint_like())
        params = interop.params_from_reference(tree["params"], self.device)
        state = interop.state_from_reference(
            tree["state"], self.opt, self.device,
            stacked=self.checkpoint_stacked())
        return params, state, step, meta

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mean_loss(self, met) -> float:
        """The loss averaged over every worker of the fleet; in the
        multi-process regime one all_reduce, so call it only on steps
        that are logged."""
        return float(self.comm.pmean(met["losses"])[0])
