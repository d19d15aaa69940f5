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

**Expert parallelism** (the moe family, the reference's EP planning):
the experts are split over the largest suffix of the worker axes whose
size divides the expert count (:func:`choose_ep`: every worker, the
pods of a hierarchy, or none); each worker holds its ``E/n_ep`` experts
on the stack dim like any other leaf, ``dp=False`` for the optimizer. A
process runs the real token exchange over its EP comm (the world, or
its pod); the simulator runs each worker against the merged experts and
gives each worker the sum of every worker's gradient of its experts
(see :mod:`repro_torch.models.moe`). The expert gradients are then
averaged over their replicas (the residual axis, processes only) and
divided by the EP degree (:meth:`Trainer._ep_scale_grads`), the
reference's mean-loss objective.

:meth:`Trainer.save` and :meth:`Trainer.restore` write and read the
checkpoint format both packages share
(:mod:`repro_torch.checkpointing.io`), in the shapes of the reference
trainer's tree for the same mode.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch.checkpointing import io as ckpt_io
from repro_torch.core import api as opt_api
from repro_torch.core.comm import Comm, DistComm, NullComm, norm_hierarchy
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dp_mask, ep_axes, init_params,
                                       local_shapes, param_specs)


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
    Returns (loss, gradient tree), both detached; a leaf the loss does
    not reach (whisper's cross ``bk``/``bv``) gets zeros, as under
    ``jax.grad``. The gradients are f32 sums over several splits; of one
    split they keep the parameters' dtype (bf16 in production), whose
    values are exactly the reference's f32 cast of them, at half the
    memory."""
    mb = micro_batches
    paths, xs = flatten_tree(params)
    leaves = [x.detach().requires_grad_(True) for x in xs]
    tree = unflatten_tree(paths, leaves)
    if mb <= 1:
        loss, _ = loss_fn(tree, batch)
        gs = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), unflatten_tree(paths, list(gs))
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
        gs = torch.autograd.grad(loss, leaves, materialize_grads=True)
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
                                    "exchange_ms_inter", "ep_a2a_ms",
                                    "aux", "dropped_frac") if k in met})
    return rec


def choose_ep(n_experts: int, n_workers: int, hierarchy) -> int:
    """The expert-parallel degree, as the reference's ``_choose_ep``: the
    size of the largest suffix of the worker axes (flat: the workers;
    with a hierarchy: (pods, workers a pod)) that divides the expert
    count; 1 without experts."""
    if not n_experts:
        return 1
    sizes = ([n_workers // hierarchy.inner, hierarchy.inner]
             if hierarchy is not None else [n_workers])
    for start in range(len(sizes) + 1):
        deg = int(np.prod(sizes[start:], dtype=np.int64))
        if n_experts % deg == 0:
            return deg
    return 1


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
        self.stack = len(comm.index())
        self.ep_degree = choose_ep(model_cfg.n_experts, self.n_workers,
                                   self.hierarchy)
        if 1 < self.ep_degree < self.n_workers and self.stack > 1:
            raise NotImplementedError(
                f"{model_cfg.name}: {model_cfg.n_experts} experts over "
                f"pods of {self.ep_degree} simulated workers (the EP "
                f"degree below the fleet's) runs only in processes: the "
                f"reference's simulator splits the experts over every "
                f"worker")
        self.template = T.model_template(model_cfg,
                                         ep_workers=self.ep_degree)
        _, axes = flatten_tree(ep_axes(self.template))
        self.ep_leaf_axes = {i: a for i, a in enumerate(axes)
                             if a is not None}
        # each worker's shapes: EP leaves hold E / ep_degree experts
        self.local_shapes = local_shapes(self.template, self.ep_degree)
        self.moe_metrics: Dict[str, float] = {}
        self.opt = opt_api.build_optimizer(
            opt_cfg, self.local_shapes, specs=param_specs(self.template),
            dp_mask=dp_mask(self.template), n_workers=self.n_workers)

    def ep_comms(self):
        """(EP comm, residual comm) of a process that holds one worker of
        an expert-parallel fleet: the comm of the workers that split the
        experts (the world, or the pod) and that of the workers holding
        the same experts (None when every worker holds its own); (None,
        None) elsewhere. Taken from ``self.comm`` at each call, so that a
        recording comm sees the exchanges."""
        if self.ep_degree == 1 or self.stack > 1:
            return None, None
        if self.ep_degree == self.n_workers:
            return self.comm, None
        outer, pod = self.comm.split(self.hierarchy.inner)
        return pod, outer

    def _ep_index(self, w: int) -> int:
        """The EP group index of stacked worker ``w`` (its experts' block):
        the worker itself in the simulator, the rank within its EP comm in
        a process."""
        if self.stack > 1:
            return w
        ep, _ = self.ep_comms()
        return int(ep.index()[0])

    def init(self, seed: int):
        """Stacked params (every worker starts from the same draw, in
        every process; an expert-parallel leaf holds its worker's block of
        experts) and the optimizer state. The draw is made on the CPU and
        moved to the device leaf by leaf."""
        params = init_params(self.template, seed, device="cpu",
                             dtype=self.model_cfg.param_dtype)
        paths, leaves = flatten_tree(params)
        del params
        stack = self.stack
        for i in range(len(leaves)):
            x = leaves[i]
            a = self.ep_leaf_axes.get(i)
            if a is None:
                x = x.to(self.device)
                leaves[i] = x[None].expand((stack,) + tuple(x.shape)).clone()
            else:
                blocks = x.unflatten(a, (self.ep_degree, -1)).movedim(a, 0)
                idx = [self._ep_index(w) for w in range(stack)]
                leaves[i] = blocks[idx].to(self.device).contiguous()
            del x
        params = unflatten_tree(paths, leaves)
        return params, self.opt.init(params)

    def grads(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Per-worker loss and gradients of the stacked workers: worker i
        takes rows [i*B/n, (i+1)*B/n) of the global batch. Returns
        (losses (stack,), stacked grads tree): each leaf in the dtype
        :func:`accumulate_grads` gives it (expert leaves f32, for their
        sums over the workers). The MoE layers' mean aux loss and dropped
        fraction are kept in ``self.moe_metrics``."""
        n = self.n_workers
        paths, xs = flatten_tree(params)
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"global batch {B} is not divisible by "
                             f"{n} workers")
        per = B // n
        widx = self.comm.index()
        ep_comm, _ = self.ep_comms()
        merged = self.stack > 1 and self.ep_degree > 1
        losses = torch.empty(len(widx), dtype=torch.float32,
                             device=self.device)
        gbuf: List[torch.Tensor] = []
        ep_sum: Dict[int, torch.Tensor] = {}
        stats: List[Dict] = []
        for w, i in enumerate(widx):
            b = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            mine = [x[w] for x in xs]
            if merged:
                # the simulator: every expert, each worker's block in turn
                for j, a in self.ep_leaf_axes.items():
                    mine[j] = xs[j].movedim(0, a).flatten(a, a + 1)
            loss, gs = accumulate_grads(
                lambda p, b_: T.lm_loss(p, self.model_cfg, b_, comm=ep_comm,
                                        moe_stats=stats),
                unflatten_tree(paths, mine), b,
                self.trainer_cfg.micro_batches)
            del mine
            gs = flatten_tree(gs)[1]
            for j in self.ep_leaf_axes:
                gs[j] = gs[j].to(torch.float32)
            if merged:
                for j in self.ep_leaf_axes:
                    g, gs[j] = gs[j], None
                    ep_sum[j] = g if w == 0 else ep_sum[j].add_(g)
            if len(widx) == 1:
                # a stack of one: the gradients themselves, no copy
                gbuf = [g[None] for g in gs]
            else:
                if not gbuf:
                    gbuf = [torch.empty(x.shape, device=x.device,
                                        dtype=torch.float32
                                        if g is None else g.dtype)
                            for g, x in zip(gs, xs)]
                for buf, g in zip(gbuf, gs):
                    if g is not None:
                        buf[w].copy_(g)
            del gs
            losses[w] = loss
        for j, a in self.ep_leaf_axes.items():
            if merged:
                # worker k's experts: block k of the summed gradient
                gbuf[j].copy_(ep_sum.pop(j).unflatten(
                    a, (self.ep_degree, -1)).movedim(a, 0))
            gbuf[j] = self._ep_scale_grads(gbuf[j])
        self.moe_metrics = ({
            "aux": float(torch.stack([m["aux_loss"].detach()
                                      for m in stats]).sum()) / len(widx),
            "dropped_frac": float(torch.stack(
                [m["dropped_frac"] for m in stats]).mean())}
            if stats else {})
        return losses, unflatten_tree(paths, gbuf)

    def _ep_scale_grads(self, g):
        """An expert leaf's gradient arrives as the sum over the EP group
        (the exchange's transpose): its mean over the replicas of these
        experts (the residual axis), then a true divide by the EP degree,
        the reference's ``_ep_scale_grads``."""
        _, residual = self.ep_comms()
        if residual is not None:
            g = residual.ep_residual_mean(g[0])[None]
        return g / torch.tensor(float(self.ep_degree), dtype=g.dtype,
                                device=g.device)

    def step(self, params, state, batch):
        """One training step of the stacked workers: (params, state,
        metrics), where ``params`` and ``state`` are the objects passed in,
        updated in place (the optimizer keeps every tensor's storage, and
        the gradients are freed once it has consumed them): a caller that
        steps one init twice, or reads the params or state from before a
        step, clones them first (``leafwise.clone_tree``,
        ``CompressedDPState.clone``). ``metrics["losses"]`` holds each stacked worker's loss,
        ``metrics["loss"]`` their mean (the fleet's in sim and single
        mode; see :meth:`mean_loss` for a process of a larger fleet).
        The device is synchronized before the step and after each of its
        parts, whose times the metrics give in ms: ``fwd_bwd_ms``,
        ``optimizer_ms`` and ``exchange_ms`` (the part of the optimizer
        spent in the comm's collectives, None in process); with pods of
        more than one worker also ``exchange_ms_intra`` and
        ``exchange_ms_inter``, its intra-pod and inter-pod parts. A MoE
        model adds ``aux`` (the workers' mean aux loss, summed over the
        layers), ``dropped_frac`` (the mean share of dropped token
        assignments) and, in processes, ``ep_a2a_ms`` (the time of the
        expert-parallel exchanges, within ``fwd_bwd_ms``)."""
        self._sync()
        t0 = time.perf_counter()
        losses, grads = self.grads(params, batch)
        self._sync()
        t1 = time.perf_counter()
        params, state, met = self.opt.step(self.comm, params, grads, state,
                                           donate_grads=True)
        del grads
        self._sync()
        t2 = time.perf_counter()
        met["losses"] = losses
        met["loss"] = losses.mean()
        met["fwd_bwd_ms"] = 1e3 * (t1 - t0)
        met["optimizer_ms"] = 1e3 * (t2 - t1)
        met["exchange_ms"] = self.comm.exchange_ms()
        ep_ms = self.comm.ep_ms()
        if ep_ms is not None and self.ep_degree > 1:
            met["ep_a2a_ms"] = ep_ms
        met.update(self.moe_metrics)
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
        paths, shapes = flatten_tree(self.local_shapes)
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
