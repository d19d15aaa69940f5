"""``compressed_dp``: compressed data-parallel sync as a transform over a
base step, PyTorch port of ``src/repro/core/compressed.py``.

    opt = compressed_dp(adam_base(), lr=..., sync_policy=...,
                        var_policy=...)(param_shapes, specs=..., n_workers=n)
    state = opt.init(params)
    params, state, metrics = opt.step(comm, params, grads, state)

Every per-worker tensor carries the stack of workers on dim 0. Three sync
styles:

* ``"accumulate"`` (paper Algorithm 1): local linearized half-steps
  accumulate ``u``; on T_u steps ``u`` goes through the Algorithm-2
  exchange and parameters re-anchor at the stored anchor,
  ``x = anchor - precond(u_bar)`` (``store_anchor=True``), or without an
  anchor take the correction ``x = x_half + precond(u - u_bar)``; on
  T_v steps the variance is refreshed from a full-precision gradient
  mean, for bases that carry one (a base without a variance, momentum
  SGD, has no ``"v"`` slot and no T_v round). LAMB's trust ratio is a
  carried per-leaf slot here, refreshed at each sync.
* ``"gradient"`` (1-bit Adam's two stages): a full-precision gradient
  mean while ``var_policy`` fires, then the Algorithm-2 exchange of the
  gradient itself with the variance frozen.
* ``"mean"`` (the uncompressed baseline): a full-precision gradient mean
  and a variance update every step.

The gradient and mean styles then take the base's step on the mean
gradient (:meth:`ComposedOptimizer._step_sync`), LAMB's with a trust
ratio recomputed every step. The policies run on the
host, so the sync and variance branches are plain Python ``if``s.

Every exchange runs once per *exchange unit*, in issue order
(``ComposedOptimizer.units``): a DP leaf, or with ``bucket_mb`` a bucket
of :mod:`repro_torch.core.bucketing`, whose EF state and anchor then live
in the bucket's layout (``u``, ``m`` and ``v`` stay per leaf). A step is
run unit by unit by a :class:`StepScheduler`: one unit after another
(:meth:`ComposedOptimizer.step`), or, from
:meth:`ComposedOptimizer.begin_step` with ``early``, each unit as soon as
its members' gradients are final, on a thread of its own, with the
phases of two units interleaved (the reference's per-unit ``lax.cond``
issue under ``peel_last_microbatch``), bit for bit the same step.

**Precision.** ``state_dtype`` is the dtype of every state tensor (``m``,
``v``, ``u``, the EF state: f32, bf16 as the reference's production runs
keep it, or fp16 as the paper does) except the per-leaf scalar slots
(LAMB's trust), which stay f32; the anchor keeps the
parameters' dtype. The arithmetic is f32 as in the reference: each leaf
(or exchange unit) is upcast, stepped and rounded back to its stored
dtype once, round-to-nearest-even, where the reference rounds it at the
end of its step. A sync step's exchange reads the f32 ``u'`` of the
local step, so a low-precision ``u`` gets an f32 buffer per leaf of the
unit being exchanged, never one for the whole model.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bucketing as BK
from repro_torch.core import codecs as CODECS
from repro_torch.core import compressor as C
from repro_torch.core import leafwise
from repro_torch.core import onebit_allreduce as AR
from repro_torch.core import schedules as S
from repro_torch.core.base_steps import NEEDS_ANCHOR_TEXT, bcast
from repro_torch.core.comm import Comm, Hierarchy
from repro_torch.kernels import dispatch as K
from repro_torch.kernels.fused_adam import STATE_DTYPES, fma, rsqrt

STYLES = ("accumulate", "gradient", "mean")


@dataclasses.dataclass
class CompressedDPState:
    step: int
    gamma_acc: np.float32         # sum of gamma since the last sync
    sync_pstate: tuple            # T_u policy state (host ints; accumulate)
    var_pstate: tuple             # T_v policy state (host ints)
    slots: Dict[str, List[torch.Tensor]]   # "m" (+ "v"): stacked views;
                                           # (+ "trust"): (stack,) f32
    # per leaf, None where the style keeps none (as the reference):
    u: List[Optional[torch.Tensor]]        # accumulated updates (accumulate)
    # per exchange unit: per leaf, or per bucket with bucket_mb
    err_w: List[Optional[torch.Tensor]]    # worker EF (stack,
                                           # *ef_worker_shape; not in mean)
    err_s: List[Optional[torch.Tensor]]    # server EF (stack, *chunk_shape)
    anchor: List[Optional[torch.Tensor]]   # x_{t'} copies (accumulate):
                                           # natural per leaf, the bucket
                                           # view per bucket

    def clone(self) -> "CompressedDPState":
        """A copy with storage of its own: the optimizer's step updates
        its state in place, so a caller that steps one state twice, or
        reads it after stepping it, steps a clone."""
        def c(x):
            return x.clone() if isinstance(x, torch.Tensor) else x
        return CompressedDPState(
            step=self.step, gamma_acc=self.gamma_acc,
            sync_pstate=self.sync_pstate, var_pstate=self.var_pstate,
            slots={k: [c(x) for x in v] for k, v in self.slots.items()},
            u=[c(x) for x in self.u], err_w=[c(x) for x in self.err_w],
            err_s=[c(x) for x in self.err_s],
            anchor=[c(x) for x in self.anchor])


@dataclasses.dataclass(frozen=True)
class StateKind:
    """Tag of one optimizer-state leaf, the reference's registry
    (``src/repro/core/compressed.py::StateKind``), for deriving sharding
    specs and abstract shapes generically.

    tags: ``scalar`` (a replicated scalar), ``view`` (the comm view of a
    DP leaf, the natural shape of a non-DP one), ``chunk`` (a server
    chunk, DP only), ``natural`` (param-shaped, DP only: anchors),
    ``leaf_scalar`` (a per-worker scalar, DP only: trust ratios). ``leaf``
    indexes the flat param leaf. With ``bucket_mb`` the EF state and the
    anchors live per bucket: ``bucket_view`` / ``bucket_chunk`` mirror
    ``view`` / ``chunk`` with ``leaf`` indexing ``bucket_plan.buckets``."""

    tag: str
    leaf: Optional[int] = None

    @property
    def bucketed(self) -> bool:
        return self.tag in ("bucket_view", "bucket_chunk")


_SCALAR = StateKind("scalar")


class _ExchangeUnit(NamedTuple):
    """One unit of the per-unit issue loop: a bucket, or a DP leaf when
    bucketing is off. ``state_idx`` indexes the EF/anchor lists (the flat
    leaf index, or the bucket index); ``members`` are flat leaf indices
    in unit-buffer order."""

    state_idx: int
    members: tuple
    layout: Any
    bucket: Any               # bucketing.Bucket | None (per-leaf unit)


@dataclasses.dataclass(frozen=True)
class CompressedDP:
    """Unbound transform: a base step plus the distributed-sync policy."""

    base: Any
    style: str = "accumulate"
    lr: Callable = S.ConstantLr(1e-3)
    sync_policy: Any = S.LrProportionalSyncPolicy(
        warmup_steps=12500, double_every=32768, max_interval=16)
    var_policy: Any = S.AdaptiveFreezePolicy(kappa=16)
    weight_decay: float = 0.0
    scale_mode: C.ScaleMode = "tensor"
    quantize: bool = True               # deprecated: False -> "identity"
    codec: Any = "sign1bit"             # a codecs.CODEC_NAMES entry or a
                                        # Codec instance
    codec_arg: Optional[float] = None   # argument of a named codec (topk:
                                        # density)
    store_anchor: bool = True           # keep x_{t'} (bitwise consensus at
                                        # syncs); False recovers it from u
    comm_dtype: Any = torch.bfloat16
    state_dtype: Any = torch.float32    # m, v, u and the EF state
    hierarchy: Optional[Hierarchy] = None   # two-level exchange (pods)
    bucket_mb: Optional[float] = None   # MiB of f32 elements per fused
                                        # bucket (core.bucketing); None:
                                        # the per-leaf exchange
    pack_order: str = "flat"            # unit packing/issue order
                                        # (bucketing.PACK_ORDERS)

    def __post_init__(self):
        if self.style not in STYLES:
            raise ValueError(f"style={self.style!r}; choose from {STYLES}")
        if self.bucket_mb is not None and self.bucket_mb <= 0:
            raise ValueError(
                f"bucket_mb must be positive (MiB per fused bucket), got "
                f"{self.bucket_mb!r}")
        if self.pack_order not in BK.PACK_ORDERS:
            raise ValueError(
                f"pack_order must be one of {BK.PACK_ORDERS}, got "
                f"{self.pack_order!r}")
        C.validate_scale_mode(self.scale_mode)
        if not self.quantize:
            warnings.warn(
                "quantize=False is deprecated; use codec=\"identity\" "
                "instead (the exact-mean exchange is now the identity "
                "codec — see repro.core.codecs)", DeprecationWarning,
                stacklevel=3)
        codec = CODECS.resolve_with_quantize(self.codec, self.quantize)
        object.__setattr__(self, "codec",
                           CODECS.make_codec(codec, self.codec_arg))
        if self.state_dtype not in STATE_DTYPES:
            raise ValueError(
                f"state_dtype={self.state_dtype}; the port keeps its "
                f"optimizer state in one of {STATE_DTYPES}")
        if (self.style == "accumulate" and self.base.needs_anchor
                and not self.store_anchor):
            raise ValueError(NEEDS_ANCHOR_TEXT.format(
                base=type(self.base).__name__))
        if self.style == "accumulate" and self.weight_decay:
            raise ValueError(
                "weight_decay is not supported in the accumulate style: a "
                "decay term makes the local step affine in x, breaking the "
                "u-linearization that lets syncs exchange the accumulated "
                "buffer (x_{t+1/2} = x_{t'} - precond(u) no longer holds). "
                "Use decoupled decay outside the optimizer, or the "
                "gradient/mean styles.")

    def __call__(self, param_shapes, *, specs=None, dp_mask=None,
                 n_workers: int):
        return ComposedOptimizer(self, param_shapes, specs, dp_mask,
                                 n_workers)


def compressed_dp(base, **kwargs) -> CompressedDP:
    return CompressedDP(base=base, **kwargs)


class ComposedOptimizer:
    """``compressed_dp(...)`` bound to a parameter tree."""

    def __init__(self, cfg: CompressedDP, param_shapes, specs, dp_mask,
                 n_workers: int):
        self.cfg = cfg
        self.base = cfg.base
        self.plan = leafwise.make_plan(param_shapes, specs, dp_mask,
                                       n_workers, cfg.hierarchy)
        self.dp = list(self.plan.dp_mask)
        self.n = n_workers
        self.hierarchy = self.plan.hierarchy
        self.layouts = self.plan.layouts
        self.ar_cfg = leafwise.make_ar_cfg(
            self.plan, scale_mode=cfg.scale_mode, codec=cfg.codec,
            comm_dtype=cfg.comm_dtype)
        self.codec = self.ar_cfg.codec
        self.bucket_plan = (BK.make_bucket_plan(self.plan, cfg.bucket_mb,
                                                pack_order=cfg.pack_order)
                            if cfg.bucket_mb is not None else None)
        if self.bucket_plan is not None:
            self.units = tuple(
                _ExchangeUnit(bi, b.members, b.layout, b)
                for bi, b in enumerate(self.bucket_plan.buckets))
        else:
            idx = [i for i, dp in enumerate(self.dp) if dp]
            if cfg.pack_order == "reverse_backward":
                idx = idx[::-1]
            self.units = tuple(_ExchangeUnit(i, (i,), self.layouts[i], None)
                               for i in idx)
        # DP leaf -> the position of its unit in issue order
        self.unit_of = BK.member_units([u.members for u in self.units])
        self._side_streams = {}
        self._use_sync_policy = cfg.style == "accumulate"
        self._use_var_policy = (cfg.style in ("accumulate", "gradient")
                                and self.base.has_variance)
        self._has_u = cfg.style == "accumulate"
        self._has_ef = cfg.style in ("accumulate", "gradient")
        self._has_anchor = self._has_u and cfg.store_anchor

    # ------------------------------------------------------------------ #
    def init(self, params) -> CompressedDPState:
        """State for stacked params (every leaf (stack, *shape)). A leaf
        outside data parallelism (an expert-parallel leaf) keeps its
        slots in its natural shape, no scalar slot, and no ``u``, EF
        state or anchor, as the reference."""
        xs = self.plan.flat(params)
        stack = xs[0].shape[0]
        los, dps = self.layouts, self.dp
        sd = self.cfg.state_dtype

        def slot(kind, init, x, lo, dp):
            if kind == "scalar":
                return (torch.full((stack,), init, dtype=torch.float32,
                                   device=x.device) if dp else None)
            return torch.full(x.shape[:1] + (lo.view_shape if dp
                                             else x.shape[1:]),
                              init, dtype=sd, device=x.device)

        slots = {name: [slot(kind, init, x, lo, dp)
                        for x, lo, dp in zip(xs, los, dps)]
                 for name, (kind, init) in self.base.slot_specs().items()}
        dev = xs[0].device
        if self.bucket_plan is None:
            ef_los = [lo if dp else None for lo, dp in zip(los, dps)]
            anchor = [x.detach().clone() if self._has_anchor and dp
                      else None for x, dp in zip(xs, dps)]
        else:
            # per-bucket EF and anchors: the bucket buffer is what the
            # codec compresses, so its error state and the re-anchored
            # params live in bucket shape
            ef_los = [b.layout for b in self.bucket_plan.buckets]
            anchor = [self._gather_bucket(b, [xs[i] for i in b.members])
                      .detach().clone() if self._has_anchor else None
                      for b in self.bucket_plan.buckets]
        efs = [AR.init_ef_state(lo, stack, dev, sd)
               if self._has_ef and lo is not None
               else AR.EFState(None, None) for lo in ef_los]
        return CompressedDPState(
            step=0, gamma_acc=np.float32(0.0),
            sync_pstate=(self.cfg.sync_policy.init()
                         if self._use_sync_policy else ()),
            var_pstate=(self.cfg.var_policy.init()
                        if self._use_var_policy else ()),
            slots=slots,
            u=[torch.zeros((stack,) + lo.view_shape, dtype=sd,
                           device=x.device)
               if self._has_u and dp else None
               for x, lo, dp in zip(xs, los, dps)],
            err_w=[ef.err_worker for ef in efs],
            err_s=[ef.err_server for ef in efs], anchor=anchor)

    def state_kinds(self) -> CompressedDPState:
        """The state's structure with a :class:`StateKind` for each
        tensor leaf (the same ``None`` placements as :meth:`init`), tag
        for tag the reference's ``state_kinds``; its host scalars (step,
        gamma, the policy states) are ``scalar``."""
        cfg, dps = self.cfg, self.dp
        slots = {}
        for name, (kind, _) in self.base.slot_specs().items():
            if kind == "scalar":
                slots[name] = [StateKind("leaf_scalar", i) if dp else None
                               for i, dp in enumerate(dps)]
            else:
                slots[name] = [StateKind("view", i) for i in range(len(dps))]
        bp = self.bucket_plan
        if bp is None:
            err_w = [StateKind("view", i) if (dp and self._has_ef) else None
                     for i, dp in enumerate(dps)]
            err_s = [StateKind("chunk", i) if (dp and self._has_ef) else None
                     for i, dp in enumerate(dps)]
            anchor = [StateKind("natural", i)
                      if (dp and self._has_anchor) else None
                      for i, dp in enumerate(dps)]
        else:
            nb = range(len(bp.buckets))
            err_w = [StateKind("bucket_view", bi) if self._has_ef else None
                     for bi in nb]
            err_s = [StateKind("bucket_chunk", bi) if self._has_ef else None
                     for bi in nb]
            anchor = [StateKind("bucket_view", bi)
                      if self._has_anchor else None for bi in nb]
        return CompressedDPState(
            step=_SCALAR, gamma_acc=_SCALAR,
            sync_pstate=tuple(_SCALAR for _ in (
                cfg.sync_policy.init() if self._use_sync_policy else ())),
            var_pstate=tuple(_SCALAR for _ in (
                cfg.var_policy.init() if self._use_var_policy else ())),
            slots=slots,
            u=[StateKind("view", i) if (dp and self._has_u) else None
               for i, dp in enumerate(dps)],
            err_w=err_w, err_s=err_s, anchor=anchor)

    def _gather_bucket(self, bucket, leaves_nat):
        """Natural member leaves -> bucket buffer (via their comm views)."""
        return BK.gather_views(bucket, [
            C.to_view(x, self.layouts[i])
            for x, i in zip(leaves_nat, bucket.members)])

    def _unit_gather(self, unit, views):
        """Member comm views -> the unit's exchange buffer."""
        if unit.bucket is None:
            (v,) = views
            return v
        return BK.gather_views(unit.bucket, views)

    def _unit_scatter(self, unit, buf):
        """Unit exchange buffer -> member comm views (inverse of
        :meth:`_unit_gather` on the true elements)."""
        if unit.bucket is None:
            return [buf]
        return BK.scatter_views(unit.bucket, buf,
                                [self.layouts[i] for i in unit.members])

    def _fullprec_phases(self, comm, unit, bufs):
        """Full-precision mean of one unit's member view buffers (the T_v
        and mean rounds), as a generator of its phases
        (``onebit_allreduce.fullprec_phases``). Elementwise, so fusing
        members into a bucket leaves every element's value as it is."""
        o = yield from AR.fullprec_phases(
            comm, self._unit_gather(unit, bufs), self.cfg.comm_dtype,
            self.hierarchy, unit.layout)
        return self._unit_scatter(unit, o)

    def _onebit_phases(self, comm, unit, bufs, err_w, err_s):
        """Algorithm 2 over one unit's member view buffers, as a generator
        of its phases: returns (the members' mean estimates, the unit's
        new EFState)."""
        o, ef = yield from AR.onebit_phases(
            comm, self._unit_gather(unit, bufs), AR.EFState(err_w, err_s),
            unit.layout, self.ar_cfg)
        return self._unit_scatter(unit, o), ef

    def side_stream(self, device: torch.device):
        """The CUDA stream this optimizer's early-issued units run on, one
        per card, made on first use."""
        if device not in self._side_streams:
            self._side_streams[device] = torch.cuda.Stream(device)
        return self._side_streams[device]

    def begin_step(self, comm: Comm, params, state: CompressedDPState,
                   donate_grads: bool = False,
                   early: bool = False) -> "StepScheduler":
        """Start one step of every stacked worker before its gradients
        exist: the step's host decisions (``lr``, the T_u and T_v rounds,
        ``gamma``) are fixed from the policies now. Hand each leaf's final
        gradient to :meth:`StepScheduler.grad_ready` (with ``early``, as
        soon as it is final: its unit's local step and exchange then start
        on a thread of their own, overlapping the rest of the backward),
        then call :meth:`StepScheduler.finish`."""
        return StepScheduler(self, comm, params, state, donate_grads, early)

    def step(self, comm: Comm, params, grads, state: CompressedDPState,
             donate_grads: bool = False):
        """One step of every stacked worker in the configured style.
        Returns (params, state, metrics): the same ``params`` tree and
        ``state`` object, updated in place (every tensor keeps its
        storage; the reference donates its state under ``jit``). A
        caller that needs the state or params from before the step
        clones them first (:meth:`CompressedDPState.clone`,
        :func:`repro_torch.core.leafwise.clone_tree`). With
        ``donate_grads`` the gradients' buffers may hold the local step's
        deltas afterwards (the trainer's gradients are dead after the
        step); else they stay as they were. The units run one after
        another, each exchange phase waited as soon as it is issued."""
        return self.begin_step(comm, params, state,
                               donate_grads).finish(grads)

    def _local_base_step(self, i, x, g, state, lr):
        """The plain local base step of a leaf outside data parallelism
        (an expert-parallel leaf), which never syncs, in place: the
        reference's ``mh = b1*m + (1-b1)*g`` (one FMA, as XLA contracts
        it), ``x -= precond(lr*mh)`` with the variance from before the
        step (LAMB: ``lr * trust * upd`` with the trust of this step),
        and the variance refreshed every step; in f32 over the upcast
        slots, each written back rounded to its dtype."""
        base = self.base
        b1 = float(np.float32(base.beta1))
        omb1 = float(np.float32(1.0 - base.beta1))
        m = state.slots["m"][i]
        mh = fma(_f32(m), b1, g * omb1)
        x32 = x.to(torch.float32)
        s32 = ({"v": _f32(state.slots["v"][i])} if base.has_variance
               else {})
        if base.has_trust:
            upd = base.precond_raw(mh, s32)
            lr_trust = float(lr) * base.trust_ratio(x32, upd)
            delta = bcast(lr_trust, upd) * upd
        elif base.has_variance:
            delta = base.precond_(mh * float(lr), s32)
        else:
            delta = mh * float(lr)
        _sub_into(x, x32, delta)
        m.copy_(mh)
        if base.has_variance:
            _update_variance_(base, state.slots["v"][i], g)


class _Aborted(Exception):
    """The step was abandoned before this unit's gradients came."""


def _advance(phases):
    """Resume a unit's job: the phases it has still to issue after the
    one it just issued, or None once it has ended."""
    try:
        return next(phases)
    except StopIteration:
        return None


#: seconds an abandoned step waits for its unit thread to stop
ABORT_JOIN_S = 30.0


class StepScheduler:
    """One step of a :class:`ComposedOptimizer`, unit by unit: the
    reference's per-unit issue (``unit_sync_cond``, ``unit_var_cond``,
    ``unit_grad_cond``), where each exchange unit's work depends only on
    its members' gradients.

    A step is a list of *jobs*, one per exchange unit and round, in the
    order the units are issued (``opt.units``): in the accumulate style
    the T_u job of every unit (its members' local steps, the Algorithm-2
    exchange, the re-anchor or correction), or on a local-only step the
    local half-steps, then on a T_v step the variance refresh of every
    unit; in the gradient and mean styles the exchange of the unit's
    gradients and the base step on their mean. A job is a generator of
    its collective phases (``onebit_allreduce.onebit_phases``) and starts
    once each member's gradient has come (:meth:`grad_ready`; a unit is
    ready when all its members are, ``bucketing.member_units``) and the
    job before it has issued its last collective, so that every rank
    issues the same collectives in the same order, the sequential
    step's.

    Without ``early`` (:meth:`ComposedOptimizer.step`) the jobs run one
    after another in :meth:`finish`, each phase waited when issued. With
    ``early`` they run on a thread of their own as their gradients come,
    two in flight: job k+1's local step and compress run while job k's
    last collective is in flight, and job k's last computation while job
    k+1's first collective is; at most two units' exchange temporaries
    are alive at once. On a card that thread runs on the optimizer's
    side stream (:meth:`ComposedOptimizer.side_stream`), which waits for
    each gradient's event (recorded where it was handed over) before it
    reads it; :meth:`finish` joins the thread and orders the caller's
    stream after the side stream. A gradient handed over during the
    backward is never written into (kernel 1's delta takes a buffer of
    its own): the backward may still hold it. Every value is bit for bit
    the sequential step's: the same kernels and ops on the same operands,
    only in another order across units, which share no tensor."""

    def __init__(self, opt: ComposedOptimizer, comm: Comm, params,
                 state: CompressedDPState, donate_grads: bool, early: bool):
        cfg, base = opt.cfg, opt.base
        self.opt, self.comm, self.params, self.state = opt, comm, params, state
        self.donate_grads = donate_grads
        t = state.step
        self.lr = lr = np.float32(cfg.lr(t))
        self.xs = xs = opt.plan.flat(params)
        self.gs: List[Optional[torch.Tensor]] = [None] * len(xs)
        self.donated = [False] * len(xs)
        self.events = [None] * len(xs)
        if cfg.style == "accumulate":
            self.do_sync, self.sync_ps, self.interval = cfg.sync_policy.step(
                state.sync_pstate, t)
            if base.has_variance:
                self.do_var, self.var_ps = cfg.var_policy.step(
                    state.var_pstate, t, self.interval)
            else:
                self.do_var, self.var_ps = False, state.var_pstate
            self.gamma_total = np.float32(state.gamma_acc + lr)
            # a device tensor, so ubar / gamma is a true f32 divide on
            # every device (CUDA turns a divide by a host scalar into a
            # multiply by its reciprocal); made once per step
            self.gamma_t = torch.tensor(self.gamma_total, device=xs[0].device)
            # (unit, job) pairs: the jobs are StepScheduler's functions,
            # not bound methods, which would make a reference cycle that
            # holds the step's gradients until the cyclic collector runs
            units = range(len(opt.units))
            job = (StepScheduler._sync_job if self.do_sync
                   else StepScheduler._local_job)
            self.jobs = [(k, job) for k in units] + (
                [(k, StepScheduler._var_job) for k in units]
                if self.do_var else [])
        else:
            if cfg.style == "gradient":
                if opt._use_var_policy:
                    self.do_var, self.var_ps = cfg.var_policy.step(
                        state.var_pstate, t, 1)
                else:
                    self.do_var, self.var_ps = False, state.var_pstate
            else:   # mean: the uncompressed baseline, no EF state at all
                self.do_var, self.var_ps = base.has_variance, state.var_pstate
            # a full-precision round (the mean style, and the gradient
            # style's first stage, which keeps its EF state), else 1-bit
            self.full = cfg.style == "mean" or self.do_var
            self._sync_constants()
            self.jobs = [(k, StepScheduler._grad_job)
                         for k in range(len(opt.units))]
        self.missing = [len(u.members) for u in opt.units]
        self._cond = threading.Condition()
        self._error: Optional[BaseException] = None
        self._aborted = False
        self._thread = self._stream = None
        if early:
            dev = xs[0].device
            if dev.type == "cuda":
                self._stream = opt.side_stream(dev)
                # gamma and every state tensor were written on this stream
                self._stream.wait_stream(torch.cuda.current_stream(dev))
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="unit-exchange")
            self._thread.start()

    # -- the gradients ---------------------------------------------------
    def grad_ready(self, i: int, g: torch.Tensor,
                   donate: bool = False) -> None:
        """Leaf ``i``'s final gradient, stacked (stack, *shape), in the
        dtype the sequential step would get it. With ``donate`` the step
        may write into it (the backward is over). Raises the unit
        thread's error where it has failed, so that a hook fails the
        backward."""
        if self._error is not None:
            raise self._error
        ev = None
        if self._stream is not None and g.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(g.device))
        with self._cond:
            self.gs[i], self.donated[i], self.events[i] = g, donate, ev
            if self.opt.dp[i]:
                k = self.opt.unit_of[i]
                self.missing[k] -= 1
                if not self.missing[k]:
                    self._cond.notify_all()

    def finish(self, grads=None):
        """Hand over every gradient of ``grads`` not handed yet (leaves
        the loss does not reach get no hook call: their units are issued
        now, in their place in the order), run or join the units' jobs,
        take the plain local base step of the leaves outside data
        parallelism, and write the step counters and policies. Returns
        (params, state, metrics) as :meth:`ComposedOptimizer.step`."""
        if grads is not None:
            for i, g in enumerate(self.opt.plan.flat(grads)):
                if self.gs[i] is None:
                    self.grad_ready(i, g, self.donate_grads)
        if self._thread is None:
            self._drive(window=1)
        else:
            self._thread.join()
            if self._error is not None:
                raise self._error
            if self._stream is not None:
                torch.cuda.current_stream(self._stream.device).wait_stream(
                    self._stream)
        opt, state, lr = self.opt, self.state, self.lr
        for i, dp in enumerate(opt.dp):
            if not dp:
                g = self.gs[i].to(torch.float32)
                if opt.cfg.style == "accumulate":
                    opt._local_base_step(i, self.xs[i], g, state, lr)
                else:
                    self._base_step(i, g)
        # the gradients are dead: let them go with the caller's
        self.gs = self.events = None
        state.step += 1
        state.var_pstate = self.var_ps
        if opt.cfg.style == "accumulate":
            state.gamma_acc = (np.float32(0.0) if self.do_sync
                               else self.gamma_total)
            state.sync_pstate = self.sync_ps
            metrics = {"lr": lr, "synced": self.do_sync,
                       "var_round": self.do_var, "interval": self.interval}
        else:
            metrics = {"lr": lr, "synced": True,
                       "var_round": bool(self.do_var), "interval": 1}
        return self.params, state, metrics

    def abort(self) -> None:
        """Abandon the step (its backward raised): stop the unit thread
        at its next wait for gradients."""
        if self._thread is not None:
            with self._cond:
                self._aborted = True
                self._cond.notify_all()
            self._thread.join(ABORT_JOIN_S)

    # -- running the jobs ------------------------------------------------
    def _run(self):
        try:
            if self._stream is None:
                self._drive(window=2)
            else:
                with torch.cuda.device(self._stream.device), \
                        torch.cuda.stream(self._stream):
                    self._drive(window=2)
        except _Aborted:
            pass
        except BaseException as e:     # re-raised by the step's caller
            self._error = e

    def _ready(self, k: int) -> bool:
        return not self.missing[k]

    def _await(self, k: int) -> None:
        """Block until unit ``k``'s members have their gradients; on a
        card, order the current stream after each of them."""
        with self._cond:
            while self.missing[k] and not self._aborted:
                self._cond.wait()
            if self._aborted:
                raise _Aborted
        if self._stream is not None:
            stream = torch.cuda.current_stream(self._stream.device)
            for i in self.opt.units[k].members:
                if self.events[i] is not None:
                    stream.wait_event(self.events[i])

    def _drive(self, window: int):
        """Run the jobs in order, with at most ``window`` (1 or 2) in
        flight; a job issues its first collective only after the job
        before it has issued its last."""
        flight = None       # the job before, its collectives all issued
        for k, job in self.jobs:
            if flight is not None and not self._ready(k):
                AR.run_phases(flight)
                flight = None
            self._await(k)
            phases = job(self, k)
            left = _advance(phases)
            if flight is not None:
                AR.run_phases(flight)
                flight = None
            while left:
                left = _advance(phases)
            if left is None:
                continue
            if window == 1:
                AR.run_phases(phases)
            else:
                flight = phases
        if flight is not None:
            AR.run_phases(flight)

    # -- the accumulate style --------------------------------------------
    def _grad_view(self, i):
        return C.to_view(self.gs[i].to(torch.float32), self.opt.layouts[i])

    def _local_step(self, i, u_out=None):
        """Kernel 1 on DP leaf i, in place: m and u (or ``u_out``, an f32
        buffer for a sync's exchange) updated from the gradient in its
        own dtype, the delta (f32) over the gradient's view where that is
        f32, dead (the T_v round below still needs it) and donated, else
        new. LAMB scales it by the leaf's frozen trust, as the
        reference."""
        opt, base, state = self.opt, self.opt.base, self.state
        slots, lo = state.slots, opt.layouts[i]
        g = C.to_view(self.gs[i], lo)
        delta = K.fused_local_step_view_(
            g, slots["m"][i], state.u[i],
            slots["v"][i] if base.has_variance else None, self.lr,
            base.beta1, getattr(base, "eps", 0.0), lo, kind=base.kind,
            into_grad=self.donated[i] and not self.do_var, u_out=u_out)
        if base.has_trust:
            delta.mul_(bcast(slots["trust"][i], delta))
        return delta

    def _local_job(self, k):
        """A local step: the half-step x -= delta of the unit's members."""
        opt, xs = self.opt, self.xs
        for i in opt.units[k].members:
            delta = self._local_step(i)
            _sub_into(xs[i], xs[i], C.from_view(delta, opt.layouts[i]))
            del delta
        yield from ()

    def _sync_job(self, k):
        """T_u of one exchange unit: its members' local steps (u' in f32
        for the exchange: in place when u is f32, else a buffer for this
        unit alone), one Algorithm-2 exchange, then each member's slot
        refresh (LAMB's trust), momentum ubar / gamma, u = 0 and either
        the re-anchor x = anchor - precond(ubar) or, without an anchor,
        the half-step followed by the correction x = x_half + precond(u'
        - ubar); EF state and anchor written back."""
        opt, base, state, xs = self.opt, self.opt.base, self.state, self.xs
        unit, slots, gamma_t = opt.units[k], state.slots, self.gamma_t
        use_anchor = opt.cfg.store_anchor
        si = unit.state_idx
        u32 = []
        for i in unit.members:
            uo = (None if state.u[i].dtype == torch.float32
                  else torch.empty(state.u[i].shape, dtype=torch.float32,
                                   device=state.u[i].device))
            delta = self._local_step(i, uo)
            if not use_anchor:
                _sub_into(xs[i], xs[i], C.from_view(delta, opt.layouts[i]))
            del delta
            u32.append(state.u[i] if uo is None else uo)
        ubars, ef = yield from opt._onebit_phases(
            self.comm, unit, u32, state.err_w[si], state.err_s[si])
        state.err_w[si].copy_(ef.err_worker)
        state.err_s[si].copy_(ef.err_server)
        del ef
        if not use_anchor:
            ancs = [None] * len(unit.members)
        else:
            u32 = [None] * len(u32)     # u' is dead once exchanged
            ancs = ([state.anchor[si]] if unit.bucket is None else
                    [C.from_view(a, opt.layouts[i]) for a, i in zip(
                        opt._unit_scatter(unit, state.anchor[si]),
                        unit.members)])
        sync_names = tuple(base.sync_slot_names)
        for i, ubar, anc, uh in zip(unit.members, ubars, ancs, u32):
            lo = opt.layouts[i]
            # the slots the refresh and the preconditioner read (not m,
            # which the sync replaces), upcast
            sl = {name: _f32(slots[name][i]) for name in slots
                  if name != "m"}
            sl.update(base.refresh_sync_slots(sl, anc, ubar, gamma_t, lo))
            for name in sync_names:
                slots[name][i].copy_(sl[name])
            torch.div(ubar, gamma_t, out=slots["m"][i])
            if use_anchor:
                # ubar is dead after the momentum: precondition it in
                # place (a copy first where the exchange handed back a
                # broadcast view, as an exact codec's gather does)
                ubar = ubar.contiguous()
                _sub_into(xs[i], anc, C.from_view(base.precond_(ubar, sl),
                                                  lo))
            else:
                # u' is dead after: the correction takes its buffer
                corr = base.precond_(uh.sub_(ubar), sl)
                torch.add(xs[i], C.from_view(corr, lo), out=xs[i])
                del corr
            state.u[i].zero_()
        del ubars, ancs, ubar, anc, sl, u32, uh
        if use_anchor:
            state.anchor[si].copy_(
                xs[si] if unit.bucket is None else opt._gather_bucket(
                    unit.bucket, [xs[i] for i in unit.members]))

    def _var_job(self, k):
        """T_v of one exchange unit: the full-precision variance refresh
        from the mean of its members' gradients."""
        opt = self.opt
        unit = opt.units[k]
        gbars = yield from opt._fullprec_phases(
            self.comm, unit, [self._grad_view(i) for i in unit.members])
        for i, gbar in zip(unit.members, gbars):
            _update_variance_(opt.base, self.state.slots["v"][i], gbar)

    # -- the gradient and mean styles ------------------------------------
    def _sync_constants(self):
        """The base step as XLA compiles the reference's (measured on jax
        0.9.0's CPU backend): m' = fma(b1, m, (1-b1)*g) and v' = fma(b2,
        v, ((1-b2)*g)*g); the divide by sqrt(v + eps) becomes a multiply
        by rsqrt(v + eps) with the variance from before this step's
        update; the parameter update is one more FMA: x' = fma(-(lr*m'),
        r, x) (momentum SGD: fma(m', -lr, x)), or with decay x' = x -
        fma(x, lr*wd, (lr*m')*r). LAMB's update u = m'*r (with decay
        fma(x, wd, m'*r)) is scaled by lr*trust, its trust recomputed
        every step from the current params: x' = fma(u, -(lr*trust),
        x). Host scalars are the f32 values the reference folds."""
        cfg, base = self.opt.cfg, self.opt.base

        def f32(a):
            return float(np.float32(a))

        self.wd = f32(cfg.weight_decay)
        self.lr_wd = f32(self.lr * np.float32(cfg.weight_decay))
        self.b1, self.omb1 = f32(base.beta1), f32(1.0 - base.beta1)
        if base.has_variance:
            self.b2, self.omb2, self.eps = (
                f32(base.beta2), f32(1.0 - base.beta2), f32(base.eps))

    def _base_step(self, i, g):
        """The gradient and mean styles' base step of leaf ``i`` on its
        mean gradient ``g`` (view-shaped for a DP leaf), in place: the
        reference's plain arithmetic, never the fused local step (which
        would write a ``u'`` these styles do not have); its multiply-adds
        are single-rounding, as XLA contracts them. A leaf outside data
        parallelism steps on its own gradient and refreshes its variance
        every step."""
        opt, base, state = self.opt, self.opt.base, self.state
        x, lo, dp = self.xs[i], opt.layouts[i], opt.dp[i]
        lr = self.lr

        def nat(a):
            return C.from_view(a, lo) if dp else a

        m = state.slots["m"][i]
        nm = fma(_f32(m), self.b1, g * self.omb1)
        x32 = x.to(torch.float32)
        nv = None
        if base.has_variance:
            v = _f32(state.slots["v"][i])
            if self.do_var or not dp:
                nv = fma(v, self.b2, (g * self.omb2) * g)
        if base.has_trust:
            upd = nat(nm * rsqrt(v + self.eps))
            if self.wd:
                upd = fma(x32, self.wd, upd)
            lr_trust = base.trust_ratio(x32, upd) * float(lr)
            nx = fma(upd, bcast(-lr_trust, upd), x32)
        elif base.has_variance:
            step = nat(nm * float(lr))
            r = nat(rsqrt(v + self.eps))
            nx = (x32 - fma(x32, self.lr_wd, step * r) if self.lr_wd
                  else fma(-step, r, x32))
        else:
            step = nat(nm)
            nx = (x32 - fma(x32, self.lr_wd, step * float(lr))
                  if self.lr_wd else fma(step, -float(lr), x32))
        x.copy_(nx)         # rounded once to the parameter dtype
        m.copy_(nm)
        if nv is not None:
            state.slots["v"][i].copy_(nv)

    def _grad_job(self, k):
        """One exchange unit of the gradient and mean styles: the exchange
        of its members' gradients (full precision, or Algorithm 2 with the
        unit's EF state), then each member's base step on its mean."""
        opt, state = self.opt, self.state
        unit = opt.units[k]
        si = unit.state_idx
        bufs = [self._grad_view(i) for i in unit.members]
        if self.full:
            outs = yield from opt._fullprec_phases(self.comm, unit, bufs)
        else:
            outs, ef = yield from opt._onebit_phases(
                self.comm, unit, bufs, state.err_w[si], state.err_s[si])
            state.err_w[si].copy_(ef.err_worker)
            state.err_s[si].copy_(ef.err_server)
            del ef
        del bufs
        for i, o in zip(unit.members, outs):
            self._base_step(i, o)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A state tensor at f32: itself, or an upcast copy (exact)."""
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _update_variance_(base, v: torch.Tensor, g: torch.Tensor) -> None:
    """The base's variance refresh of ``v`` in place: in f32 over an
    upcast copy where ``v`` is of lower precision, rounded back once."""
    if v.dtype == torch.float32:
        base.update_variance_(v, g)
    else:
        v.copy_(base.update_variance_(v.to(torch.float32), g))


def _sub_into(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """``x = a - b`` in f32 written into the parameter ``x`` (``a`` may be
    ``x`` itself), rounded once to its dtype, in one pass: torch computes
    a mixed-dtype op in the promoted f32 and rounds the result to nearest
    even as it writes it."""
    torch.sub(a, b, out=x)


def comm_accounting(opt: ComposedOptimizer) -> Dict[str, float]:
    """Static bytes per round of one worker, split into the topology's
    levels: ``*_inner`` the uncompressed intra-pod traffic (0 when flat),
    ``*_outer`` what crosses between pods (the codec's payloads for a
    sync, the owned slice for a full-precision round). The full-precision
    headline keeps the reference's (n-1)/n ring convention over the true
    parameters when flat and is the sum of the levels (padded views) with
    a hierarchy. Volumes and counts run over the exchange units (buckets
    with ``bucket_mb``, else the DP leaves): ``collectives_per_sync``
    counts exchange phases, 2 per unit flat, 4 hierarchical."""
    params = sum(int(np.prod(lo.shape))
                 for lo, dp in zip(opt.layouts, opt.dp) if dp)
    wire = torch.tensor([], dtype=opt.cfg.comm_dtype).element_size()
    comp = {"inner": 0, "outer": 0}
    full = {"inner": 0, "outer": 0}
    units = [u.layout for u in opt.units]
    for lo in units:
        lc = C.compressed_bytes_levels(lo, opt.cfg.scale_mode, wire,
                                       opt.codec)
        lf = C.fullprec_bytes_levels(lo, wire)
        for k in ("inner", "outer"):
            comp[k] += lc[k]
            full[k] += lf[k]
    n_inner = opt.hierarchy.inner if opt.hierarchy else 1
    full_total = (full["inner"] + full["outer"] if n_inner > 1 else
                  2.0 * (opt.n - 1) / max(opt.n, 1) * params * wire)
    total = comp["inner"] + comp["outer"]
    bplan = opt.bucket_plan
    return {"dp_params": float(params), "codec": opt.codec.name,
            "compressed_bytes_per_sync": float(total),
            "compressed_bytes_per_sync_inner": float(comp["inner"]),
            "compressed_bytes_per_sync_outer": float(comp["outer"]),
            "fullprec_bytes_per_round": float(full_total),
            "fullprec_bytes_per_round_inner": float(full["inner"]),
            "fullprec_bytes_per_round_outer": float(full["outer"]),
            "bits_per_param_sync": 8.0 * total / max(params, 1),
            "n_inner": float(n_inner), "n_outer": float(opt.n // n_inner),
            "dp_leaves": float(sum(opt.dp)),
            "exchange_units": float(len(units)),
            "collectives_per_sync": float(
                len(units) * (4 if n_inner > 1 else 2)),
            "bucket_mb": (float(bplan.bucket_mb) if bplan is not None
                          else None)}
