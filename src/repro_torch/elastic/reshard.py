"""Elastic data parallelism: reshard 0/1 Adam state across DP widths,
PyTorch port of ``src/repro/elastic/reshard.py``.

A DP-width change (n -> m workers) re-chunks every comm view: the view's
leading axis enumerates worker-owned chunks (``core/compressor.py``), so
the per-worker EF residuals, server chunks, accumulated-update buffers
and bucket-shaped anchors are all laid out *for a specific n*. This
module turns that layout dependence into a pure index remap: the true
(unpadded) elements of every buffer are invariant under the width, so a
buffer resharded through its natural leaf shape lands pad-exact in the
new width's layout, and at m = n the transform is bitwise the identity.

Carry-vs-reset policy (the reference's, unchanged):

==================  ======  ================================================
state               policy  rationale
==================  ======  ================================================
params / anchors    carry   anchors are replicated (x_{t'}); survivors keep
                            their local drift, joiners clone a survivor and
                            re-converge bitwise at the next re-anchoring.
momentum ``m``      carry   replicated between syncs (refreshed from ubar);
                            joiners clone a survivor.
variance ``v``      carry   never reset: the variance freeze makes v stale
                            by design, and the resize is one more step of
                            staleness within the kappa tolerance.
``u`` (local acc.)  carry   survivors keep their unsynced local work; joiners
                            start at zero. A killed worker's unsynced u is
                            lost, as if its last micro-batches never ran.
``err_s`` (server)  carry   attached to chunk *positions*, not workers: the
                            index remap re-chunks it to the new owners.
``err_w`` (worker)  carry / the pending correction enters the next sync as
                    fold    (1/n_e)·sum(err). When m_e == n_e and no pod
                            died the remap is positional and bitwise;
                            otherwise the residuals fold into the carried
                            entities with scale m_e/n_e (plus the dead
                            entities' mass spread over the survivors), so
                            (1/m_e)·sum(err') == (1/n_e)·sum(err).
step / schedules    carry   replicated scalars; policies are step-indexed.
==================  ======  ================================================

The port keeps ``step``, ``gamma_acc`` and the policy states as host
scalars (one value for the stack), so a reshard leaves them as they are;
the reference stacks them per worker and gathers them like any leaf.
LAMB's ``trust`` slot (one f32 per stacked worker and leaf) is carried.

Hierarchy: with a two-level exchange the EF "entity" is the pod (the
inner level reduces full-precision; compression state belongs to pods),
so ``n_e = n / inner``. Flat layouts are the ``inner == 1`` case where
entity == worker. Survivor sets must be pod-aligned: a destination pod
drawing from two source pods has no well-defined residual and raises.

Every tensor carries the stack of workers on dim 0 (the sim layout of
``Trainer``); outputs are new contiguous tensors on the inputs' device,
the inputs are not modified. Leaves outside data parallelism (MoE's
expert-parallel leaves) are split on their expert axis: their params
and slots merge the workers' blocks and split them again over the new
fleet (:func:`ep_merge`, :func:`ep_split`), as the reference's. As in
the reference, a width change that changes a worker's share of experts
changes the leaf's shape, which :func:`reshard` refuses ("reshard
changes the worker count, never the model"); at m = n the transform is
the identity.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import compressor as C
from repro_torch.core.compressed import ComposedOptimizer, CompressedDPState
from repro_torch.core.leafwise import unflatten_tree

__all__ = ["reshard", "reshard_trainer", "resize_opt", "worker_origin",
           "reshard_report", "ep_merge", "ep_split"]


# --------------------------------------------------------------------- #
# origin maps
# --------------------------------------------------------------------- #

def worker_origin(n: int, m: int,
                  survivors: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Destination-worker -> source-worker map for a resize n -> m.

    ``survivors`` lists the source workers that are still alive, in the
    order they occupy destination slots (default: the first ``min(n, m)``
    source workers). Destination slots beyond the survivors are joiners,
    marked ``-1``.
    """
    if survivors is None:
        survivors = tuple(range(min(n, m)))
    sv = tuple(int(s) for s in survivors)
    if len(sv) != len(set(sv)):
        raise ValueError(f"survivors contains duplicates: {sv}")
    for s in sv:
        if not 0 <= s < n:
            raise ValueError(
                f"survivor {s} is not a worker of the n={n} source fleet")
    if len(sv) > min(n, m):
        raise ValueError(
            f"{len(sv)} survivors do not fit a resize {n}->{m} "
            f"(at most {min(n, m)} source workers can keep a slot)")
    return sv + (-1,) * (m - len(sv))


def _entity_origin(origin, n, m, ni_src, ni_dst):
    """Pod-level origin map (EF entities). Raises unless each destination
    pod draws its survivors from at most one source pod, and no source
    pod is carried twice (both would break residual-mass conservation)."""
    n_e, m_e = n // ni_src, m // ni_dst
    pod_origin = []
    for e in range(m_e):
        members = origin[e * ni_dst:(e + 1) * ni_dst]
        pods = {w // ni_src for w in members if w >= 0}
        if len(pods) > 1:
            raise ValueError(
                f"survivor set is not pod-aligned: destination pod {e} "
                f"draws workers from source pods {sorted(pods)} — the EF "
                f"residual belongs to the pod as a whole, so survivors "
                f"must keep pod-mates together (hierarchy inner="
                f"{ni_src}->{ni_dst})")
        pod_origin.append(pods.pop() if pods else -1)
    carried = [p for p in pod_origin if p >= 0]
    if len(carried) != len(set(carried)):
        raise ValueError(
            f"survivor set carries one source pod into several destination "
            f"pods ({pod_origin}) — duplicating an EF residual breaks "
            f"mass conservation; choose a pod-aligned survivor set")
    dead = sorted(set(range(n_e)) - set(carried))
    return tuple(pod_origin), tuple(dead), n_e, m_e


def _owner_of_rows(n: int, n_inner: int) -> np.ndarray:
    """Stacked worker serving each view row: row ``r = i*n_outer + o`` is
    served by worker ``(o, i)``, stacked (outer-major) at ``o*n_inner + i``
    (see onebit_allreduce: ``widx = j * n_outer + k``)."""
    no = n // n_inner
    r = np.arange(n)
    return (r % no) * n_inner + r // no


def _rows_of_workers(n: int, n_inner: int) -> np.ndarray:
    """Inverse of :func:`_owner_of_rows`: the view row served by each
    stacked worker ``w = o*n_inner + i``."""
    no = n // n_inner
    w = np.arange(n)
    return (w % n_inner) * no + w // n_inner


# --------------------------------------------------------------------- #
# buffer remaps
# --------------------------------------------------------------------- #

def _remap_fn(src_lo, dst_lo):
    """View-buffer remap src layout -> dst layout through the natural
    leaf (pad-exact both ways), for views with any leading dims.
    Identity when the layouts agree, so the m = n round trip is bitwise
    even if pad slots held garbage."""
    if src_lo == dst_lo:
        return lambda v: v
    return lambda v: C.to_view(C.from_view(v, src_lo), dst_lo)


def ep_merge(x: torch.Tensor, ax: int) -> torch.Tensor:
    """Worker-stacked EP leaf (n, ..., E/n @ ax+1, ...) -> the global leaf
    (..., E @ ax, ...)."""
    return x.movedim(0, ax).flatten(ax, ax + 1)


def ep_split(x: torch.Tensor, ax: int, m: int) -> torch.Tensor:
    """Global EP leaf -> worker-stacked (m, ..., E/m @ ax+1, ...)."""
    return x.unflatten(ax, (m, x.shape[ax] // m)).movedim(ax, 0).contiguous()


def _ep_reshard(x, i, ax, n, m, what):
    """An expert-parallel buffer from n workers' blocks to m's."""
    if n == m:
        return x.clone()
    merged = ep_merge(x, ax)
    if merged.shape[ax] % m:
        raise ValueError(
            f"{what} leaf {i}: expert axis of size {merged.shape[ax]} does "
            f"not divide over m={m} workers")
    return ep_split(merged, ax, m)


def _take(x: torch.Tensor, rows) -> torch.Tensor:
    """Rows ``rows`` (host ints) of ``x``'s dim 0, as a new tensor."""
    return x.index_select(0, torch.as_tensor(np.asarray(rows), dtype=torch.long,
                                             device=x.device))


class _Ctx:
    """One resize's static plumbing, shared by every buffer."""

    def __init__(self, src, dst, survivors):
        self.n, self.m = src.n, dst.n
        self.ni_s = src.hierarchy.inner if src.hierarchy else 1
        self.ni_d = dst.hierarchy.inner if dst.hierarchy else 1
        self.origin = worker_origin(self.n, self.m, survivors)
        (self.pod_origin, self.dead_e,
         self.n_e, self.m_e) = _entity_origin(
            self.origin, self.n, self.m, self.ni_s, self.ni_d)
        self.carried_e = [p for p in self.pod_origin if p >= 0]
        # fold only when the entity count changes or residual mass died —
        # the m_e == n_e no-deaths path must stay bitwise
        self.fold = (self.m_e != self.n_e) or bool(self.dead_e)
        S = max(len(self.carried_e), 1)
        # the reference's python floats enter its f32 arithmetic as f32
        # (weak types): the same roundings here on every device
        self.alpha = float(np.float32(self.m_e / self.n_e))
        self.beta = float(np.float32(self.m_e / (self.n_e * S)))
        fill = next((o for o in self.origin if o >= 0), 0)
        self.idx = [o if o >= 0 else fill for o in self.origin]
        self.joiners = [k for k, o in enumerate(self.origin) if o < 0]
        self.jmask = (np.asarray([o >= 0 for o in self.origin])
                      if self.joiners else None)

    def carry(self, x, remap=None, joiner="clone"):
        """Per-worker stacked (n, ...) -> (m, ...): origin gather, optional
        remap of every row, joiners cloned from a survivor or zeroed."""
        g = _take(x, self.idx)
        if remap is not None:
            g = remap(g)
        if joiner == "zero" and self.jmask is not None:
            mk = torch.as_tensor(self.jmask, device=g.device).reshape(
                (self.m,) + (1,) * (g.dim() - 1))
            g = torch.where(mk, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))
        return g.contiguous()


def _reshard_err_s(es, lo_s, lo_d):
    """Server-side EF: one chunk row per worker, attached to the chunk
    *position*. Assemble the full view in serving order, remap the
    elements to the new geometry, re-slice to the new owners."""
    full = _take(es, _owner_of_rows(lo_s.n, lo_s.n_inner))
    full = _remap_fn(lo_s, lo_d)(full)
    return _take(full, _rows_of_workers(lo_d.n, lo_d.n_inner))


def _reshard_err_w(ew, lo_s, lo_d, ctx: _Ctx):
    """Worker-side EF: pod-level entity carry with mass-conserving fold.

    Each pod's workers hold inner-slices of the pod's full-view residual
    (slice i = view rows [i*n_outer, (i+1)*n_outer)); assemble per-pod
    full views, remap each to the new geometry, fold, re-slice. The fold
    is the reference's eager f32 arithmetic, three roundings:
    ``r*alpha``, ``beta*dead_sum`` and their sum, with ``dead_sum`` a
    python ``sum`` over the dead pods in index order.
    """
    n_e, m_e = ctx.n_e, ctx.m_e
    R = ew.reshape((n_e, lo_s.n_inner) + lo_s.ef_worker_shape)
    R = R.reshape((n_e,) + lo_s.view_shape)
    R = _remap_fn(lo_s, lo_d)(R)                 # (n_e,) + dst view_shape
    dead_sum = None
    if ctx.dead_e:
        dead_sum = sum(R[d].to(torch.float32) for d in ctx.dead_e)
    rows = []
    for e in range(m_e):
        p = ctx.pod_origin[e]
        if p < 0:
            rows.append(torch.zeros(lo_d.view_shape, dtype=ew.dtype,
                                    device=ew.device))
            continue
        r = R[p]
        if ctx.fold:
            r32 = r.to(torch.float32) * ctx.alpha
            if dead_sum is not None:
                r32 = r32 + ctx.beta * dead_sum
            r = r32.to(ew.dtype)
        rows.append(r)
    out = torch.stack(rows)
    out = out.reshape((m_e, lo_d.n_inner) + lo_d.ef_worker_shape)
    return out.reshape((lo_d.n,) + lo_d.ef_worker_shape)


# --------------------------------------------------------------------- #
# the transform
# --------------------------------------------------------------------- #

def _require_composed(opt, which):
    if not isinstance(opt, ComposedOptimizer):
        raise TypeError(
            f"reshard needs a composed optimizer (repro_torch.core."
            f"compressed.ComposedOptimizer) as the {which} plan; legacy "
            f"optimizer classes do not expose the layout geometry — rebuild "
            f"via compressed_dp(...) / build_optimizer(...)")


def _validate_pair(src, dst):
    if src.plan.paths != dst.plan.paths:
        raise ValueError("source and destination optimizers are bound to "
                         "different parameter trees")
    for i, (a, b) in enumerate(zip(src.layouts, dst.layouts)):
        if a.shape != b.shape:
            raise ValueError(
                f"leaf {i}: natural shape {a.shape} != {b.shape} — "
                f"reshard changes the worker count, never the model")
    if list(src.plan.dp_mask) != list(dst.plan.dp_mask):
        raise ValueError("source and destination dp_mask differ")
    sbp, dbp = src.bucket_plan, dst.bucket_plan
    if (sbp is None) != (dbp is None):
        raise ValueError(
            "bucketing must match across the resize (bucket_mb on both "
            "sides or neither) — switching exchange granularity is a "
            "different state tree, not a width change")
    if sbp is not None:
        if len(sbp.buckets) != len(dbp.buckets):
            raise ValueError(
                f"bucket plans diverge across the resize "
                f"({len(sbp.buckets)} vs {len(dbp.buckets)} buckets); "
                f"bucket membership should be width-independent")
        for k, (a, b) in enumerate(zip(sbp.buckets, dbp.buckets)):
            if a.members != b.members or a.sizes != b.sizes:
                raise ValueError(
                    f"bucket {k} membership diverges across the resize "
                    f"({a.members} vs {b.members})")


def _stack_of(state: CompressedDPState) -> Tuple[int, ...]:
    return tuple(state.slots["m"][0].shape)


def reshard(state: CompressedDPState, src: ComposedOptimizer,
            dst: ComposedOptimizer, *, survivors=None,
            ep_axes=None) -> CompressedDPState:
    """Remap worker-stacked optimizer state from ``src`` (n workers) to
    ``dst`` (m workers) under the module's carry-vs-reset policy.

    ``state`` is the sim-layout stacked state (every per-worker tensor
    with a leading dim of n, as ``Trainer.init`` gives it under
    ``SimComm(n)``). ``ep_axes`` (flat leaf index -> expert axis, the
    trainer's ``ep_leaf_axes``) is needed only where the tree has
    expert-parallel leaves. Prefer :func:`reshard_trainer`, which
    supplies it and reshards the parameters too.
    """
    _require_composed(src, "source")
    _require_composed(dst, "destination")
    if not isinstance(state, CompressedDPState):
        raise TypeError(
            f"reshard operates on CompressedDPState, got "
            f"{type(state).__name__}")
    _validate_pair(src, dst)
    n = src.n
    if _stack_of(state)[0] != n:
        raise ValueError(
            f"expected worker-stacked state with leading dim {n} (sim "
            f"layout); state.slots['m'][0] has shape {_stack_of(state)}")
    ctx = _Ctx(src, dst, survivors)

    def ep(x, i, what):
        if ep_axes is None or i not in ep_axes:
            raise ValueError(
                f"leaf {i} is expert-parallel (dp_mask False) and its "
                f"'{what}' buffer is split on the expert axis; pass "
                f"ep_axes= or use reshard_trainer(...)")
        return _ep_reshard(x, i, ep_axes[i], n, dst.n, what)

    slot_specs = src.base.slot_specs()
    new_slots: Dict[str, list] = {}
    for name, vals in state.slots.items():
        kind = slot_specs[name][0]
        outs = []
        for i, x in enumerate(vals):
            if x is None:
                outs.append(None)
            elif kind == "scalar":
                outs.append(ctx.carry(x))
            elif not src.plan.dp_mask[i]:
                outs.append(ep(x, i, name))
            else:
                outs.append(ctx.carry(
                    x, _remap_fn(src.layouts[i], dst.layouts[i])))
        new_slots[name] = outs

    new_u = []
    for i, x in enumerate(state.u):
        if x is None:
            new_u.append(None)
        else:
            new_u.append(ctx.carry(
                x, _remap_fn(src.layouts[i], dst.layouts[i]),
                joiner="zero"))

    sbp, dbp = src.bucket_plan, dst.bucket_plan
    new_ew, new_es, new_anchor = [], [], []
    if sbp is not None:
        for bs, bd, ew, es, anc in zip(sbp.buckets, dbp.buckets,
                                       state.err_w, state.err_s,
                                       state.anchor):
            lo_s, lo_d = bs.layout, bd.layout
            new_ew.append(None if ew is None
                          else _reshard_err_w(ew, lo_s, lo_d, ctx))
            new_es.append(None if es is None
                          else _reshard_err_s(es, lo_s, lo_d))
            new_anchor.append(None if anc is None
                              else ctx.carry(anc, _remap_fn(lo_s, lo_d)))
    else:
        for i, (ew, es, anc) in enumerate(zip(state.err_w, state.err_s,
                                              state.anchor)):
            lo_s, lo_d = src.layouts[i], dst.layouts[i]
            new_ew.append(None if ew is None
                          else _reshard_err_w(ew, lo_s, lo_d, ctx))
            new_es.append(None if es is None
                          else _reshard_err_s(es, lo_s, lo_d))
            # per-leaf anchors are natural-shaped: width-independent
            new_anchor.append(None if anc is None else ctx.carry(anc))

    return CompressedDPState(
        step=state.step, gamma_acc=state.gamma_acc,
        sync_pstate=state.sync_pstate, var_pstate=state.var_pstate,
        slots=new_slots, u=new_u, err_w=new_ew, err_s=new_es,
        anchor=new_anchor)


def reshard_trainer(src_tr, dst_tr, params, state, *, survivors=None):
    """Reshard stacked (params, state) from one Trainer's width to
    another's. DP params carry per worker (joiners clone a survivor and
    re-converge bitwise at the next re-anchoring); EP params merge their
    expert axis and split it again over the new fleet."""
    n, m = src_tr.opt.n, dst_tr.opt.n
    ctx = _Ctx(src_tr.opt, dst_tr.opt, survivors)
    plan = src_tr.opt.plan
    # a trainer of a model without experts may come as its bare optimizer
    axes = getattr(src_tr, "ep_leaf_axes", {})
    params_m = unflatten_tree(plan.paths, [
        _ep_reshard(x, i, axes[i], n, m, "param") if i in axes
        else ctx.carry(x) for i, x in enumerate(plan.flat(params))])
    state_m = reshard(state, src_tr.opt, dst_tr.opt, survivors=survivors,
                      ep_axes=axes)
    return params_m, state_m


def resize_opt(opt: ComposedOptimizer, m: int) -> ComposedOptimizer:
    """Rebind a composed optimizer's unbound transform at a new worker
    count (same parameter tree, specs and dp_mask)."""
    _require_composed(opt, "source")
    plan = opt.plan
    return opt.cfg(unflatten_tree(plan.paths, list(plan.shapes)),
                   specs=unflatten_tree(plan.paths, list(plan.specs)),
                   dp_mask=unflatten_tree(plan.paths, list(plan.dp_mask)),
                   n_workers=m)


def reshard_report(src: ComposedOptimizer, dst: ComposedOptimizer, *,
                   survivors=None) -> dict:
    """Static geometry of one resize — pure function of the two plans, no
    tensors touched (the reference's keys and types)."""
    _require_composed(src, "source")
    _require_composed(dst, "destination")
    _validate_pair(src, dst)
    ctx = _Ctx(src, dst, survivors)
    src_units = list(src.units)
    dst_units = list(dst.units)
    true_elems = sum(C.true_counts(u.layout)[0] for u in src_units)
    return {
        "n_from": src.n, "n_to": dst.n,
        "inner_from": ctx.ni_s, "inner_to": ctx.ni_d,
        "entities_from": ctx.n_e, "entities_to": ctx.m_e,
        "carried_entities": len(ctx.carried_e),
        "dead_entities": len(ctx.dead_e),
        "joiner_workers": len(ctx.joiners),
        "ef_fold": bool(ctx.fold),
        "dp_leaves": sum(1 for dp in src.plan.dp_mask if dp),
        "exchange_units": len(src_units),
        "true_elems": int(true_elems),
        "padded_elems_from": int(sum(u.layout.padded for u in src_units)),
        "padded_elems_to": int(sum(u.layout.padded for u in dst_units)),
    }
