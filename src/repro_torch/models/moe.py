"""Mixture of experts with expert parallelism, PyTorch port of
``src/repro/models/moe.py``.

Experts are split over the workers (``E`` divisible by the expert-parallel
degree n; each worker owns ``E/n`` of them). Tokens are dispatched by a
sort/scatter capacity router: each expert takes at most ``capacity`` of
a worker's token assignments, ``ceil(capacity_factor * T * top_k / E)``
for a worker's ``T`` tokens, the rest are dropped (they pass through the
layer on the residual alone). Expert leaves are ``dp=False``: each exists
once across the workers, so the optimizer gives them its plain local
step and no data-parallel exchange.

Three regimes, one code path:

* ``comm=None``, the experts all local (single worker, or a worker of the
  simulator, below): no exchange.
* **The simulator** (``SimComm``: ``Trainer.grads`` runs the stacked
  workers one after another, so no collective can span workers inside a
  forward). Each worker's forward runs with ``comm=None`` against the
  *merged* experts, the stacked expert leaf ``(n, E/n, ...)`` seen as
  ``(E, ...)``. The exchange only moves buffer rows between workers, and
  the expert FFN acts row by row, so each token meets the same expert
  weights under the same per-worker capacity drops as under the
  reference's ``all_to_all``. Summing each worker's gradient of the
  merged experts gives what the exchange's transpose sums (in another
  order: a few ulp).
* **Processes** (``DistComm``): ``comm`` is the expert-parallel comm, and
  a real ``all_to_all`` moves the dispatch buffer to the experts' owners
  and their outputs back, inside an autograd function whose backward is
  the reverse exchange through the same comm (so a recording comm logs
  both directions of both passes).

Serving routes a decode batch either over the whole batch (the
reference's engine) or, with ``groups``, each slot's token alone (the
reference's Scheduler, whose ``vmap`` decodes one slot at a time): one
batched pass either way.

The router's top-k follows ``jax.lax.top_k``'s order on ties
(``codecs.top_k_indices``); the combine sums each token's ``top_k``
weighted expert outputs with ``index_add_``, whose order may differ from
XLA's scatter-add in the last ulp for ``top_k > 2``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.codecs import top_k_indices
from repro_torch.models.layers import PD, model_dim_spec


def moe_template(d, d_ff, n_experts, n_shared, ep_workers, stack=None):
    """Router, expert and shared-expert params. ``ep_workers``: the
    expert-parallel degree (1: no EP, the experts are data-parallel
    leaves like any other)."""
    ffs = model_dim_spec(d_ff)
    ep = ep_workers > 1

    def st(shape, spec):
        if stack is None:
            return shape, spec
        return (stack, *shape), (None, *spec)

    sg, pg = st((n_experts, d, d_ff), (None, None, ffs))
    sd_, pd_ = st((n_experts, d_ff, d), (None, ffs, None))
    e_ax = None if not ep else (0 if stack is None else 1)
    sr, pr = st((d, n_experts), (None, None))
    t = {"router": PD(sr, spec=pr),
         "w_gate": PD(sg, spec=pg, dp=not ep, ep_axis=e_ax),
         "w_up": PD(sg, spec=pg, dp=not ep, ep_axis=e_ax),
         "w_down": PD(sd_, spec=pd_, dp=not ep, ep_axis=e_ax)}
    if n_shared:
        ssg, spg = st((d, n_shared * d_ff), (None, ffs))
        ssd, spd = st((n_shared * d_ff, d), (ffs, None))
        t["shared_gate"] = PD(ssg, spec=spg)
        t["shared_up"] = PD(ssg, spec=spg)
        t["shared_down"] = PD(ssd, spec=spd)
    return t


def _dispatch_indices(eids, n_experts, capacity):
    """For flat expert ids (T,), the slot each assignment takes in its
    expert's buffer, in token order (slots >= capacity drop): a stable
    sort, then each id's position within its run."""
    T = eids.shape[0]
    order = torch.argsort(eids, stable=True)
    sorted_eids = eids[order]
    first = torch.searchsorted(sorted_eids, sorted_eids, side="left")
    pos_sorted = (torch.arange(T, dtype=torch.int32, device=eids.device)
                  - first.to(torch.int32))
    pos = torch.zeros((T,), dtype=torch.int32, device=eids.device)
    pos[order] = pos_sorted
    return pos


class _EPExchange(torch.autograd.Function):
    """The expert-parallel ``all_to_all`` of one worker's (n, ...) buffer:
    block j goes to worker j. Its transpose is the same exchange, so the
    backward sends each gradient block back to the worker it came from."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.ep_all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.ep_all_to_all(g.contiguous()), None


def moe_forward(p, x, *, top_k, n_experts, capacity_factor, comm=None,
                groups=1):
    """x (B, S, d) -> (out (B, S, d), {"aux_loss", "dropped_frac"}).
    ``comm``: the expert-parallel comm of a process (None: every expert
    in ``p`` is local).

    ``groups``: the rows split into that many routing groups of ``B /
    groups`` rows each (``groups=B``: a row each), each routed as if
    alone, as the reference's Scheduler routes each slot inside its
    ``vmap``: its own capacity ``max(1, ceil(capacity_factor * T_g *
    top_k / E))`` over its ``T_g`` tokens, its own dispatch order and
    its own part of every expert's buffer, all in one batched pass (the
    experts' rows laid out (E, groups * C_g, d)). The aux loss is then
    the mean of the groups' own. Only with ``comm=None``."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    n = comm.size() if comm is not None else 1
    G = groups
    if B % G:
        raise ValueError(f"{B} rows do not split into {G} routing groups")
    if G > 1 and comm is not None:
        raise ValueError("routing groups are a single-process decode's "
                         "(comm=None)")
    Tg = T // G

    logits = (xf @ p["router"]).to(torch.float32)            # (T, E)
    gates_full = torch.softmax(logits, dim=-1)
    topi = top_k_indices(gates_full, top_k)                   # (T, k)
    topv = gates_full.gather(1, topi)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e, per group
    me = gates_full.view(G, Tg, n_experts).mean(dim=1)        # (G, E)
    gid = torch.arange(G, device=x.device).repeat_interleave(Tg * top_k)
    ce = torch.zeros((G * n_experts,), dtype=torch.float32,
                     device=x.device).index_add_(
        0, gid * n_experts + topi.reshape(-1),
        torch.full((T * top_k,), 1.0 / (Tg * top_k), dtype=torch.float32,
                   device=x.device)).view(G, n_experts)
    aux_loss = (n_experts * torch.sum(me * ce, dim=1)).mean()

    capacity = int(max(1, -(-int(capacity_factor * Tg * top_k)
                            // n_experts)))
    eids = topi.reshape(-1)                                   # (T*k,)
    gvals = topv.reshape(-1)
    # a group's run of an expert id is its run of (group, expert)
    slot = _dispatch_indices(gid * n_experts + eids, G * n_experts,
                             capacity)
    keep = slot < capacity
    # dropped assignments go to a spare slot past the capacity, cut off
    drop_slot = torch.where(keep, slot, capacity).to(torch.int64)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(top_k)
    flat = (eids * G + gid) * (capacity + 1) + drop_slot
    buf = torch.zeros((n_experts * G * (capacity + 1), d), dtype=x.dtype,
                      device=x.device).index_put((flat,), xf[tok_idx])
    buf = buf.view(n_experts, G, capacity + 1, d)[:, :, :capacity].reshape(
        n_experts, G * capacity, d)

    if n > 1:
        # (E, C, d) -> (n, E_local, C, d) -> exchange -> (E_local, n*C, d)
        e_local = n_experts // n
        recv = _EPExchange.apply(
            buf.reshape(n, e_local, capacity, d).contiguous(), comm)
        ein = recv.movedim(0, 1).reshape(e_local, n * capacity, d)
    else:
        ein = buf

    h = torch.einsum("ecd,edf->ecf", ein, p["w_gate"])
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", ein, p["w_up"])
    eout = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    if n > 1:
        back = eout.reshape(e_local, n, capacity, d).movedim(1, 0)
        outbuf = _EPExchange.apply(back.contiguous(), comm).reshape(
            n_experts, capacity, d)
    else:
        outbuf = eout

    # combine: each assignment's expert output, weighted, summed per token
    safe_slot = torch.clamp(drop_slot, max=capacity - 1)
    y = outbuf.view(n_experts * G, capacity, d)[eids * G + gid, safe_slot]
    y = y * (gvals * keep.to(gvals.dtype))[:, None].to(y.dtype)
    out = torch.zeros((T, d), dtype=y.dtype, device=x.device).index_add(
        0, tok_idx, y)

    if "shared_gate" in p:
        sh = F.silu(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        out = out + sh @ p["shared_down"]

    metrics = {"aux_loss": aux_loss,
               "dropped_frac": 1.0 - keep.to(torch.float32).mean()}
    return out.reshape(B, S, d), metrics
