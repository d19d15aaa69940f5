"""Fused communication buckets for the Algorithm-2 exchange, PyTorch port
of ``src/repro/core/bucketing.py``.

The per-leaf exchange makes one encode and one pair of collectives per
parameter leaf. A bucket plan coalesces leaves into fixed-budget
(``bucket_mb``) flat buckets, so EF state, anchors, codec payloads and
collectives run per *bucket* (an exchange unit).

A fused bucket repacks its members' true (unpadded) elements
contiguously: member ``m`` occupies ``[offsets[m], offsets[m] +
sizes[m])`` of the bucket's flat order, and the single tail pads to the
``n * 128`` quantum. Every bucket is then an ordinary flatten
:class:`~repro_torch.core.compressor.LeafLayout`, so the codecs and the
kernels take it unchanged; a bucket of one leaf has that leaf's own
padded size, view shape and true counts, which makes the
one-leaf-per-bucket plan bitwise the per-leaf path.

Only unsharded flatten leaves fuse (:func:`fusable`); every other DP leaf
becomes a singleton bucket that keeps its own layout and vspec. One dtype
per bucket: the port's parameter trees hold one dtype (the model's
``param_dtype``), so the fuse key reduces to the layout's. Sharded fused
buckets (``rest_factor > 1``) belong to tensor parallelism, which the
port does not run yet.

Tensors here carry the stack of workers on dim 0: a member's view is
(stack, *view_shape), and each stacked worker's elements are gathered
and scattered separately.

Semantics: with multi-leaf buckets a "tensor" scale is one scale per
bucket and chunks mix member leaves; with one leaf per bucket the
numbers are the per-leaf ones, and the ``identity`` codec is exact
either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compressor as C

#: Packing / issue orders of the exchange units: ``flat`` is flat-leaf
#: order, ``reverse_backward`` its reverse (the last leaves of the flat
#: order are, to first approximation, the first whose gradients are final
#: in the backward pass).
PACK_ORDERS = ("flat", "reverse_backward")


def _check_pack_order(pack_order: str) -> None:
    if pack_order not in PACK_ORDERS:
        raise ValueError(
            f"pack_order must be one of {PACK_ORDERS}, got {pack_order!r}")


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One exchange unit: a fused repack of several flatten leaves or a
    singleton carrying one (possibly structured) leaf unchanged."""

    members: Tuple[int, ...]        # flat leaf indices, bucket order
    layout: C.LeafLayout            # comm layout of the bucket buffer
    fused: bool                     # True -> flat repack of true elements
    offsets: Tuple[int, ...]        # per-member start in bucket flat order
    sizes: Tuple[int, ...]          # per-member true element count
    spec: Any                       # the leaf's own spec for singletons,
                                    # None for fused buckets
    vspec: Tuple                    # spec entries of the bucket view shape

    @property
    def true_elems(self) -> int:
        return int(sum(self.sizes))


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static bucket assignment for one :class:`LeafPlan`."""

    bucket_mb: float
    buckets: Tuple[Bucket, ...]
    leaf_bucket: Tuple[Optional[int], ...]   # flat leaf idx -> bucket idx
                                             # (None for non-DP leaves)

    @property
    def n_fused(self) -> int:
        return sum(1 for b in self.buckets if b.fused)


def _true_size(layout: C.LeafLayout) -> int:
    return int(np.prod(layout.shape)) if layout.shape else 1


def view_spec_entries(layout: C.LeafLayout, spec) -> Tuple:
    """Spec entries of a comm view without tensor parallelism: a flatten
    view is replicated; a structured view (n, A/n, *rest) keeps the
    leaf's entries off the split axis."""
    if layout.flatten:
        return (None,) * len(layout.view_shape)
    entries = tuple(spec) if spec is not None else ()
    entries = entries + (None,) * (len(layout.shape) - len(entries))
    rest = tuple(e for a, e in enumerate(entries) if a != layout.split_axis)
    return (None, None, *rest)


def fusable(layout: C.LeafLayout, vspec) -> bool:
    """Whether a leaf's comm view may be repacked into a fused bucket: a
    flatten view (repacking reassigns elements to chunk rows), unsharded
    (``rest_factor == 1``, trivial vspec). A tensor-parallel shard
    (``rest_factor > 1``) qualifies with the canonical ``(None, ax)``
    vspec, as in the reference; :func:`make_bucket_plan` then raises,
    since the port has no tensor parallelism."""
    if not layout.flatten:
        return False
    if layout.rest_factor == 1:
        return vspec is None or all(e is None for e in tuple(vspec))
    if vspec is None:
        return False
    ent = tuple(vspec)
    return len(ent) == 2 and ent[0] is None and ent[1] is not None


def make_bucket_plan(plan, bucket_mb: float, vspecs=None,
                     pack_order: str = "flat") -> BucketPlan:
    """Greedy in-order packing of the plan's DP leaves into buckets.

    ``bucket_mb`` is the f32 element budget per fused bucket; a leaf
    larger than the budget still gets its own (fused) bucket, so the
    budget bounds fusion and never splits a leaf. Packing follows
    ``pack_order`` and is deterministic: the plan, and with it the
    optimizer state's layout, is a pure function of (shapes, specs, n,
    bucket_mb, pack_order)."""
    if bucket_mb is None or bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be positive, got {bucket_mb!r}")
    _check_pack_order(pack_order)
    if vspecs is None:
        vspecs = [view_spec_entries(lo, sp)
                  for lo, sp in zip(plan.layouts, plan.specs)]
    budget = max(1, int(float(bucket_mb) * 2**20) // 4)
    n_inner = plan.hierarchy.inner if plan.hierarchy else 1

    buckets: List[Bucket] = []
    leaf_bucket: List[Optional[int]] = [None] * len(plan.layouts)
    pend: List[int] = []        # member leaf indices of the open fused bucket
    pend_elems = 0

    def _fuse_key(i):
        """(rest_factor, vspec): leaves fuse only within one key (the
        reference's key also holds the dtype, uniform here)."""
        lo = plan.layouts[i]
        return (lo.rest_factor, tuple(vspecs[i]) if lo.rest_factor > 1
                else None)

    def close_fused():
        nonlocal pend, pend_elems
        if not pend:
            return
        sizes = tuple(_true_size(plan.layouts[i]) for i in pend)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        if plan.layouts[pend[0]].rest_factor > 1:
            raise NotImplementedError(
                "sharded fused buckets (rest_factor > 1) need tensor "
                "parallelism, which the port does not run yet (ROADMAP "
                "queue item 3)")
        lo = C.make_layout((off,), None, plan.n, n_inner=n_inner)
        bi = len(buckets)
        buckets.append(Bucket(members=tuple(pend), layout=lo, fused=True,
                              offsets=tuple(offsets), sizes=sizes,
                              spec=None,
                              vspec=(None,) * len(lo.view_shape)))
        for i in pend:
            leaf_bucket[i] = bi
        pend, pend_elems = [], 0

    order = range(len(plan.layouts))
    if pack_order == "reverse_backward":
        order = reversed(order)
    for i in order:
        lo, dp = plan.layouts[i], plan.dp_mask[i]
        if not dp:
            continue
        if not fusable(lo, vspecs[i]):
            close_fused()
            bi = len(buckets)
            buckets.append(Bucket(
                members=(i,), layout=lo, fused=False,
                offsets=(0,), sizes=(_true_size(lo),),
                spec=plan.specs[i], vspec=tuple(vspecs[i])))
            leaf_bucket[i] = bi
            continue
        size = _true_size(lo)
        key = _fuse_key(i)
        pend_key = _fuse_key(pend[0]) if pend else None
        if pend and (pend_elems + size > budget or key != pend_key):
            close_fused()
        pend.append(i)
        pend_elems += size
        if pend_elems >= budget:
            close_fused()
    close_fused()
    return BucketPlan(bucket_mb=float(bucket_mb), buckets=tuple(buckets),
                      leaf_bucket=tuple(leaf_bucket))


# ---------------------------------------------------------------------------
# view <-> bucket transport (exact inverses on the true elements)
# ---------------------------------------------------------------------------

def gather_views(bucket: Bucket, views: List[torch.Tensor]) -> torch.Tensor:
    """Member comm views (stack, *view_shape) -> the bucket buffer (stack,
    *bucket view shape).

    A fused bucket takes each stacked worker's true elements of each
    member (dropping the member's pad tail), concatenates them in member
    order and zero-pads the bucket's single tail, so pad garbage in a
    member view never reaches the wire. Singletons pass through."""
    if not bucket.fused:
        (v,) = views
        return v
    stack = views[0].shape[0]
    parts = [v.reshape(stack, -1)[:, :s] for v, s in zip(views, bucket.sizes)]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    pad = bucket.layout.padded - bucket.true_elems
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape((stack,) + bucket.layout.view_shape)


def scatter_views(bucket: Bucket, buf: torch.Tensor,
                  layouts: List[C.LeafLayout]) -> List[torch.Tensor]:
    """Bucket buffer -> member comm views (stack, *view_shape), the exact
    inverse of :func:`gather_views` on the true elements, re-padded with
    zeros."""
    if not bucket.fused:
        return [buf]
    stack = buf.shape[0]
    flat = buf.reshape(stack, -1)
    out = []
    for off, size, lo in zip(bucket.offsets, bucket.sizes, layouts):
        seg = flat[:, off:off + size]
        if lo.pad:
            seg = torch.nn.functional.pad(seg, (0, lo.pad))
        out.append(seg.reshape((stack,) + lo.view_shape))
    return out


def bucket_accounting(plan: BucketPlan) -> dict:
    """Static counts: exchange units and true-element conservation
    (bucket sum == leaf sum)."""
    return {
        "n_buckets": len(plan.buckets),
        "n_fused": plan.n_fused,
        "true_elems": sum(b.true_elems for b in plan.buckets),
        "padded_elems": sum(b.layout.padded for b in plan.buckets),
    }


def member_units(units) -> Dict[int, int]:
    """Flat leaf index -> the position of its exchange unit in issue
    order, for ``units`` given as each unit's members (a bucket's, or a
    DP leaf's own): the map a per-unit scheduler counts gradients down
    on, a unit being ready once all its members are. (With a bucket plan
    in its own order, the position is ``BucketPlan.leaf_bucket``.)"""
    return {i: k for k, members in enumerate(units) for i in members}


def exchange_units(plan, bucket_plan: Optional[BucketPlan] = None,
                   pack_order: str = "flat"
                   ) -> List[Tuple[C.LeafLayout, Any, str]]:
    """``(layout, vspec, label)`` per exchange unit, in issue order:
    buckets when a bucket plan is set (its order already follows its
    ``pack_order``), the DP leaves in ``pack_order`` otherwise: the
    iteration order of ``ComposedOptimizer``'s per-unit loop."""
    _check_pack_order(pack_order)
    if bucket_plan is not None:
        return [(b.layout, b.vspec, f"bucket[{k}]")
                for k, b in enumerate(bucket_plan.buckets)]
    idx = [i for i, dp in enumerate(plan.dp_mask) if dp]
    if pack_order == "reverse_backward":
        idx = idx[::-1]
    return [(plan.layouts[i],
             view_spec_entries(plan.layouts[i], plan.specs[i]),
             f"leaf[{i}]") for i in idx]


# ---------------------------------------------------------------------------
# Declared collective schedule (the manifest repro_torch.analysis.ir_audit
# holds a step's recorded collectives to)
# ---------------------------------------------------------------------------

def dtype_name(dtype) -> str:
    """Canonical name of a torch dtype ("float32", "bfloat16", "uint8"),
    the reference's ``np.dtype(...).name`` of the same type."""
    return str(dtype).rsplit(".", 1)[-1]


class ExpectedCollective(NamedTuple):
    """One declared collective of the exchange schedule.

    ``level`` names a topology level: ``flat`` (the worker comm),
    ``inner`` (the pod) or ``outer`` (across pods), the level of the comm
    the exchange issues it on. ``shape``/``dtype`` describe one worker's
    operand as the reference declares it (``ir_audit.RecordingComm``
    records the port's under the same convention)."""

    op: str                   # "all_to_all" | "all_gather"
    level: str                # "flat" | "inner" | "outer"
    phase: str                # "reduce_scatter" | "scatter" | "gather"
    round: str                #   | "broadcast";  round: "sync" | "fullprec"
    unit: int                 # exchange-unit ordinal (bucket / DP leaf)
    unit_label: str           # "bucket[k]" or "leaf[i]"
    leaf: str                 # payload leaf name, "raw" for uncompressed
    dtype: str                # canonical dtype name of the operand
    shape: Tuple[int, ...]    # operand shape of one worker

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * getattr(
            torch, self.dtype).itemsize

    @property
    def inter_pod(self) -> bool:
        return self.level == "outer"


def _payload_shapes(layout: C.LeafLayout, ar_cfg):
    """(worker payload, server payload) of one exchange unit, each a dict
    of one worker's leaf shapes in the payload's own (emission) order,
    derived by running the exchange's real encode helpers
    (``codec.encode_worker``, ``decode_mean``, ``encode_server``) on
    ``meta`` tensors of a stack of one: nothing is computed or allocated,
    and the manifest's shapes cannot drift from what is sent."""
    hier = ar_cfg.hierarchy is not None
    codec, mode = ar_cfg.codec, ar_cfg.scale_mode
    meta = torch.device("meta")

    def empty(shape):
        return torch.empty((1,) + tuple(shape), dtype=torch.float32,
                           device=meta)

    zero = np.zeros(1, dtype=np.int64)
    z = empty(layout.slice_shape if hier else layout.view_shape)
    ew = empty(layout.ef_worker_shape) if codec.needs_ef else None
    es = empty(layout.chunk_shape) if codec.needs_ef else None
    payload, _ = codec.encode_worker(z, ew, layout, mode,
                                     inner_index=zero if hier else None)
    avg = codec.decode_mean(payload, layout)
    payload_s, _ = codec.encode_server(avg, es, layout, mode, zero)
    return ({k: tuple(v.shape[1:]) for k, v in payload.items()},
            {k: tuple(v.shape[1:]) for k, v in payload_s.items()})


def _unit_payload_entries(unit, label, layout, ar_cfg):
    """Per-unit (scatter entries, gather entries) of the compressed
    exchange: shapes from the encode helpers (:func:`_payload_shapes`),
    dtypes from the codec's *declared* ``payload_spec``, whose leaf names
    must be the payload's, in its order."""
    codec = ar_cfg.codec
    level = "outer" if ar_cfg.hierarchy is not None else "flat"
    wp, sp = _payload_shapes(layout, ar_cfg)
    spec = codec.payload_spec(layout)
    out = {}
    for phase, tree in (("scatter", wp), ("gather", sp)):
        declared = tuple(spec[phase])
        if tuple(n for n, _ in declared) != tuple(tree):
            raise ValueError(
                f"codec {codec.name!r} payload_spec names "
                f"{[n for n, _ in declared]} != the payload's leaves "
                f"{list(tree)} ({phase} phase, {label})")
        op = "all_to_all" if phase == "scatter" else "all_gather"
        out[phase] = [
            ExpectedCollective(op, level, phase, "sync", unit, label, name,
                               dtype_name(dt), tree[name])
            for name, dt in declared]
    return out["scatter"], out["gather"]


def _hier_raw_entries(unit, label, layout, ar_cfg):
    """(intra-pod reduce-scatter, intra-pod broadcast) entries of the
    two-level sync: the uncompressed phases at the wire dtype."""
    ni, no, ck = layout.n_inner, layout.n_outer, layout.chunk_shape
    cd = dtype_name(ar_cfg.comm_dtype)
    rs = ExpectedCollective("all_to_all", "inner", "reduce_scatter", "sync",
                            unit, label, "raw", cd, (ni, no) + ck)
    bc = ExpectedCollective("all_gather", "inner", "broadcast", "sync",
                            unit, label, "raw", cd, (1, no) + ck)
    return rs, bc


def expected_sync_schedule(plan, ar_cfg,
                           bucket_plan: Optional[BucketPlan] = None,
                           pack_order: str = "flat"
                           ) -> List[ExpectedCollective]:
    """The declared collectives of ONE compressed (Algorithm-2) sync
    round: one contiguous block per exchange unit, in issue order. Flat:
    ``[scatter, gather]`` (one collective per payload leaf each); two
    levels: ``[intra-pod reduce-scatter, inter-pod scatter, inter-pod
    gather, intra-pod broadcast]``."""
    units = exchange_units(plan, bucket_plan, pack_order)
    hier = ar_cfg.hierarchy is not None
    out: List[ExpectedCollective] = []
    for u, (lo, _, label) in enumerate(units):
        sc, ga = _unit_payload_entries(u, label, lo, ar_cfg)
        raw = (_hier_raw_entries(u, label, lo, ar_cfg)
               if hier and lo.n_inner > 1 else None)
        if raw:
            out.append(raw[0])
        out += sc + ga
        if raw:
            out.append(raw[1])
    return out


def expected_fullprec_schedule(plan, ar_cfg,
                               bucket_plan: Optional[BucketPlan] = None,
                               pack_order: str = "flat"
                               ) -> List[ExpectedCollective]:
    """The declared collectives of ONE full-precision (T_v / mean) round:
    ``onebit_allreduce.fullprec_allreduce_view`` per exchange unit, in
    issue order."""
    units = exchange_units(plan, bucket_plan, pack_order)
    cd = dtype_name(ar_cfg.comm_dtype)
    hier = ar_cfg.hierarchy is not None
    out: List[ExpectedCollective] = []
    for u, (lo, _, label) in enumerate(units):
        ck = lo.chunk_shape

        def entry(op, level, phase, shape):
            return ExpectedCollective(op, level, phase, "fullprec", u, label,
                                      "raw", cd, tuple(shape))

        if hier and lo.n_inner > 1:
            ni, no = lo.n_inner, lo.n_outer
            out += [entry("all_to_all", "inner", "reduce_scatter",
                          (ni, no) + ck),
                    entry("all_to_all", "outer", "scatter", (no,) + ck),
                    entry("all_gather", "outer", "gather", (1,) + ck),
                    entry("all_gather", "inner", "broadcast",
                          (1, no) + ck)]
        else:
            out += [entry("all_to_all", "flat", "scatter", lo.view_shape),
                    entry("all_gather", "flat", "gather", (1,) + ck)]
    return out
