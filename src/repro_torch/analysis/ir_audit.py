"""Communication audit of the port's train step, PyTorch port of
``src/repro/analysis/ir_audit.py``.

The repo's headline numbers (the codec's inter-pod volume, the collective
count per sync, the hierarchy's routing) are declared analytically:
``comm_accounting``, ``codec.wire_bytes``, and the manifests of
``core.bucketing`` (``expected_sync_schedule`` /
``expected_fullprec_schedule``). The reference checks them against the
jaxpr of its per-worker step, traced over an abstract mesh. Eager PyTorch
has no IR and no trace, so the port **records what its step actually
issues**: :class:`RecordingComm` wraps the comm a
:class:`~repro_torch.train.step.Trainer` runs on (``SimComm``,
``SimLevelComm``, ``DistComm``, ``NullComm``) and logs every collective
of every real step, which the checks then hold to the declared contract:

1. **Schedule** (:func:`check_schedule`): the payload-sized collectives
   of each step must be an ordered interleaving of whole unit blocks of
   the sync manifest and of the fullprec manifest (one block per
   exchange unit: one collective per payload leaf and phase, plus the
   two intra-pod phases with pods), op, level, dtype and shape equal. A
   step that ran a round consumes that manifest whole; a step that did
   not consumes none of it. Reductions of at most 64 elements a worker
   (the loss ``pmean``) are allowed anywhere, and so are a MoE model's
   expert-parallel exchanges (recorded at the ``ep`` level) and its
   expert gradients' replica mean (``ep_residual``), the reference's
   allowances (:func:`allowance`); any other collective is a
   violation, ``interpod-bytes`` where it crosses the inter-pod level
   wider than 8 bits an element. The reference sees both branches of
   each ``cond`` in one trace; the port sees the rounds its run takes, so
   an audit must run every round its style declares (sync, fullprec, and
   local-only steps in the accumulate style), else ``schedule``: "round
   never ran".
2. **Wire bytes** (:func:`check_wire_bytes`): each unit's declared
   scatter and gather bytes against ``codec.wire_bytes``, within 4 bytes
   a chunk, as in the reference; and, the port's own check, the bytes the
   recorded collectives of each round send, summed over the units, per
   level, against ``comm_accounting``. A worker sends ``(g-1)/g`` of an
   ``all_to_all`` operand (its own block stays) and its ``all_gather``
   operand ``g-1`` times, ``g`` the size of the level's group. With that
   rule every level is equal to ``comm_accounting``'s
   (``compressed_bytes_per_sync_inner``/``_outer``,
   ``fullprec_bytes_per_round_inner``/``_outer``; a flat exchange is the
   ``_outer`` level), and so is every headline but one: a flat
   full-precision round's ``fullprec_bytes_per_round`` counts the
   ``(n-1)/n`` ring over the true parameters, ``F = 2 (n-1)/n P_true w``,
   where the wire carries the padded views, ``S = 2 (n-1)/n P_padded w``;
   so ``F = S P_true / P_padded``, checked as ``S n == 2 (n-1) P_padded
   w`` and ``F == 2 (n-1)/n P_true w``.
3. **Dtype discipline** (:func:`check_dtypes`): no float64 operand among
   the recorded collectives and no float64 leaf in the optimizer state
   after the audited steps. The reference's ``weak-type`` code has no
   counterpart: a torch tensor has no weak type.

**One shape rule.** A worker's operand is recorded as the collective's
operand without the stack dim (``x.shape[1:]``), so that a simulated
stack of n workers and a process's stack of one log alike. The
reference's intra-pod broadcasts gather ``x[None]`` (a leading unit dim)
where the port's ``all_gather`` concatenates along its first per-worker
dim; so an ``all_gather`` on the ``inner`` level is recorded with a
leading 1, ``(m, *rest) -> (1, m, *rest)``. It touches the ``broadcast``
entries of both manifests and nothing else.

Entry point: :func:`audit_trainer`. The building blocks
(:func:`trace_collectives`, :func:`build_manifests`,
:func:`concretize_manifest`, :func:`check_schedule`) are public so that
tests can seed violations into any single stage; :func:`watch` records
the steps of a run driven by someone else (``launch.train``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch.checkpointing import io as ckpt_io
from repro_torch.core import bucketing as BK
from repro_torch.core.comm import Comm

# reductions of at most this many elements a worker are control/metric
# scalars (the loss pmean) and allowed anywhere
_SMALL_ELEMS = 64
_REDUCTIONS = ("psum", "pmean")
_PAYLOAD_OPS = ("all_to_all", "all_gather")
LOCAL_ONLY = "local-only"


@dataclasses.dataclass(frozen=True)
class RecordedCollective:
    """One collective a step issued, as one worker sees it."""

    op: str                    # psum | pmean | all_gather | all_to_all
    level: str                 # flat | inner | outer
    dtype: str                 # operand dtype name
    shape: Tuple[int, ...]     # one worker's operand (the shape rule)
    elems: int                 # elements of that operand
    nbytes: int                # its bytes
    group: int                 # workers in the level's group
    position: int              # issue order within its step
    step: int                  # audited step (-1: before the first)

    @property
    def sent_bytes(self) -> int:
        """Bytes this worker sends: an all_to_all keeps its own block, an
        all_gather sends its operand to each of the others, a reduction
        counts as a ring all-reduce."""
        g = self.group
        if self.op == "all_to_all":
            return self.nbytes * (g - 1) // g
        if self.op == "all_gather":
            return self.nbytes * (g - 1)
        return 2 * self.nbytes * (g - 1) // g

    def describe(self) -> str:
        return (f"{self.op} on {self.level} {self.dtype}{self.shape} "
                f"(position {self.position} of step {self.step})")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Violation:
    code: str      # "schedule" | "undeclared-collective" | "interpod-bytes"
    #              # | "payload-dtype" | "wire-bytes" | "f64"
    message: str

    def to_dict(self):
        return {"code": self.code, "message": self.message}


@dataclasses.dataclass
class AuditReport:
    ok: bool
    violations: List[Violation]
    collectives: List[RecordedCollective]
    summary: Dict[str, Any]

    def to_dict(self):
        return {
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
            "n_collectives": len(self.collectives),
            "summary": self.summary,
        }

    def to_json(self, **kw):
        return json.dumps(self.to_dict(), **kw)


class _Book:
    """The log shared by a recording comm and the levels of its split."""

    def __init__(self):
        self.entries: List[RecordedCollective] = []
        self.step = -1
        self.position = 0

    def start_step(self, step: int):
        self.step, self.position = step, 0

    def add(self, op, level, x: torch.Tensor, group: int):
        shape = tuple(int(s) for s in x.shape[1:])
        if op == "all_gather" and level == "inner":
            shape = (1,) + shape            # the module's one shape rule
        elems = int(np.prod(shape, dtype=np.int64))
        self.entries.append(RecordedCollective(
            op, level, BK.dtype_name(x.dtype), shape, elems,
            elems * x.element_size(), group, self.position, self.step))
        self.position += 1


class RecordingComm(Comm):
    """A comm that logs every collective it passes on to ``comm`` (op,
    level, dtype, one worker's operand shape, elements, bytes, position
    and step) and returns ``comm``'s own result, so that a run's outputs
    stay bit for bit; an asynchronous collective is recorded alike, when
    it is issued. :meth:`split` returns recording ``(outer, inner)``
    comms tagged ``"outer"``/``"inner"``, made once per pod size (the
    trainer and the exchange both split), logging into the same book;
    they record by level even where the wrapped split hands back the
    world comm itself (``DistComm.split(1)``)."""

    def __init__(self, comm: Comm, level: str = "flat", _book=None):
        self.comm = comm
        self.level = level
        self.book = _Book() if _book is None else _book
        self._levels = {}

    @property
    def log(self) -> List[RecordedCollective]:
        return self.book.entries

    def size(self) -> int:
        return self.comm.size()

    def index(self) -> np.ndarray:
        return self.comm.index()

    def exchange_ms(self):
        return self.comm.exchange_ms()

    def spans_processes(self) -> bool:
        return self.comm.spans_processes()

    def _rec(self, op, x):
        self.book.add(op, self.level, x, self.comm.size())

    def psum(self, x):
        self._rec("psum", x)
        return self.comm.psum(x)

    def pmean(self, x):
        self._rec("pmean", x)
        return self.comm.pmean(x)

    def all_gather(self, x):
        self._rec("all_gather", x)
        return self.comm.all_gather(x)

    def all_to_all(self, x):
        self._rec("all_to_all", x)
        return self.comm.all_to_all(x)

    def all_gather_async(self, x):
        """Recorded as :meth:`all_gather`, when it is issued."""
        self._rec("all_gather", x)
        return self.comm.all_gather_async(x)

    def all_to_all_async(self, x):
        """Recorded as :meth:`all_to_all`, when it is issued."""
        self._rec("all_to_all", x)
        return self.comm.all_to_all_async(x)

    def ep_all_to_all(self, x):
        """The expert-parallel exchange of one worker's buffer, recorded
        at the ``ep`` level (its operand has no stack dim)."""
        self.book.add("all_to_all", "ep", x[None], self.comm.size())
        return self.comm.ep_all_to_all(x)

    def ep_residual_mean(self, x):
        self.book.add("pmean", "ep_residual", x[None], self.comm.size())
        return self.comm.ep_residual_mean(x)

    def ep_ms(self):
        return self.comm.ep_ms()

    def split(self, inner: int):
        if inner not in self._levels:
            outer, pod = self.comm.split(inner)
            self._levels[inner] = (RecordingComm(outer, "outer", self.book),
                                   RecordingComm(pod, "inner", self.book))
        return self._levels[inner]


# ---------------------------------------------------------------------------
# recording real steps
# ---------------------------------------------------------------------------

def step_rounds(style: str, met) -> Tuple[str, ...]:
    """The exchange rounds one step of ``style`` ran, from its metrics:
    the accumulate style syncs on T_u steps and refreshes the variance on
    T_v steps (neither: a local-only step); the gradient style runs a
    full-precision round while its variance is refreshed, else the 1-bit
    one; the mean style a full-precision round every step."""
    if style == "mean":
        return ("fullprec",)
    if style == "gradient":
        return ("fullprec",) if met["var_round"] else ("sync",)
    return ((("sync",) if met["synced"] else ())
            + (("fullprec",) if met["var_round"] else ()))


def state_dtypes(state) -> List[Tuple[str, str]]:
    """(path, dtype name) of every leaf of an optimizer state, in the
    reference's layout and leaf paths (``interop.state_to_reference``)."""
    paths, leaves, _ = ckpt_io.flatten(interop.state_to_reference(state))
    return [(p, BK.dtype_name(x.dtype) if isinstance(x, torch.Tensor)
             else np.asarray(x).dtype.name) for p, x in zip(paths, leaves)]


@dataclasses.dataclass
class StepTrace:
    step: int
    rounds: Tuple[str, ...]               # () for a local-only step
    collectives: List[RecordedCollective]


@dataclasses.dataclass
class Trace:
    """What the recorder saw of a run: each audited step's rounds, the
    shared log, and the optimizer state's dtypes after the last step."""

    style: str
    book: _Book
    rounds: List[Tuple[str, ...]] = dataclasses.field(default_factory=list)
    state_dtypes: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)

    @property
    def collectives(self) -> List[RecordedCollective]:
        return list(self.book.entries)

    def steps(self) -> List[StepTrace]:
        by: Dict[int, List[RecordedCollective]] = {}
        for c in self.book.entries:
            by.setdefault(c.step, []).append(c)
        return [StepTrace(t, r, by.get(t, []))
                for t, r in enumerate(self.rounds)]

    def outside(self) -> List[RecordedCollective]:
        """Collectives recorded outside every audited step."""
        return [c for c in self.book.entries
                if not 0 <= c.step < len(self.rounds)]


def watch(trainer, wrap_step=None) -> Trace:
    """Record ``trainer``'s steps from now on: its comm is wrapped in a
    :class:`RecordingComm` where it is not one already (the exchange
    splits the comm it is given on every unit, so its levels record
    too), and ``trainer.step`` is wrapped so that each call opens a step
    of the log and notes the rounds it ran and the state's dtypes.
    Collectives issued between two steps (the loss ``pmean`` of a logged
    step) belong to the step before. Watching a watched trainer returns
    its trace. ``wrap_step`` (tests) wraps the step function first, to
    seed violations."""
    existing = getattr(trainer.step, "audit_trace", None)
    if existing is not None:
        return existing
    if not isinstance(trainer.comm, RecordingComm):
        trainer.comm = RecordingComm(trainer.comm)
    trace = Trace(style=trainer.opt.cfg.style, book=trainer.comm.book)
    step = trainer.step if wrap_step is None else wrap_step(trainer.step)

    def recorded(params, state, batch):
        trace.book.start_step(len(trace.rounds))
        params, state, met = step(params, state, batch)
        trace.rounds.append(step_rounds(trace.style, met))
        trace.state_dtypes = state_dtypes(state)
        return params, state, met

    recorded.audit_trace = trace
    trainer.step = recorded
    return trace


def trace_collectives(trainer, params, state, batches,
                      wrap_step=None) -> Trace:
    """Run ``trainer`` one real step per batch of ``batches`` from
    ``params``/``state``, each followed by the loss ``pmean`` a logged
    step of ``launch.train`` issues, and return what was recorded: per
    step, the collectives in issue order and the rounds the step ran."""
    trace = watch(trainer, wrap_step)
    for batch in batches:
        params, state, met = trainer.step(params, state, batch)
        trainer.mean_loss(met)
    return trace


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

def build_manifests(opt) -> Tuple[List[BK.ExpectedCollective],
                                  List[BK.ExpectedCollective]]:
    """(sync manifest, fullprec manifest) a composed optimizer declares,
    empty where its style never runs that round: the mean style has no
    compressed round; the accumulate style a full-precision one only
    where the base carries a variance."""
    cfg = opt.cfg
    sync = ([] if cfg.style == "mean" else BK.expected_sync_schedule(
        opt.plan, opt.ar_cfg, opt.bucket_plan, cfg.pack_order))
    has_fp = cfg.style in ("mean", "gradient") or opt.base.has_variance
    fullprec = (BK.expected_fullprec_schedule(
        opt.plan, opt.ar_cfg, opt.bucket_plan, cfg.pack_order)
        if has_fp else [])
    return sync, fullprec


@dataclasses.dataclass(frozen=True)
class ConcreteCollective:
    """A manifest entry resolved onto the trainer's levels: one recorded
    collective per entry (the port's comms issue one collective per
    level, where the reference's multi-axis gathers decompose)."""

    op: str
    level: str
    dtype: str
    shape: Tuple[int, ...]
    source: BK.ExpectedCollective

    def describe(self) -> str:
        s = self.source
        return (f"{self.op} on {self.level} {self.dtype}{self.shape} "
                f"[{s.round} {s.phase}, {s.unit_label}, leaf '{s.leaf}']")


def _concrete(entries) -> List[ConcreteCollective]:
    return [ConcreteCollective(e.op, e.level, e.dtype, tuple(e.shape), e)
            for e in entries]


def concretize_manifest(entries, trainer) -> List[ConcreteCollective]:
    levels = {"flat"} | ({"inner", "outer"} if trainer.hierarchy is not None
                         else set())
    for e in entries:
        if e.level not in levels:
            raise ValueError(f"manifest entry at level {e.level!r} but the "
                             f"trainer has levels {sorted(levels)}")
    return _concrete(entries)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def allowance(c: RecordedCollective) -> Optional[str]:
    """Why a collective outside the declared manifests is acceptable, or
    None, as the reference's ``_allowance``: a control/metric scalar
    reduction (the loss pmean); the expert-parallel token exchange of a
    MoE layer (recorded at the ``ep`` level, inside the forward and the
    backward); the mean of the expert gradients over their replicas
    (``ep_residual``)."""
    if c.op in _REDUCTIONS and c.elems <= _SMALL_ELEMS:
        return "control/metric scalar"
    if c.level == "ep" and c.op == "all_to_all":
        return "expert-parallel dispatch"
    if c.level == "ep_residual" and c.op == "pmean":
        return "EP residual-axis gradient mean"
    return None


def _allowed(c: RecordedCollective) -> bool:
    return allowance(c) is not None


def _allowed_counts(collectives) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in collectives:
        why = allowance(c)
        if why is not None:
            out[why] = out.get(why, 0) + 1
    return out


def _entry_eq(got: RecordedCollective, exp: ConcreteCollective) -> bool:
    return (got.op == exp.op and got.level == exp.level
            and got.dtype == exp.dtype and got.shape == exp.shape)


def _blocks(manifest: List[ConcreteCollective]):
    """The manifest as consecutive per-unit blocks, in issue order."""
    out: List[List[ConcreteCollective]] = []
    for e in manifest:
        if out and out[-1][0].source.unit == e.source.unit:
            out[-1].append(e)
        else:
            out.append([e])
    return out


def _payload(step: StepTrace) -> List[RecordedCollective]:
    return [c for c in step.collectives if not _allowed(c)
            and c.op in _PAYLOAD_OPS]


def _round_blocks(step: StepTrace, sync, fullprec):
    return (_blocks(sync) if "sync" in step.rounds else [],
            _blocks(fullprec) if "fullprec" in step.rounds else [])


def _assign(payload, sb, fb) -> Optional[List[str]]:
    """The round ("sync"/"fullprec") of each payload collective when the
    sequence is an ordered interleaving of all of ``sb``'s and ``fb``'s
    unit blocks, else None. Backtracking over (position, sync block,
    fullprec block): a greedy sync-first choice could mis-claim a block
    that reads the same in both manifests."""
    memo: Dict[Tuple[int, int, int], Optional[List[str]]] = {}

    def fits(i, block):
        return (i + len(block) <= len(payload)
                and all(_entry_eq(c, e) for c, e in
                        zip(payload[i:i + len(block)], block)))

    def go(i, s, f):
        if i == len(payload):
            return [] if (s, f) == (len(sb), len(fb)) else None
        key = (i, s, f)
        if key not in memo:
            memo[key] = None
            for blocks, pos, name in ((sb, s, "sync"), (fb, f, "fullprec")):
                if pos < len(blocks) and fits(i, blocks[pos]):
                    rest = go(i + len(blocks[pos]),
                              s + (name == "sync"), f + (name != "sync"))
                    if rest is not None:
                        memo[key] = [name] * len(blocks[pos]) + rest
                        break
        return memo[key]

    return go(0, 0, 0)


def _match_prefix(seq, block, offset):
    """None if ``seq`` starts with ``block``; else (matching prefix length,
    message, dtype_only) at the first divergence, ``dtype_only`` when the
    operand dtype is the sole mismatch (a codec payload-dtype lie rather
    than a reordered or extra collective)."""
    for k, exp in enumerate(block):
        if k >= len(seq):
            return (k, f"position {offset + k}: the step ends {len(block) - k}"
                       f" collectives short of {exp.source.unit_label}'s "
                       f"block; next expected {exp.describe()}", False)
        got = seq[k]
        problems = []
        if got.op != exp.op:
            problems.append(f"op {got.op} != {exp.op}")
        if got.level != exp.level:
            problems.append(f"level {got.level} != {exp.level}")
        if got.dtype != exp.dtype:
            problems.append(f"dtype {got.dtype} != declared {exp.dtype}")
        if got.shape != exp.shape:
            problems.append(f"shape {got.shape} != {exp.shape}")
        if problems:
            dtype_only = (len(problems) == 1
                          and problems[0].startswith("dtype"))
            return (k, f"position {offset + k}: expected {exp.describe()}, "
                       f"found {got.describe()} ({'; '.join(problems)})",
                    dtype_only)
    return None


def _rounds_label(rounds) -> str:
    return "+".join(rounds) if rounds else LOCAL_ONLY


def check_schedule(trace: Trace, sync: List[ConcreteCollective],
                   fullprec: List[ConcreteCollective],
                   trainer) -> List[Violation]:
    """Each recorded step against the declared manifests of the rounds it
    ran (see the module docstring), then every declared round against the
    rounds the audited steps ran. Messages name the step, the position,
    the unit label and the payload leaf."""
    out: List[Violation] = []
    outer = trainer.hierarchy is not None

    def flag_undeclared(c: RecordedCollective, context: str):
        if (outer and c.level == "outer" and c.elems > _SMALL_ELEMS
                and getattr(torch, c.dtype).itemsize * 8 > 8):
            out.append(Violation(
                "interpod-bytes",
                f"undeclared full-precision collective crosses the "
                f"inter-pod level: {c.describe()} ({context})"))
        else:
            out.append(Violation(
                "undeclared-collective",
                f"collective not in any declared schedule: {c.describe()} "
                f"({context})"))

    for c in trace.outside():
        if not _allowed(c):
            flag_undeclared(c, "outside every audited step")
    for st in trace.steps():
        label = f"step {st.step} ({_rounds_label(st.rounds)})"
        # manifests hold only all_to_all / all_gather: any other
        # payload-sized op is undeclared by construction and must not
        # poison the sequence match
        for c in st.collectives:
            if not _allowed(c) and c.op not in _PAYLOAD_OPS:
                flag_undeclared(c, label)
        payload = _payload(st)
        sb, fb = _round_blocks(st, sync, fullprec)
        if _assign(payload, sb, fb) is not None:
            continue
        # diagnostics: a greedy replay locating the first divergence
        i = s = f = 0
        while i < len(payload):
            cands = []
            if s < len(sb):
                r = _match_prefix(payload[i:], sb[s], i)
                if r is None:
                    i, s = i + len(sb[s]), s + 1
                    continue
                cands.append((r, "sync"))
            if f < len(fb):
                r = _match_prefix(payload[i:], fb[f], i)
                if r is None:
                    i, f = i + len(fb[f]), f + 1
                    continue
                cands.append((r, "fullprec"))
            if not cands:
                for c in payload[i:]:
                    flag_undeclared(c, f"{label}, beyond its declared "
                                       f"rounds")
                break
            (_, msg, dtype_only), name = max(cands, key=lambda t: t[0][0])
            out.append(Violation(
                "payload-dtype" if dtype_only else "schedule",
                f"{label} does not match the declared {name} schedule: "
                f"{msg}"))
            break
        else:
            for name, blocks, pos in (("sync", sb, s), ("fullprec", fb, f)):
                if pos < len(blocks):
                    out.append(Violation(
                        "schedule",
                        f"{label}: the declared {name} round is "
                        f"{len(blocks) - pos} unit blocks short; first "
                        f"missing: {blocks[pos][0].describe()}"))
    declared = ((["sync"] if sync else []) + (["fullprec"] if fullprec else [])
                + ([LOCAL_ONLY] if trace.style == "accumulate" else []))
    seen = {r for rounds in trace.rounds for r in (rounds or (LOCAL_ONLY,))}
    for name in declared:
        if name not in seen:
            first = {"sync": sync, "fullprec": fullprec}.get(name)
            what = (f"its {len(first)} declared collectives (first: "
                    f"{first[0].describe()})" if first else
                    "a step without a sync or variance round")
            out.append(Violation(
                "schedule",
                f"the {name} round never ran in the {len(trace.rounds)} "
                f"audited steps, so {what} went unchecked"))
    return out


def recorded_bytes(trace: Trace, sync: List[ConcreteCollective],
                   fullprec: List[ConcreteCollective]
                   ) -> Dict[str, List[Dict[str, int]]]:
    """Per round, for each audited step that ran it, the bytes one worker
    sent in it (:attr:`RecordedCollective.sent_bytes`) per level
    (``inner``; ``outer``, a flat exchange's level included) and in all.
    Steps whose sequence does not match the manifests are left out
    (:func:`check_schedule` reports them)."""
    out: Dict[str, List[Dict[str, int]]] = {"sync": [], "fullprec": []}
    for st in trace.steps():
        payload = _payload(st)
        labels = _assign(payload, *_round_blocks(st, sync, fullprec))
        if labels is None:
            continue
        for name in st.rounds:
            lv = {"inner": 0, "outer": 0}
            for c, r in zip(payload, labels):
                if r == name:
                    lv["inner" if c.level == "inner" else "outer"] += (
                        c.sent_bytes)
            out[name].append({**lv, "total": lv["inner"] + lv["outer"],
                              "step": st.step})
    return out


def check_wire_bytes(opt, trace: Optional[Trace] = None,
                     tol_per_chunk: int = 4,
                     manifests=None) -> List[Violation]:
    """Declared payload bytes against ``codec.wire_bytes(layout, mode)``
    per exchange unit and phase, within ``tol_per_chunk`` bytes a chunk;
    with a ``trace``, the bytes each recorded round sent against
    ``comm_accounting`` per level (the rule of the module docstring).
    ``manifests``: :func:`build_manifests`'s result where the caller has
    it already (deriving it runs the encode helpers)."""
    from repro_torch.core.compressed import comm_accounting

    out: List[Violation] = []
    ar_cfg = opt.ar_cfg
    codec = ar_cfg.codec
    hier = ar_cfg.hierarchy is not None
    sync, fullprec = manifests or build_manifests(opt)
    units = BK.exchange_units(opt.plan, opt.bucket_plan, opt.cfg.pack_order)
    for u, (lo, _, label) in enumerate(units if sync else ()):
        wire = codec.wire_bytes(lo, ar_cfg.scale_mode)
        for phase, lead in (("scatter", lo.n_outer if hier else lo.n),
                            ("gather", 1)):
            got = sum(e.nbytes for e in sync
                      if e.unit == u and e.phase == phase)
            want = lead * wire[phase]
            if abs(got - want) > tol_per_chunk * lead:
                out.append(Violation(
                    "wire-bytes",
                    f"{label} {phase} payload is {got} bytes but "
                    f"codec.wire_bytes declares {want} ({lead} chunks x "
                    f"{wire[phase]} B; codec {codec.name}, mode "
                    f"{ar_cfg.scale_mode})"))
    if trace is None:
        return out
    acct = comm_accounting(opt)
    want = {name: {lv: acct[f"{key}_{lv}"] for lv in ("inner", "outer")}
            for name, key in (("sync", "compressed_bytes_per_sync"),
                              ("fullprec", "fullprec_bytes_per_round"))}
    want["sync"]["total"] = acct["compressed_bytes_per_sync"]
    n, wire_b = opt.n, getattr(torch, BK.dtype_name(
        opt.cfg.comm_dtype)).itemsize
    flat_fp = acct["n_inner"] <= 1
    padded = sum(int(np.prod(u.layout.view_shape)) for u in opt.units)
    rows_by_round = recorded_bytes(trace, _concrete(sync),
                                   _concrete(fullprec))
    for name, rows in rows_by_round.items():
        for rec in rows:
            bad = [lv for lv in ("inner", "outer") if rec[lv] != want[name][lv]]
            if name == "sync":
                bad += ["total"] * (rec["total"] != want[name]["total"])
            elif flat_fp:
                # the ring headline over the true parameters (docstring)
                bad += ["padded views"] * (
                    rec["total"] * n != 2 * (n - 1) * padded * wire_b)
                bad += ["headline"] * (acct["fullprec_bytes_per_round"] != (
                    2.0 * (n - 1) / max(n, 1) * acct["dp_params"] * wire_b))
            else:
                bad += ["total"] * (
                    rec["total"] != acct["fullprec_bytes_per_round"])
            if bad:
                declared = {k: acct[k] for k in acct if "bytes" in k}
                out.append(Violation(
                    "wire-bytes",
                    f"step {rec['step']}: the recorded {name} round sent "
                    f"{rec['inner']} B intra-pod and {rec['outer']} B "
                    f"across ({rec['total']} B) a worker, which does not "
                    f"reconcile with comm_accounting {declared} at "
                    f"{sorted(set(bad))}"))
    return out


def check_dtypes(trace: Trace) -> List[Violation]:
    out = [Violation("f64", f"float64 operand of a recorded collective: "
                            f"{c.describe()}")
           for c in trace.collectives if c.dtype == "float64"][:8]
    for path, dtype in trace.state_dtypes:
        if dtype == "float64":
            out.append(Violation("f64", f"optimizer state leaf {path} is "
                                        f"float64"))
    return out


# ---------------------------------------------------------------------------
# top-level entry
# ---------------------------------------------------------------------------

def audit_trainer(trainer, params=None, state=None, batches=None, *,
                  trace: Optional[Trace] = None,
                  wrap_step=None) -> AuditReport:
    """The whole audit of a built Trainer: over the steps already recorded
    in ``trace`` (see :func:`watch`), or over one real step per batch of
    ``batches`` from ``params``/``state``."""
    from repro_torch.core.compressed import comm_accounting

    opt = trainer.opt
    if not hasattr(opt, "ar_cfg") or not hasattr(opt, "plan"):
        raise TypeError(
            f"audit_trainer needs a composed optimizer with a declared "
            f"plan/ar_cfg; got {type(opt).__name__}")
    if trace is None:
        if batches is None:
            raise ValueError("audit_trainer needs a trace or batches to run")
        trace = trace_collectives(trainer, params, state, batches,
                                  wrap_step=wrap_step)
    sync_m, fp_m = build_manifests(opt)
    sync_c = concretize_manifest(sync_m, trainer)
    fp_c = concretize_manifest(fp_m, trainer)
    violations = (check_schedule(trace, sync_c, fp_c, trainer)
                  + check_wire_bytes(opt, trace, manifests=(sync_m, fp_m))
                  + check_dtypes(trace))
    rec = recorded_bytes(trace, sync_c, fp_c)
    acct = comm_accounting(opt)
    pack_order = opt.cfg.pack_order
    summary = {
        "arch": trainer.model_cfg.name,
        "n_workers": trainer.n_workers,
        "hierarchy_inner": (trainer.hierarchy.inner
                            if trainer.hierarchy else 0),
        "codec": opt.ar_cfg.codec.name,
        "style": opt.cfg.style,
        "bucketed": opt.bucket_plan is not None,
        "pack_order": pack_order,
        "exchange_units": len(BK.exchange_units(opt.plan, opt.bucket_plan,
                                                pack_order)),
        "steps": len(trace.rounds),
        "rounds": [_rounds_label(r) for r in trace.rounds],
        "collectives_recorded": len(trace.collectives),
        "sync_collectives_declared": len(sync_c),
        "fullprec_collectives_declared": len(fp_c),
        "sync_payload_bytes": int(sum(e.nbytes for e in sync_m)),
        "fullprec_payload_bytes": int(sum(e.nbytes for e in fp_m)),
        "interpod_sync_bytes": int(sum(e.nbytes for e in sync_m
                                       if e.inter_pod)),
        # bytes one worker sent in the first step of each round that
        # ran it, per level, beside comm_accounting's
        "recorded_bytes": {name: rows[0] for name, rows in rec.items()
                           if rows},
        # collectives outside the manifests, by the allowance that
        # admitted them
        "allowed": _allowed_counts(trace.collectives),
        "accounting": {k: acct[k] for k in acct if "bytes" in k},
    }
    return AuditReport(ok=not violations, violations=violations,
                       collectives=trace.collectives, summary=summary)
