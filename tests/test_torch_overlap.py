"""The early, per-unit issue of the exchange (``TrainerConfig.
peel_last_microbatch``, ``core.compressed.StepScheduler``) in one
process, with no spawn: a fake comm stands for a fleet of identical
workers (every collective computed from this worker's own operand, as if
each peer had sent the same) and records each collective as it is issued.

* Fed its gradients in a shuffled order, the scheduler issues the units
  in ``opt.units`` order, and its step is bit for bit the sequential
  step's (params and the whole state) with the same collectives in the
  same order, in every style, flat and two-level, per leaf and bucketed,
  at f32 and at production precision.
* Through ``Trainer.step`` (the hooks of the last micro-batch's
  backward), bit for bit the sequential twin, micro-batches 1 and 2, and
  whisper-smoke, whose cross ``bk``/``bv`` the loss never reaches: they
  get no hook call and their units are issued after the backward.
* A hook that raises, and a collective that raises on the unit thread,
  each fail the step, and the unit thread stops.
"""
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import compressed as CD
from repro_torch.core.comm import Comm, Handle
from repro_torch.core.leafwise import clone_tree, flatten_tree
from repro_torch.data import synthetic as TD
from repro_torch.launch import train as TLAUNCH

torch.set_num_threads(1)

N = 4
SCHEDULE = ["--steps", "6", "--batch", "8", "--seq", "16",
            "--sync-warmup", "2", "--double-every", "2", "--kappa", "1",
            "--lr", "3e-4", "--device", "cpu"]


class LoopbackComm(Comm):
    """Worker 0 of ``n`` identical workers, its collectives in process:
    an all_to_all hands back the first block of this worker's operand
    from every sender, an all_gather this worker's operand from every
    worker. Logs (op, level, dtype, shape) of each collective as it is
    issued; with ``fail_at`` the asynchronous collective of that position
    raises. Spans processes, so that a trainer on it issues early."""

    def __init__(self, n, level="flat", log=None, fail_at=None):
        self.n, self.level = n, level
        self.log = [] if log is None else log
        self.fail_at = fail_at
        self._levels = {}

    def size(self):
        return self.n

    def index(self):
        return np.zeros(1, dtype=np.int64)

    def spans_processes(self):
        return True

    def _rec(self, op, x):
        if self.fail_at is not None and len(self.log) == self.fail_at:
            raise RuntimeError("the collective failed")
        self.log.append((op, self.level, str(x.dtype), tuple(x.shape)))

    def psum(self, x):
        return x * self.n

    def pmean(self, x):
        return x.clone()

    def all_to_all(self, x):
        return x[:, :1].expand_as(x).clone()

    def all_gather(self, x):
        return x.repeat((1, self.n) + (1,) * (x.dim() - 2))

    def all_to_all_async(self, x):
        self._rec("all_to_all", x)
        return Handle(self.all_to_all(x))

    def all_gather_async(self, x):
        self._rec("all_gather", x)
        return Handle(self.all_gather(x))

    def split(self, inner):
        if inner not in self._levels:
            self._levels[inner] = (
                LoopbackComm(self.n // inner, "outer", self.log,
                             self.fail_at),
                LoopbackComm(inner, "inner", self.log, self.fail_at))
        return self._levels[inner]


# the units packed and issued in reverse flat order, the order the
# gradients come in
REVERSE = functools.partial(TLAUNCH.optimizer_fields,
                            pack_order="reverse_backward")
CASES = {
    "flat": ([], None),
    "reverse_backward": ([], REVERSE),
    "bucketed_reverse_backward": (["--bucket-mb", "4"], REVERSE),
    "bucketed": (["--bucket-mb", "4"], None),
    "hier": (["--hierarchy", "2"], None),
    "one_bit_adam": (["--optimizer", "one_bit_adam", "--onebit-warmup",
                      "2"], None),
    "adam": (["--optimizer", "adam"], None),
    "zero_one_lamb": (["--optimizer", "zero_one_lamb"], None),
    "zero_one_sgd": (["--optimizer", "zero_one_sgd"], None),
    "production_no_anchor": ([], functools.partial(
        TLAUNCH.production, store_anchor=False)),
    "qint8": (["--codec", "qint8"], None),
}


def _trainer(extra, configure=None, arch="gpt2", comm=None, mb=1,
             peel=True):
    args = TLAUNCH.parse_args(["--arch", arch, "--smoke", *SCHEDULE,
                               "--micro-batches", str(mb), *extra])
    return TLAUNCH.make_trainer(
        args, comm=LoopbackComm(N) if comm is None else comm,
        configure=configure,
        trainer_cfg={"peel_last_microbatch": peel}), args


def _tensors(params, state):
    st = [x for v in state.slots.values() for x in v]
    st += state.u + state.err_w + state.err_s + state.anchor
    return flatten_tree(params)[1] + [x for x in st if x is not None]


def _assert_same(a, b):
    pa, sa = a
    pb, sb = b
    for x, y in zip(_tensors(pa, sa), _tensors(pb, sb), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for k in ("step", "gamma_acc", "sync_pstate", "var_pstate"):
        assert getattr(sa, k) == getattr(sb, k), k


def _issue_order(opt):
    """Wrap ``opt``'s two exchanges to note each unit's position as its
    exchange starts; returns the list they append to."""
    seen = []
    pos = {u.state_idx: k for k, u in enumerate(opt.units)}
    for name in ("_onebit_phases", "_fullprec_phases"):
        orig = getattr(opt, name)

        def noted(comm, unit, *a, _orig=orig):
            seen.append(pos[unit.state_idx])
            return (yield from _orig(comm, unit, *a))

        setattr(opt, name, noted)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_units_issue_in_order_whatever_order_gradients_come(case):
    """Six steps (syncs with and without a variance round, a local-only
    step) from the same state and gradients: the sequential step, and
    the early scheduler fed every leaf's gradient in a shuffled order
    from this thread while its unit thread runs."""
    extra, configure = CASES[case]
    tr, _ = _trainer(extra, configure)
    opt, comm = tr.opt, tr.comm
    params, state = tr.init(0)
    seq = (clone_tree(params), state.clone())
    early = (params, state)
    order = _issue_order(opt)
    paths, xs = flatten_tree(params)
    rng = np.random.default_rng(7)
    g = torch.Generator().manual_seed(3)
    for t in range(6):
        grads = [torch.randn(x.shape, generator=g).to(x.dtype) * 1e-2
                 for x in xs]
        comm.log.clear()
        del order[:]
        _, _, met_s = opt.step(comm, seq[0], _tree(paths, grads), seq[1])
        want_log, want_order = list(comm.log), list(order)
        comm.log.clear()
        del order[:]
        sched = opt.begin_step(comm, early[0], early[1], early=True)
        for i in rng.permutation(len(grads)):
            sched.grad_ready(int(i), grads[int(i)].clone())
        _, _, met_e = sched.finish()
        assert met_e == met_s
        assert comm.log == want_log and order == want_order, t
        # the accumulate style's T_u and T_v rounds, else one exchange
        rounds = (int(met_s["synced"]) + int(met_s["var_round"])
                  if opt.cfg.style == "accumulate" else 1)
        assert want_order == list(range(len(opt.units))) * rounds, t
        _assert_same(early, seq)
    assert sum(1 for th in threading.enumerate()
               if th.name == "unit-exchange") == 0


def _tree(paths, leaves):
    from repro_torch.core.leafwise import unflatten_tree

    return unflatten_tree(paths, leaves)


def _train(tr, args, steps=None):
    data = TD.SyntheticLM(TD.DataConfig(vocab=tr.model_cfg.vocab,
                                        seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed), device=tr.device)
    params, state = tr.init(args.seed)
    losses = []
    for t in range(args.steps if steps is None else steps):
        batch = TD.add_model_inputs(data.batch(t), tr.model_cfg, tr.device)
        params, state, met = tr.step(params, state, batch)
        losses.append(met["losses"].tolist())
    return losses, (params, state)


@pytest.mark.parametrize("arch,mb", [("gpt2", 1), ("gpt2", 2),
                                     ("whisper-large-v3", 1)])
def test_trainer_early_issue_is_the_sequential_step(arch, mb):
    """``Trainer.step`` with the hooks of the last micro-batch's backward
    against ``peel_last_microbatch=False``: losses, params and state bit
    for bit, the same collectives in the same order. whisper's cross
    ``bk``/``bv`` get no hook call; their units are issued after the
    backward, in their place."""
    runs = {}
    for peel in (True, False):
        tr, args = _trainer([], arch=arch, mb=mb, peel=peel)
        assert tr.early_issue() == peel
        handed = []
        if peel:
            real = CD.StepScheduler.grad_ready

            def spy(self, i, g, donate=False):
                handed.append((i, donate))
                return real(self, i, g, donate)

            CD.StepScheduler.grad_ready = spy
        try:
            losses, final = _train(tr, args, steps=4)
        finally:
            if peel:
                CD.StepScheduler.grad_ready = real
        runs[peel] = (losses, final, list(tr.comm.log), handed, tr)
    assert runs[True][0] == runs[False][0]
    _assert_same(runs[True][1], runs[False][1])
    assert runs[True][2] == runs[False][2]
    handed, tr = runs[True][3], runs[True][4]
    paths = ["/".join(map(str, p))
             for p in flatten_tree(tr.local_shapes)[0]]
    late = {paths[i] for i, donate in handed if donate}
    if arch == "whisper-large-v3":
        # handed after the backward, so the step may write into them
        assert late == {"cross/attn/bk", "cross/attn/bv"}
    else:
        assert late == set()
    assert len(handed) == 4 * len(paths)


def test_hook_that_raises_fails_the_step(monkeypatch):
    """A hook whose call raises fails the backward and the step with that
    error; the unit thread stops."""
    tr, args = _trainer([])
    real = CD.StepScheduler.grad_ready
    calls = []

    def failing(self, i, g, donate=False):
        calls.append(i)
        if len(calls) == 3:
            raise RuntimeError("the hook failed")
        return real(self, i, g, donate)

    monkeypatch.setattr(CD.StepScheduler, "grad_ready", failing)
    with pytest.raises(RuntimeError, match="the hook failed"):
        _train(tr, args, steps=1)
    assert len(calls) == 3
    assert not [th for th in threading.enumerate()
                if th.name == "unit-exchange" and th.is_alive()]


def test_collective_that_raises_fails_the_step():
    """A unit's asynchronous collective that raises on the unit thread
    fails the step with that error (raised in the next hook or at the
    end of the backward); nothing falls back to the sequential step."""
    tr, args = _trainer([], comm=LoopbackComm(N, fail_at=3))
    with pytest.raises(RuntimeError, match="the collective failed"):
        _train(tr, args, steps=1)
    assert not [th for th in threading.enumerate()
                if th.name == "unit-exchange" and th.is_alive()]


@pytest.mark.parametrize("peel", [True, False])
def test_step_lets_its_gradients_go(peel, monkeypatch):
    """Each step's scheduler, which holds the step's gradients, is freed
    by reference counting as the step returns (no reference cycle that
    would keep a step's gradients alive into the next one until the
    cyclic collector runs), early and sequential."""
    import gc
    import weakref

    made = []
    init = CD.StepScheduler.__init__

    def noting(self, *a, **k):
        init(self, *a, **k)
        made.append(weakref.ref(self))

    monkeypatch.setattr(CD.StepScheduler, "__init__", noting)
    tr, args = _trainer(["--hierarchy", "2"], peel=peel)
    gc.disable()
    try:
        _train(tr, args, steps=3)
        assert len(made) == 3 and all(r() is None for r in made)
    finally:
        gc.enable()
