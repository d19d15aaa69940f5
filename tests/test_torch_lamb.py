"""The port's LAMB (``LambBase`` in all three styles: ``zero_one_lamb``,
``lamb``, ``one_bit_lamb``) against the reference, live in one process;
the registry and the ``make_optimizer`` shim; the trust slot through
``interop``.

Tolerances, with their reasons:
* ``trust_ratio``: 1.0 where either norm is 0 and the clip at
  ``max_trust``/``min_trust``, exactly; otherwise within 8 ulp. Each norm
  is an f32 sum of squares taken in another order than XLA's (measured
  at most 6 ulp on the ratio along the sync-style trajectories below);
* the trajectories (the small tree of ``test_torch_optimizer.py``, 8
  steps, syncs at 0-4 and 6, variance at 0, 1 and 3; the sync styles
  with and without weight decay): params, m, v, u and both EF errors to
  ``_close`` (1e-5 relative plus 1e-6 of the leaf's largest magnitude),
  as Adam's, and so is the carried trust of ``zero_one_lamb`` (its
  inputs, the synced ``ubar``, are themselves only ``_close``: measured
  at most 11 ulp, at 2 pods x 2). ``lamb``'s m and v are bit for bit
  (a bf16 mean and the FMA forms of Adam's step). The kernel path's
  delta is Adam's (<= 2 ulp) times the trust, one more rounding;
* the sync-style step as XLA compiles it (jax 0.9.0, CPU):
  ``u = m' * rsqrt(v + eps)`` with the variance from before the step,
  ``x' = fma(u, -(lr*trust), x)``; given XLA's own rsqrt and trust, 100%
  of params bit for bit without decay (measured), 99.65% with decay
  (``u + wd*x``, either rounding, leaves the rest one ulp off);
* the trainers: step losses within 1e-4, params 99% within 1e-4 and all
  within 0.05, the slice's bars (measured worst loss gaps 9.5e-7
  gpt2-smoke, 4.8e-7 bert-smoke; params within 2.3e-4).
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import api as RAPI
from repro.core import base_steps as RB
from repro.core import build_optimizer as ref_build
from repro.core import compressed as RCDP
from repro.core import compressor as RC
from repro.core import schedules as RS
from repro.core.comm import Comm as RefComm
from repro.core.comm import Hierarchy as RefHierarchy
from repro.core.comm import sim_comm
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import base_steps as TB
from repro_torch.core import compressed as TC_DP
from repro_torch.core import compressor as TC
from repro_torch.core import onebit_allreduce as TAR
from repro_torch.core import schedules as TS
from repro_torch.core.comm import Hierarchy, NullComm, SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.kernels import dispatch as K
from repro_torch.kernels import fused_adam as FA
from repro_torch.launch import train as TLAUNCH
from repro_torch.train import step as TSTEP

# one intra-op thread: the inputs are small, and the suite runs several
# pytest-xdist workers per machine
torch.set_num_threads(1)

N, STEPS = 4, 8
SHAPES = {"w": (6, 16), "b": (5,), "deep": {"k": (3, 8, 8)},
          "s": (13, 40), "t": (6, 4, 24)}
REF_SPECS = {"w": None, "b": None, "deep": {"k": None},
             "s": P(None, "model"), "t": P(None, None, "model")}
PORT_SPECS = {"w": None, "b": None, "deep": {"k": None},
              "s": (None, "model"), "t": (None, None, "model")}
SYNC = [1, 1, 1, 1, 1, 0, 1, 0]
VAR = [1, 1, 0, 1, 0, 0, 0, 0]
ONE_BIT_VAR = [1, 1] + [0] * (STEPS - 2)
TRUST_ULPS = 8


def _map(f, t):
    return {k: _map(f, v) if isinstance(v, dict) else f(v)
            for k, v in t.items()}


def _inputs():
    rng = np.random.default_rng(0)
    params = _map(lambda s: rng.standard_normal(s).astype(np.float32),
                  SHAPES)
    grads = [_map(lambda s: rng.standard_normal((N,) + s).astype(
        np.float32), SHAPES) for _ in range(STEPS)]
    return params, grads


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * scale + 1e-30, err_msg=what)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - np.asarray(b, np.float32).view(np.int32).astype(
        np.int64))


# --- the base -------------------------------------------------------------

TRUST_CASES = {   # id -> (x scale, update scale, max_trust, min_trust)
    "random": (1.0, 0.3, 10.0, 0.0), "zero_x": (0.0, 0.3, 10.0, 0.0),
    "zero_update": (1.0, 0.0, 10.0, 0.0), "both_zero": (0.0, 0.0, 10.0, 0.0),
    "clip_max": (1.0, 1e-4, 10.0, 0.0), "clip_min": (1e-4, 1.0, 10.0, 0.5),
    "small_max": (1.0, 0.3, 2.0, 0.0)}


@pytest.mark.parametrize("case", list(TRUST_CASES))
def test_trust_ratio_matches_reference(case):
    """Per stacked worker, each worker its own scale: 1.0 exactly where
    either norm is 0, the clip bounds exactly, else within TRUST_ULPS."""
    xs, us, hi, lo = TRUST_CASES[case]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 7, 33)).astype(np.float32) * xs
    u = rng.standard_normal((N, 7, 33)).astype(np.float32) * us
    x[1] *= 3.0     # the workers differ
    ref = RB.lamb_base(max_trust=hi, min_trust=lo)
    port = TB.lamb_base(max_trust=hi, min_trust=lo)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b: ref.trust_ratio(a, b, ())))(x, u))
    got = port.trust_ratio(torch.from_numpy(x), torch.from_numpy(u))
    assert got.shape == (N,) and got.dtype == torch.float32
    if case in ("zero_x", "zero_update", "both_zero"):
        assert (got == 1.0).all() and (want == 1.0).all()
    elif case in ("clip_max", "clip_min"):
        bound = hi if case == "clip_max" else lo
        assert (got == bound).all() and (want == bound).all()
    assert _ulps(got.numpy(), want).max() <= TRUST_ULPS


def test_trust_norm_is_stack_independent():
    """Each worker's norm from a stack is the norm of that worker alone,
    bit for bit (what keeps a rank bitwise its simulated worker)."""
    x = torch.randn(4, 37, 129, generator=torch.Generator().manual_seed(0))
    whole = TB.worker_l2(x)
    for w in range(4):
        assert torch.equal(whole[w:w + 1], TB.worker_l2(x[w:w + 1].clone()))
    # an unaligned worker buffer (odd numel) is copied first
    y = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(TB.worker_l2(y)[1:2], TB.worker_l2(y[1:2].clone()))


def test_lamb_base_matches_reference_definitions():
    t, r = TB.lamb_base(), RB.lamb_base()
    assert (t.beta1, t.beta2, t.eps, t.min_trust, t.max_trust) == (
        r.beta1, r.beta2, r.eps, r.min_trust, r.max_trust)
    for tb, rb in ((TB.adam_base(), RB.adam_base()), (t, r),
                   (TB.momentum_sgd_base(), RB.momentum_sgd_base())):
        assert (tb.kind, tb.has_variance, tb.has_trust, tb.needs_anchor,
                tb.sync_slot_names) == (rb.kind, rb.has_variance,
                                        rb.has_trust, rb.needs_anchor,
                                        rb.sync_slot_names)
        assert tb.slot_specs() == rb.slot_specs()


def test_refresh_sync_slots_matches_reference():
    """The accumulate style's trust refresh from the anchor and the
    rate-normalized aggregate, per stacked worker, against the
    reference's at every leaf of the small tree (TRUST_ULPS)."""
    rng = np.random.default_rng(2)
    gamma = np.float32(0.037)
    for shape, rspec, tspec in zip(flatten_tree(SHAPES)[1],
                                   flatten_tree(REF_SPECS)[1],
                                   flatten_tree(PORT_SPECS)[1]):
        lo_r = RC.make_layout(shape, rspec, N)
        lo_t = TC.make_layout(shape, tspec, N)
        anc = rng.standard_normal((N,) + shape).astype(np.float32)
        ubar = rng.standard_normal((N,) + lo_r.view_shape).astype(
            np.float32) * 0.01
        v = np.abs(rng.standard_normal((N,) + lo_r.view_shape)).astype(
            np.float32) * 1e-3
        want = jax.jit(jax.vmap(lambda a, u_, v_: RB.lamb_base()
                                .refresh_sync_slots({"v": v_}, a, u_, gamma,
                                                    lo_r, ())["trust"]))(
            anc, ubar, v)
        got = TB.lamb_base().refresh_sync_slots(
            {"v": torch.from_numpy(v)}, torch.from_numpy(anc),
            torch.from_numpy(ubar), torch.tensor(gamma), lo_t)["trust"]
        assert _ulps(got.numpy(), np.asarray(want)).max() <= TRUST_ULPS


def test_fused_local_step_view_takes_lamb_through_the_adam_kernel():
    """kind "lamb" runs kernel 1 as "adam" does (the plain version on the
    CPU): the same m', u' and delta bits; an unknown kind raises. The
    step updates m and u in place, so each kind steps its own copies."""
    lo = TC.make_layout((13, 40), (None, "model"), N)
    g, m, u = (torch.randn((N,) + lo.view_shape) for _ in range(3))
    v = torch.rand((N,) + lo.view_shape)
    outs = []
    for kind in ("adam", "lamb"):
        mk, uk = m.clone(), u.clone()
        d = K.fused_local_step_view_(g, mk, uk, v, 1e-2, 0.9, 1e-8, lo, kind)
        outs.append((mk, uk, d))
    a, b = outs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="unknown base kind"):
        K.fused_local_step_view_(g, m, u, v, 1e-2, 0.9, 1e-8, lo, "nope")


# --- registry ---------------------------------------------------------------

def test_registry_names_equal_reference():
    assert TA.REGISTRY_NAMES == RAPI.REGISTRY_NAMES
    assert TA.LEGACY_NAMES == RAPI.LEGACY_NAMES
    for name in TA.REGISTRY_NAMES:
        t = TA.transform_from_config(TA.OptimizerConfig(name=name))
        r = RAPI.transform_from_config(RefOptimizerConfig(name=name))
        assert (t.style, type(t.base).__name__) == (r.style,
                                                    type(r.base).__name__)


@pytest.mark.parametrize("name", list(RAPI.REGISTRY_NAMES))
def test_make_optimizer_warns_as_reference(name):
    """The legacy names warn with the reference's category and text; the
    others do not warn."""
    shapes = {"w": (4, 8)}
    with warnings.catch_warnings(record=True) as ref_rec:
        warnings.simplefilter("always")
        RAPI.make_optimizer(RefOptimizerConfig(name=name),
                            {"w": jnp.zeros((4, 8))}, n_workers=N)
    with warnings.catch_warnings(record=True) as port_rec:
        warnings.simplefilter("always")
        opt = TA.make_optimizer(TA.OptimizerConfig(name=name), shapes,
                                n_workers=N)
    want = [(w.category, str(w.message)) for w in ref_rec
            if issubclass(w.category, DeprecationWarning)
            and "make_optimizer" in str(w.message)]
    got = [(w.category, str(w.message)) for w in port_rec]
    assert got == want and bool(got) == (name in TA.LEGACY_NAMES)
    assert opt.cfg.style == TA.transform_from_config(
        TA.OptimizerConfig(name=name)).style
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TA.make_optimizer(TC_DP.compressed_dp(TA.adam_base()), shapes,
                          n_workers=N)


def test_needs_anchor_text_and_weight_decay_error():
    """The port keeps the anchor for every base, so it has no
    ``store_anchor`` option; the text the reference raises for LAMB
    without one is kept word for word for the port of that option. The
    accumulate style refuses a decay term under LAMB as under Adam."""
    with pytest.raises(ValueError) as ref:
        RCDP.compressed_dp(RB.lamb_base(), store_anchor=False)
    assert TB.NEEDS_ANCHOR_TEXT.format(base="LambBase") == str(ref.value)
    assert TB.LambBase.needs_anchor and not TB.AdamBase.needs_anchor
    with pytest.raises(ValueError, match="accumulate style"):
        TA.build_optimizer(TA.OptimizerConfig(name="zero_one_lamb",
                                              weight_decay=0.01),
                           {"w": (4, 8)}, n_workers=N)


# --- trajectories -----------------------------------------------------------

TRAJ = {   # id -> (registry name, config fields, var rounds)
    "zero_one_lamb": ("zero_one_lamb", {}, VAR),
    "zero_one_lamb-2x2": ("zero_one_lamb", {"inner": 2}, VAR),
    "zero_one_lamb-bucketed": ("zero_one_lamb", {"bucket_mb": 0.001}, VAR),
    "zero_one_lamb-bucketed-2x2": ("zero_one_lamb",
                                   {"bucket_mb": 0.001, "inner": 2}, VAR),
    "lamb": ("lamb", {}, [1] * STEPS),
    "lamb-wd": ("lamb", {"weight_decay": 0.01}, [1] * STEPS),
    "one_bit_lamb": ("one_bit_lamb", {"onebit_warmup": 2}, ONE_BIT_VAR),
    "one_bit_lamb-wd": ("one_bit_lamb", {"onebit_warmup": 2,
                                         "weight_decay": 0.01}, ONE_BIT_VAR),
    "one_bit_lamb-2x2": ("one_bit_lamb", {"onebit_warmup": 2, "inner": 2},
                         ONE_BIT_VAR),
}


def _setup(name, fields, ref_pallas=False):
    """Both packages' optimizers over the small tree, the reference's
    jitted step over the stacked workers (pods of ``inner`` under a
    nested vmap, outer-major as the port) and both initial states."""
    fields = dict(fields)
    inner = fields.pop("inner", None)
    params, grads = _inputs()
    common = dict(name=name, onebit_warmup=fields.pop("onebit_warmup", 16000),
                  **fields)
    ref_cfg = RefOptimizerConfig(
        lr=RS.ConstantLr(1e-2), var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2), use_pallas=ref_pallas,
        hierarchy=RefHierarchy(inner=inner) if inner else None, **common)
    port_cfg = TA.OptimizerConfig(
        lr=TS.ConstantLr(1e-2), var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2),
        hierarchy=Hierarchy(inner) if inner else None, **common)
    ref_opt = ref_build(ref_cfg, _map(jnp.asarray, params),
                        specs=REF_SPECS, n_workers=N)
    port_opt = TA.build_optimizer(port_cfg, SHAPES, specs=PORT_SPECS,
                                  n_workers=N)
    rx = _map(lambda a: jnp.broadcast_to(jnp.asarray(a), (N,) + a.shape)
              + 0, params)
    rs = jax.vmap(lambda _: ref_opt.init(_map(jnp.asarray, params)))(
        jnp.arange(N))
    if inner:
        comm = RefComm(("pod", "data"))
        fold = lambda a: a.reshape((N // inner, inner) + a.shape[1:])  # noqa
        unfold = lambda a: a.reshape((N,) + a.shape[2:])                # noqa
        step = jax.vmap(jax.vmap(lambda x, g, s: ref_opt.step(comm, x, g, s),
                                 axis_name="data"), axis_name="pod")
        ref_step = jax.jit(lambda *a: jax.tree.map(
            unfold, step(*jax.tree.map(fold, a))))
    else:
        comm = sim_comm("w")
        ref_step = jax.jit(lambda xs, gs, st: jax.vmap(
            lambda x, g, s: ref_opt.step(comm, x, g, s), axis_name="w")(
                xs, gs, st))
    tx = _map(lambda a: torch.from_numpy(
        np.broadcast_to(a, (N,) + a.shape).copy()), params)
    return grads, ref_opt, port_opt, ref_step, rx, rs, tx, port_opt.init(tx)


@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
@pytest.mark.parametrize("case", list(TRAJ))
def test_lamb_trajectory_matches_reference(case, ref_pallas):
    """8 steps on both packages; every step compares the metrics, params,
    every slot (the trust constant 1.0 in the styles that recompute it),
    u and both EF errors."""
    name, fields, expect_var = TRAJ[case]
    grads, _, port_opt, ref_step, rx, rs, tx, ts = _setup(name, fields,
                                                          ref_pallas)
    assert sorted(ts.slots) == sorted(rs.slots) == ["m", "trust", "v"]
    style = port_opt.cfg.style
    worst = 0
    for t in range(STEPS):
        rx, rs, rm = ref_step(rx, _map(jnp.asarray, grads[t]), rs)
        tx, ts, tm = port_opt.step(SimComm(N), tx,
                                   _map(torch.from_numpy, grads[t]), ts)
        assert tm["synced"] == bool(rm["synced"][0]) == (
            SYNC[t] if style == "accumulate" else True)
        assert tm["var_round"] == bool(rm["var_round"][0]) == expect_var[t]
        assert tm["lr"] == np.asarray(rm["lr"])[0]
        assert ts.step == int(rs.step[0])
        for i, (a, b) in enumerate(zip(flatten_tree(tx)[1],
                                       jax.tree.leaves(rx))):
            _close(a, b, f"step {t} params leaf {i}")
        for i, (a, b) in enumerate(zip(ts.slots["trust"],
                                       rs.slots["trust"])):
            assert a.shape == (N,)
            _close(a, b, f"step {t} trust leaf {i}")
            worst = max(worst, _ulps(a.numpy(), np.asarray(b)).max())
            if style != "accumulate":
                assert (a == 1.0).all()
        for k in ("m", "v"):
            for i, (a, b) in enumerate(zip(ts.slots[k], rs.slots[k])):
                if name == "lamb":
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                _close(a, b, f"step {t} slot {k} leaf {i}")
        for k in ("u", "err_w", "err_s"):
            for i, (a, b) in enumerate(zip(getattr(ts, k), getattr(rs, k))):
                if b is None:
                    assert a is None
                    continue
                _close(a, b, f"step {t} {k} leaf {i}")
    print(case, "worst trust ulps", worst)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_lamb_sync_step_forms_are_xlas(wd):
    """The sync-style LAMB step against the reference's own ``lamb``
    trajectory, each step from its params and state before it: with
    XLA's rsqrt (its CPU rsqrt is an approximation, see
    ``test_torch_optimizer.py``) and the trust XLA used (found among
    ulps around the port's), ``x' = fma(m' * r, -(lr*trust), x)`` gives
    every param bit for bit without decay, and 99.5% with it (measured
    99.65%), the trust found within TRUST_ULPS of the port's."""
    grads, _, port_opt, ref_step, rx, rs, _, _ = _setup(
        "lamb", {"weight_decay": wd})
    f32 = lambda a: float(np.float32(a))   # noqa: E731
    b1, omb1, lr = f32(0.9), f32(1 - 0.9), f32(1e-2)
    eq = n = 0
    for t in range(STEPS):
        rx0, rs0 = rx, rs
        rx, rs, _ = ref_step(rx, _map(jnp.asarray, grads[t]), rs)
        for i, (g, x0, x1, lo) in enumerate(zip(
                flatten_tree(grads[t])[1], jax.tree.leaves(rx0),
                jax.tree.leaves(rx), port_opt.layouts)):
            g = TAR.fullprec_allreduce_view(
                SimComm(N), TC.to_view(torch.from_numpy(g), lo))
            x0 = torch.from_numpy(np.array(x0))
            x1 = np.asarray(x1)
            m0 = torch.from_numpy(np.array(rs0.slots["m"][i]))
            v0 = torch.from_numpy(np.array(rs0.slots["v"][i]))
            nm = FA.fma(m0, b1, g * omb1)
            r = torch.from_numpy(np.asarray(jax.lax.rsqrt(
                jnp.asarray((v0 + f32(1e-8)).numpy()))))
            upd = TC.from_view(nm * r, lo)
            if wd:
                upd = FA.fma(x0, f32(wd), upd)
            trust = port_opt.base.trust_ratio(x0, upd)
            for w in range(N):
                best = 0
                for o in range(-TRUST_ULPS, TRUST_ULPS + 1):
                    tw = (trust[w:w + 1].numpy().view(np.int32) + o).view(
                        np.float32)
                    lt = f32(np.float32(lr) * tw[0])
                    got = FA.fma(upd[w], -lt, x0[w]).numpy()
                    best = max(best, int((got == x1[w]).sum()))
                eq += best
                n += x1[w].size
    share = eq / n
    print("lamb wd", wd, "params bit for bit", share)
    assert share == 1.0 if not wd else share >= 0.995


# --- trainers, interop, CLI -------------------------------------------------

def _port_batch(b):
    return {k: torch.from_numpy(np.array(v)) if k == "loss_mask"
            else torch.from_numpy(np.array(v)).long() for k, v in b.items()}


def _lamb_cfgs():
    """The reference's and the port's zero_one_lamb of the trainer cases
    below."""
    return (RefOptimizerConfig(
                name="zero_one_lamb", lr=RS.ConstantLr(1e-3),
                var_policy=RS.AdaptiveFreezePolicy(kappa=1),
                sync_policy=RS.LrProportionalSyncPolicy(2, 2)),
            TA.OptimizerConfig(
                name="zero_one_lamb", lr=TS.ConstantLr(1e-3),
                var_policy=TS.AdaptiveFreezePolicy(kappa=1),
                sync_policy=TS.LrProportionalSyncPolicy(2, 2)))


@functools.lru_cache(maxsize=None)
def _ref_start(arch, n):
    """The reference's zero_one_lamb trainer of ``arch``-smoke at ``n``
    workers (1: single mode), its draw (key 0) and its jitted step, made
    once a configuration: the trainer and interop cases share them."""
    rt = RefTrainer(ref_get(arch).smoke, _lamb_cfgs()[0], n_workers=n)
    key = jax.random.PRNGKey(0)
    if n == 1:
        return rt, rt.single_init(key), rt.single_step_fn()
    return rt, rt.sim_init(key), rt.sim_step_fn()


@pytest.mark.parametrize("arch,kind", [("gpt2", "lm"), ("bert-base", "mlm")])
def test_smoke_zero_one_lamb_trainer_matches_reference(arch, kind):
    """The gpt2-smoke (next-token) and bert-smoke (MLM) trainers under
    zero_one_lamb, 4 workers, from the reference's draw on its batches:
    the slice's bars (module docstring)."""
    port_cfg = _lamb_cfgs()[1]
    _, (rp, rs), ref_step = _ref_start(arch, N)
    pt = TSTEP.Trainer(port_get(arch).smoke, port_cfg, comm=SimComm(N),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=32,
                                        global_batch=8, seed=0, kind=kind))
    flags = []
    for t in range(STEPS):
        b = data.batch(t)
        rp, rs, rm = ref_step(rp, rs, b)
        tp, ts, tm = pt.step(tp, ts, _port_batch(b))
        flags.append((tm["synced"], tm["var_round"]))
        assert abs(float(tm["loss"]) - float(rm["loss"][0])) < 1e-4, t
    diff = np.concatenate([
        np.abs(np.asarray(a) - b.numpy()).ravel()
        for a, b in zip(jax.tree.leaves(rp), flatten_tree(tp)[1])])
    assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 0.05
    assert [f[0] for f in flags] == SYNC and [f[1] for f in flags] == VAR
    trust = np.stack([a.numpy() for a in ts.slots["trust"]])
    assert np.isfinite(trust).all() and (trust >= 0).all() and (
        trust <= 10).all() and (trust != 1.0).any()


@pytest.mark.parametrize("single", [False, True], ids=["sim", "single"])
def test_interop_carries_the_trust_slot(single):
    """The reference's zero_one_lamb state after 3 steps -> the port's ->
    back: the trust slot (one scalar per worker and leaf in sim mode, a
    () array in single mode; the port's (stack,)) and every other leaf
    unchanged; the port's init equals the reference's, carried over."""
    port_cfg = _lamb_cfgs()[1]
    n = 1 if single else N
    pt = TSTEP.Trainer(port_get("gpt2").smoke, port_cfg,
                       comm=NullComm() if single else SimComm(N),
                       device="cpu")
    _, (rp, rs), step = _ref_start("gpt2", n)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=32,
                                        global_batch=8, seed=0))
    init = interop.state_from_reference(jax.device_get(rs), pt.opt,
                                        stacked=not single)
    want_init = pt.opt.init(interop.params_from_reference(
        jax.device_get(rp)))
    for a, b in zip(init.slots["trust"], want_init.slots["trust"]):
        assert torch.equal(a, b) and a.shape == (n,)
    for t in range(3):
        rp, rs, _ = step(rp, rs, data.batch(t))
    rs = jax.device_get(rs)
    ts = interop.state_from_reference(rs, pt.opt, stacked=not single)
    assert len(ts.slots["trust"]) == len(rs.slots["trust"]) == 19
    for a, b in zip(ts.slots["trust"], rs.slots["trust"]):
        assert a.shape == (n,) and np.asarray(b).shape == (
            () if single else (N,))
        np.testing.assert_array_equal(a.numpy().reshape(np.shape(b)), b)
        assert (a != 1.0).all()     # refreshed at the syncs
    back = interop.state_to_reference(ts, stacked=not single)
    for k in rs.slots:
        for a, b in zip(back.slots[k], rs.slots[k]):
            assert tuple(a.shape) == np.shape(b)
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("mode", ["sim", "single"])
@pytest.mark.parametrize("name", ["zero_one_lamb", "one_bit_lamb", "lamb"])
def test_cli_runs_lamb_on_cpu(capsys, name, mode):
    TLAUNCH.main(["--arch", "bert-base", "--smoke", "--mode", mode,
                  "--optimizer", name, "--onebit-warmup", "1", "--steps",
                  "3", "--batch", "4", "--seq", "16", "--sync-warmup", "1",
                  "--double-every", "1", "--kappa", "1", "--log-every", "1",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"optimizer={name}" in out and "DONE: 3 steps" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
