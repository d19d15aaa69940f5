"""Port ``zero_one_adam`` (every scale mode) and ``zero_one_sgd``, and the
paper's baselines ``adam``, ``momentum_sgd`` and ``one_bit_adam``, vs the
reference, live in one process: the same numpy gradients fed to both for
8 steps, and the policies and lr schedules step for step.

Schedule (sync_warmup=2, double_every=2, kappa=1): syncs at steps 0-4
and 6, variance refreshes at 0, 1 and 3 (none for zero_one_sgd, whose
base has no variance), local-only steps at 5 and 7.

Tolerances: every tensor to 1e-5 relative plus 1e-6 of its own largest
magnitude. The scales are f32 sums in another order than XLA's (a few
ulp), Adam's update divides by sqrt(v + eps) with v as small as 1e-3 here,
and the variance means travel as bf16 on both sides; measured worst
cases over the 8 steps are ~1e-6 relative on params and ~1e-7 on the
state. Sign flips of near-zero elements (see test_torch_compressor) do
not occur for these seeds; the slice test covers them.

The baselines (gradient and mean styles) take the base step in plain
arithmetic, written as XLA compiles the reference's (jax 0.9.0, CPU):
``m' = fma(b1, m, (1-b1)*g)`` and ``v' = fma(b2, v, ((1-b2)*g)*g)``, and
the update ``x' = fma(-(lr*m'), rsqrt(v+eps), x)``, with decay
``x' = x - fma(x, lr*wd, (lr*m')*r)`` (momentum SGD: ``fma(m', -lr,
x)``, ``x - fma(x, lr*wd, lr*m')``). ``test_sync_step_forms_are_xlas``
pins the forms over the reference's own 8 steps, each from its state
before the step: plain f32 matches m' on 87.5% of elements and v' on
91.6%, the other contraction 85.5% and 90.9%, these forms 100%; momentum
SGD's x' 100% (plain ``x - lr*m'`` 99.76%, with decay 99.99%); Adam's
x' 99.57% (plain ``x - (lr*m')*r`` 94.70%, the source's divide 93.73%),
with decay 99.60% (plain 99.59%), the rest from the rsqrt. Bars:
* the mean gradient of a full-precision round is bit for bit the
  reference's (bf16 on the wire), so ``m`` and ``v`` are bit for bit on
  every step of ``adam`` and ``momentum_sgd`` and on the full-precision
  stage of ``one_bit_adam``, and momentum SGD's params too;
* Adam's params: XLA's CPU ``rsqrt`` is an approximation within 1 ulp
  of the correctly rounded value the port computes (94.3% of values
  equal in that test), so params are held to ``_close`` (measured along
  the 8-step trajectory: 98.4% of elements bit for bit, 98.7% with
  decay; the rest a few ulp of the step, large in ulps of x only where
  x is near 0);
* the 1-bit stage: the exchange's scales are f32 sums in another order
  than XLA's, so the exchanged gradient, ``m``, the EF state and params
  are held to ``_close`` (measured over the 8 steps: 72.5-79.9% of EF
  elements and 94.3-98.6% of params bit for bit, flat and 2 pods x 2).
  Bit for bit given equal scales: ``test_one_bit_step_from_reference_state``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import build_optimizer as ref_build
from repro.core import schedules as RS
from repro.core.comm import Comm as RefComm
from repro.core.comm import Hierarchy as RefHierarchy
from repro.core.comm import sim_comm

from repro.core import compressor as RC

from repro_torch import interop
from repro_torch.core import api as TA
from repro_torch.core import compressed as TC_DP
from repro_torch.core import compressor as TC
from repro_torch.core import schedules as TS
from repro_torch.core.comm import Hierarchy, SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.kernels import dispatch as K

# The suite runs under pytest-xdist with several workers per machine;
# torch's default of one intra-op thread per core in each of them would
# oversubscribe the cores. These inputs are small: one thread suffices.
torch.set_num_threads(1)

N, STEPS = 4, 8
SHAPES = {"w": (6, 16), "b": (5,), "deep": {"k": (3, 8, 8)},
          "s": (13, 40), "t": (6, 4, 24)}
REF_SPECS = {"w": None, "b": None, "deep": {"k": None},
             "s": P(None, "model"), "t": P(None, None, "model")}
PORT_SPECS = {"w": None, "b": None, "deep": {"k": None},
              "s": (None, "model"), "t": (None, None, "model")}
EXPECT_SYNC = [True, True, True, True, True, False, True, False]
EXPECT_VAR = [True, True, False, True, False, False, False, False]


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


@pytest.mark.parametrize("ref_pallas,codec", [
    (False, "sign1bit"), (True, "sign1bit"), (False, "identity")],
    ids=["sign1bit-ref_xla", "sign1bit-ref_pallas", "identity-ref_xla"])
def test_zero_one_adam_trajectory_matches_reference(ref_pallas, codec):
    params, grads = _inputs()
    ref_cfg = RefOptimizerConfig(
        name="zero_one_adam", lr=RS.ConstantLr(1e-2),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2),
        use_pallas=ref_pallas, codec=codec)
    port_cfg = TA.OptimizerConfig(
        lr=TS.ConstantLr(1e-2), var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2), codec=codec)
    ref_opt = ref_build(ref_cfg, _map(jnp.asarray, params),
                        specs=REF_SPECS, n_workers=N)
    port_opt = TA.build_optimizer(port_cfg, SHAPES, specs=PORT_SPECS,
                                  n_workers=N)
    comm = sim_comm("w")
    rx = _map(lambda a: jnp.broadcast_to(jnp.asarray(a), (N,) + a.shape)
              + 0, params)
    rs = jax.vmap(lambda _: ref_opt.init(_map(jnp.asarray, params)))(
        jnp.arange(N))
    ref_step = jax.jit(lambda xs, gs, st: jax.vmap(
        lambda x, g, s: ref_opt.step(comm, x, g, s), axis_name="w")(
            xs, gs, st))
    tx = _map(lambda a: torch.from_numpy(
        np.broadcast_to(a, (N,) + a.shape).copy()), params)
    ts = port_opt.init(tx)
    for t in range(STEPS):
        rx, rs, rm = ref_step(rx, _map(jnp.asarray, grads[t]), rs)
        tx, ts, tm = port_opt.step(SimComm(N), tx,
                                   _map(torch.from_numpy, grads[t]), ts)
        assert tm["synced"] == bool(rm["synced"][0]) == EXPECT_SYNC[t]
        assert tm["var_round"] == bool(rm["var_round"][0]) == EXPECT_VAR[t]
        assert tm["lr"] == np.asarray(rm["lr"])[0]
        for i, (a, b) in enumerate(zip(flatten_tree(tx)[1],
                                       jax.tree.leaves(rx))):
            _close(a, b, f"step {t} params leaf {i}")
        for name, got, want in [
                ("m", ts.slots["m"], rs.slots["m"]),
                ("v", ts.slots["v"], rs.slots["v"]),
                ("u", ts.u, rs.u), ("err_w", ts.err_w, rs.err_w),
                ("err_s", ts.err_s, rs.err_s)]:
            for i, (a, b) in enumerate(zip(got, want)):
                _close(a, b, f"step {t} {name} leaf {i}")
        assert ts.step == int(rs.step[0])
        assert ts.gamma_acc == np.asarray(rs.gamma_acc)[0]


def _run_both(name, scale_mode, ref_pallas, expect_var):
    """8 steps of ``name`` on both packages; every step compares params,
    the slots the base carries, u, both EF errors and the step metrics."""
    params, grads = _inputs()
    ref_cfg = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(1e-2),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2),
        use_pallas=ref_pallas, scale_mode=scale_mode)
    port_cfg = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(1e-2),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2), scale_mode=scale_mode)
    ref_opt = ref_build(ref_cfg, _map(jnp.asarray, params),
                        specs=REF_SPECS, n_workers=N)
    port_opt = TA.build_optimizer(port_cfg, SHAPES, specs=PORT_SPECS,
                                  n_workers=N)
    comm = sim_comm("w")
    rx = _map(lambda a: jnp.broadcast_to(jnp.asarray(a), (N,) + a.shape)
              + 0, params)
    rs = jax.vmap(lambda _: ref_opt.init(_map(jnp.asarray, params)))(
        jnp.arange(N))
    ref_step = jax.jit(lambda xs, gs, st: jax.vmap(
        lambda x, g, s: ref_opt.step(comm, x, g, s), axis_name="w")(
            xs, gs, st))
    tx = _map(lambda a: torch.from_numpy(
        np.broadcast_to(a, (N,) + a.shape).copy()), params)
    ts = port_opt.init(tx)
    assert sorted(ts.slots) == sorted(rs.slots)
    for t in range(STEPS):
        rx, rs, rm = ref_step(rx, _map(jnp.asarray, grads[t]), rs)
        tx, ts, tm = port_opt.step(SimComm(N), tx,
                                   _map(torch.from_numpy, grads[t]), ts)
        assert tm["synced"] == bool(rm["synced"][0]) == EXPECT_SYNC[t]
        assert tm["var_round"] == bool(rm["var_round"][0]) == expect_var[t]
        assert tm["lr"] == np.asarray(rm["lr"])[0]
        for i, (a, b) in enumerate(zip(flatten_tree(tx)[1],
                                       jax.tree.leaves(rx))):
            _close(a, b, f"step {t} params leaf {i}")
        pairs = [(f"slot {k}", ts.slots[k], rs.slots[k]) for k in ts.slots]
        for name_, got, want in pairs + [
                ("u", ts.u, rs.u), ("err_w", ts.err_w, rs.err_w),
                ("err_s", ts.err_s, rs.err_s)]:
            for i, (a, b) in enumerate(zip(got, want)):
                _close(a, b, f"step {t} {name_} leaf {i}")
        assert ts.step == int(rs.step[0])
        assert ts.gamma_acc == np.asarray(rs.gamma_acc)[0]
    return ts


@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
def test_zero_one_sgd_trajectory_matches_reference(ref_pallas):
    ts = _run_both("zero_one_sgd", "tensor", ref_pallas, [False] * STEPS)
    assert sorted(ts.slots) == ["m"]


@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
@pytest.mark.parametrize("mode", ["chunk", "row"])
def test_zero_one_adam_scale_modes_trajectory_matches_reference(mode,
                                                                ref_pallas):
    ts = _run_both("zero_one_adam", mode, ref_pallas, EXPECT_VAR)
    assert sorted(ts.slots) == ["m", "v"]


def test_policies_match_reference_over_40k_steps():
    """T_u / T_v decisions and intervals at the production defaults
    (warmup 12500, double_every 32768, H=16, kappa=16), step for step."""
    T = 40_000
    r_sync = RS.LrProportionalSyncPolicy(12500, 32768, 16)
    r_var = RS.AdaptiveFreezePolicy(kappa=16)

    def body(carry, t):
        sp, vp = carry
        fire, sp, iv = r_sync.step(sp, t)
        vfire, vp = r_var.step(vp, t, iv)
        return (sp, vp), (fire, vfire, iv)

    _, (rf, rv, ri) = jax.jit(lambda: jax.lax.scan(
        body, (r_sync.init(), r_var.init()), jnp.arange(T)))()
    p_sync = TS.LrProportionalSyncPolicy(12500, 32768, 16)
    p_var = TS.AdaptiveFreezePolicy(kappa=16)
    sp, vp = p_sync.init(), p_var.init()
    got = np.zeros((3, T), np.int64)
    for t in range(T):
        fire, sp, iv = p_sync.step(sp, t)
        vfire, vp = p_var.step(vp, t, iv)
        got[:, t] = (fire, vfire, iv)
    np.testing.assert_array_equal(got[0], np.asarray(rf))
    np.testing.assert_array_equal(got[1], np.asarray(rv))
    np.testing.assert_array_equal(got[2], np.asarray(ri))
    assert got[1].sum() > 100 and got[0].sum() > 1000


def test_lr_schedule_matches_reference():
    """f32 learning rates; the decay power is libm's powf against XLA's
    pow, held to 1 ulp."""
    ref = RS.LinearWarmupExpDecay(peak_lr=3e-3, warmup_steps=20, decay=0.99,
                                  decay_period=7)
    port = TS.LinearWarmupExpDecay(peak_lr=3e-3, warmup_steps=20,
                                   decay=0.99, decay_period=7)
    want = np.asarray(jax.vmap(ref)(jnp.arange(300)), np.float32)
    got = np.array([port(t) for t in range(300)], np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    np.testing.assert_array_equal(got[:20], want[:20])   # warmup: exact
    assert TS.ConstantLr(1e-3)(5) == np.asarray(RS.ConstantLr(1e-3)(5))


def test_unported_optimizers_raise():
    """Every registry name of the reference is ported (the LAMB names
    too); an unknown name raises ValueError."""
    from repro.core.api import REGISTRY_NAMES as REF_NAMES
    for name in ("lamb", "one_bit_lamb", "zero_one_lamb"):
        TA.OptimizerConfig(name=name)
    with pytest.raises(ValueError):
        TA.OptimizerConfig(name="nope")
    assert TA.REGISTRY_NAMES == REF_NAMES
    assert set(TA.REGISTRY_NAMES) == {
        "adam", "lamb", "momentum_sgd", "one_bit_adam", "one_bit_lamb",
        "zero_one_adam", "zero_one_lamb", "zero_one_sgd"}


def test_weight_decay_in_accumulate_style_raises_as_reference():
    """Both packages refuse a decay term in the accumulate style, for
    the same reason, and take it in the gradient and mean styles."""
    for name in ("zero_one_adam", "zero_one_sgd"):
        with pytest.raises(ValueError, match="accumulate style") as ref:
            ref_build(RefOptimizerConfig(name=name, weight_decay=0.01),
                      {"w": jnp.zeros((4, 8))}, n_workers=N)
        with pytest.raises(ValueError, match="accumulate style") as port:
            TA.build_optimizer(TA.OptimizerConfig(name=name,
                                                  weight_decay=0.01),
                               {"w": (4, 8)}, n_workers=N)
        assert str(port.value) == str(ref.value)
    for name in ("adam", "momentum_sgd", "one_bit_adam"):
        TA.build_optimizer(TA.OptimizerConfig(name=name, weight_decay=0.01),
                           {"w": (4, 8)}, n_workers=N)
    with pytest.raises(ValueError, match="style"):
        TC_DP.compressed_dp(TA.adam_base(), style="nope")


def test_baseline_policies_match_reference():
    """FixedWarmupPolicy, EveryStepVariancePolicy and EveryStepSyncPolicy,
    step for step over 300 steps, with their (empty) carried states."""
    T = 300
    cases = [(RS.FixedWarmupPolicy(16), TS.FixedWarmupPolicy(16)),
             (RS.FixedWarmupPolicy(0), TS.FixedWarmupPolicy(0)),
             (RS.EveryStepVariancePolicy(), TS.EveryStepVariancePolicy())]
    for ref, port in cases:
        assert ref.init() == port.init() == ()
        want = np.asarray(jax.vmap(lambda t: ref.step((), t, 1)[0])(
            jnp.arange(T)))
        got = [port.step((), t, 1)[0] for t in range(T)]
        np.testing.assert_array_equal(np.array(got), want)
        assert port.step((), 0, 1)[1] == ()
    ref, port = RS.EveryStepSyncPolicy(), TS.EveryStepSyncPolicy()
    assert ref.init() == port.init() == ()
    for t in (0, 1, 12345):
        fire, st, iv = ref.step((), jnp.int32(t))
        assert port.step((), t) == (bool(fire), st, int(iv)) == (True, (), 1)


@pytest.mark.parametrize("peak,warmup,total,min_lr", [
    (3e-3, 20, 40_000, 1e-5), (1.5e-4, 3000, 40_000, 1e-5),
    (6e-4, 2000, 30_000, 6e-5), (1e-3, 0, 5000, 0.0), (3e-4, 20, 8, 1e-5)])
def test_cosine_schedule_matches_reference_bitwise(peak, warmup, total,
                                                   min_lr):
    """LinearWarmupCosine, f32 bit for bit over 40k steps (past the end of
    the cycle too), against the reference under jit (which gives the
    same bits vmapped or per step)."""
    T = 40_000
    ref = RS.LinearWarmupCosine(peak_lr=peak, warmup_steps=warmup,
                                total_steps=total, min_lr=min_lr)
    port = TS.LinearWarmupCosine(peak_lr=peak, warmup_steps=warmup,
                                 total_steps=total, min_lr=min_lr)
    want = np.asarray(jax.jit(jax.vmap(ref))(jnp.arange(T)), np.float32)
    got = np.array([port(t) for t in range(T)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert all(type(port(t)) is np.float32 for t in (0, warmup, T - 1))


# 1-bit Adam's full-precision stage: steps 0-1 (onebit_warmup=2)
ONE_BIT_VAR = [True, True] + [False] * (STEPS - 2)
BASELINES = {   # id -> (registry name, config fields, var rounds)
    "adam": ("adam", {}, [True] * STEPS),
    "adam-wd": ("adam", {"weight_decay": 0.01}, [True] * STEPS),
    "momentum_sgd": ("momentum_sgd", {}, [False] * STEPS),
    "momentum_sgd-wd": ("momentum_sgd", {"weight_decay": 0.01},
                        [False] * STEPS),
    "one_bit_adam": ("one_bit_adam", {"onebit_warmup": 2}, ONE_BIT_VAR),
    "one_bit_adam-2x2": ("one_bit_adam", {"onebit_warmup": 2, "inner": 2},
                         ONE_BIT_VAR),
}


def _baseline_setup(name, fields, ref_pallas):
    """Both packages' optimizers for a baseline, the reference's jitted
    step over the stacked workers (the two-level case: pods of ``inner``
    under a nested vmap, outer-major as the port) and both initial
    params and states."""
    fields = dict(fields)
    inner = fields.pop("inner", None)
    params, grads = _inputs()
    ref_cfg = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(1e-2), use_pallas=ref_pallas,
        hierarchy=RefHierarchy(inner=inner) if inner else None, **fields)
    port_cfg = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(1e-2),
        hierarchy=Hierarchy(inner) if inner else None, **fields)
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
        fold = lambda a: a.reshape((N // inner, inner) + a.shape[1:])
        unfold = lambda a: a.reshape((N,) + a.shape[2:])
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
    return (grads, ref_opt, port_opt, ref_step, rx, rs, tx,
            port_opt.init(tx))


def _baseline_run(name, fields, ref_pallas):
    """8 steps of a baseline on both packages; yields, per step, the port's
    (params, state, metrics) and the reference's, workers stacked."""
    grads, _, port_opt, ref_step, rx, rs, tx, ts = _baseline_setup(
        name, fields, ref_pallas)
    for t in range(STEPS):
        rx, rs, rm = ref_step(rx, _map(jnp.asarray, grads[t]), rs)
        tx, ts, tm = port_opt.step(SimComm(N), tx,
                                   _map(torch.from_numpy, grads[t]), ts)
        yield tx, ts, tm, rx, rs, rm


def _equal_share(got, want):
    return float((got.numpy() == np.asarray(want)).mean())


@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
@pytest.mark.parametrize("case", list(BASELINES))
def test_baseline_trajectory_matches_reference(case, ref_pallas):
    name, fields, expect_var = BASELINES[case]
    shares, ef_shares = [], []
    for t, (tx, ts, tm, rx, rs, rm) in enumerate(
            _baseline_run(name, fields, ref_pallas)):
        assert tm["synced"] is True and bool(rm["synced"][0])
        assert tm["var_round"] == bool(rm["var_round"][0]) == expect_var[t]
        assert tm["interval"] == 1 == int(rm["interval"][0])
        assert tm["lr"] == np.asarray(rm["lr"])[0]
        assert ts.step == int(rs.step[0]) == t + 1
        assert (ts.sync_pstate, ts.var_pstate) == ((), ())
        assert ts.u == [None] * len(ts.u) and ts.anchor == ts.u
        full_precision = name != "one_bit_adam" or expect_var[t]
        for k in ts.slots:
            for i, (a, b) in enumerate(zip(ts.slots[k], rs.slots[k])):
                if full_precision:
                    np.testing.assert_array_equal(
                        a.numpy(), np.asarray(b),
                        err_msg=f"step {t} slot {k} leaf {i}")
                else:
                    _close(a, b, f"step {t} slot {k} leaf {i}")
        for i, (a, b) in enumerate(zip(flatten_tree(tx)[1],
                                       jax.tree.leaves(rx))):
            if name == "momentum_sgd":
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            _close(a, b, f"step {t} params leaf {i}")
            shares.append(_equal_share(a, b))
        if name == "one_bit_adam":
            for k in ("err_w", "err_s"):
                for i, (a, b) in enumerate(zip(getattr(ts, k),
                                               getattr(rs, k))):
                    if expect_var[t]:   # untouched by the warmup rounds
                        assert not a.any() and not np.asarray(b).any()
                    _close(a, b, f"step {t} {k} leaf {i}")
                    ef_shares.append(_equal_share(a, b))
        else:
            assert all(e is None for e in ts.err_w + ts.err_s)
    print(case, "params bit for bit", np.mean(shares), "EF",
          np.mean(ef_shares) if ef_shares else None)


@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
def test_one_bit_step_from_reference_state(ref_pallas):
    """One 1-bit step of ``one_bit_adam`` (step 3) from the reference's
    params and state after step 2, carried into the port by ``interop``.
    The step's new worker EF is the port's compress of ``g + err_w``, bit
    for bit; that compress against the reference's, on the same input:
    the same packed bits, and the EF bit for bit for every (leaf,
    worker) whose scale is bit for bit the reference's (the rest differ
    by the scale's few ulp). The reference's own step sums the scale of
    some leaves in another order than its compress alone (XLA fuses it
    into the step), so the steps' EF, m and params are held to
    ``_close``; the frozen variance is bit for bit."""
    grads, ref_opt, port_opt, ref_step, rx, rs, _, _ = _baseline_setup(
        "one_bit_adam", {"onebit_warmup": 2}, ref_pallas)
    for t in range(3):
        rx, rs, _ = ref_step(rx, _map(jnp.asarray, grads[t]), rs)
    tx = interop.params_from_reference(jax.device_get(rx))
    ts = interop.state_from_reference(jax.device_get(rs), port_opt)
    assert ts.var_pstate == () and any(e.any() for e in ts.err_w)
    g3 = grads[3]
    rx, rs_new, _ = ref_step(rx, _map(jnp.asarray, g3), rs)
    # the step updates its state in place: step a clone, and read the
    # state from before the step below
    tx, ts_new, tm = port_opt.step(SimComm(N), tx,
                                   _map(torch.from_numpy, g3), ts.clone())
    assert not tm["var_round"]
    equal_scales = 0
    for i, (g, lo_t, lo_r) in enumerate(zip(
            flatten_tree(g3)[1], port_opt.layouts, ref_opt.layouts)):
        gv = TC.to_view(torch.from_numpy(g), lo_t)
        packed, scales, err = K.ef_compress_view(gv, ts.err_w[i], lo_t,
                                                 "tensor")
        assert torch.equal(err, ts_new.err_w[i]), i
        m_r = RC.pad_mask(lo_r)
        zr = jax.vmap(lambda a: RC.to_view(a, lo_r))(jnp.asarray(g))
        p_r, s_r, e_r = jax.vmap(lambda a: RC.ef_compress(
            a, lo_r, "tensor", m_r))(zr + jnp.asarray(rs.err_w[i]))
        np.testing.assert_array_equal(packed.numpy(), np.asarray(p_r))
        for w in range(N):
            if scales[w].reshape(-1)[0] == np.asarray(s_r[w]).reshape(-1)[0]:
                equal_scales += 1
                np.testing.assert_array_equal(
                    err[w].numpy(), np.asarray(e_r[w]), err_msg=f"{i} {w}")
            _close(ts_new.err_w[i][w], rs_new.err_w[i][w], f"{i} {w}")
        np.testing.assert_array_equal(ts_new.slots["v"][i].numpy(),
                                      np.asarray(rs_new.slots["v"][i]))
        _close(ts_new.slots["m"][i], rs_new.slots["m"][i], f"m {i}")
    # measured: 11 of the 20 (leaf, worker) scales bit for bit
    assert equal_scales >= N * len(port_opt.layouts) // 4, equal_scales
    for a, b in zip(flatten_tree(tx)[1], jax.tree.leaves(rx)):
        _close(a, b, "params")


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - np.asarray(b, np.float32).view(np.int32).astype(
        np.int64))


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01),
                                     ("momentum_sgd", 0.0),
                                     ("momentum_sgd", 0.01)])
def test_sync_step_forms_are_xlas(name, wd):
    """The forms the plain step of the gradient and mean styles takes,
    against the reference's own trajectory (8 steps, every leaf), each
    computed from the reference's params and state before a step: the
    single-rounding forms give its m', v' and momentum SGD's params bit
    for bit, and plain f32 or the other contraction does not (printed:
    their shares of equal elements). The reference's rsqrt is within 1
    ulp of the correctly rounded one the CPU path computes, so Adam's
    params are not bit for bit; their FMA form matches more of them than
    the plain one (printed)."""
    from repro_torch.core import onebit_allreduce as TAR
    from repro_torch.kernels import fused_adam as FA

    grads, _, port_opt, ref_step, rx, rs, _, _ = _baseline_setup(
        name, {"weight_decay": wd}, False)
    f32 = lambda a: float(np.float32(a))   # noqa: E731
    b1, omb1, b2, omb2 = f32(0.9), f32(1 - 0.9), f32(0.999), f32(1 - 0.999)
    lr, lr_wd = f32(1e-2), f32(np.float32(1e-2) * np.float32(wd))
    shares = {}

    def count(key, got, want):
        n = shares.setdefault(key, [0, 0])
        n[0] += int((np.asarray(got) == np.asarray(want)).sum())
        n[1] += np.asarray(want).size

    for t in range(STEPS):
        rx0, rs0 = rx, rs
        rx, rs, _ = ref_step(rx, _map(jnp.asarray, grads[t]), rs)
        for i, (g, x0, x1, lo) in enumerate(zip(
                flatten_tree(grads[t])[1], jax.tree.leaves(rx0),
                jax.tree.leaves(rx), port_opt.layouts)):
            g = TAR.fullprec_allreduce_view(
                SimComm(N), TC.to_view(torch.from_numpy(g), lo))
            x0 = torch.from_numpy(np.array(x0))
            m0 = torch.from_numpy(np.array(rs0.slots["m"][i]))
            m1 = np.asarray(rs.slots["m"][i])
            np.testing.assert_array_equal(
                FA.fma(m0, b1, g * omb1).numpy(), m1)
            count("m' plain", m0 * b1 + g * omb1, m1)
            count("m' other fma", FA.fma(g, omb1, m0 * b1), m1)
            m1 = torch.from_numpy(m1)
            if name == "momentum_sgd":
                step = TC.from_view(m1, lo)
                want = (x0 - FA.fma(x0, lr_wd, step * lr) if wd
                        else FA.fma(step, -lr, x0))
                np.testing.assert_array_equal(want.numpy(), x1)
                count("x' plain", x0 - (step * lr + x0 * lr_wd if wd
                                        else step * lr), x1)
                continue
            v0 = torch.from_numpy(np.array(rs0.slots["v"][i]))
            v1 = np.asarray(rs.slots["v"][i])
            np.testing.assert_array_equal(
                FA.fma(v0, b2, (g * omb2) * g).numpy(), v1)
            count("v' plain", v0 * b2 + (g * omb2) * g, v1)
            count("v' other fma", FA.fma(g * omb2, g, v0 * b2), v1)
            ve = v0 + f32(1e-8)
            d = _ulps(FA.rsqrt(ve).numpy(),
                      np.asarray(jax.lax.rsqrt(jnp.asarray(ve.numpy()))))
            assert d.max() <= 1
            count("rsqrt", d, np.zeros_like(d))
            step = TC.from_view(m1 * lr, lo)
            r = TC.from_view(FA.rsqrt(ve), lo)
            if wd:
                count("x' fma form", x0 - FA.fma(x0, lr_wd, step * r), x1)
                count("x' plain", x0 - (step * r + x0 * lr_wd), x1)
            else:
                count("x' fma form", FA.fma(-step, r, x0), x1)
                count("x' plain", x0 - step * r, x1)
                count("x' plain divide",
                      x0 - step / TC.from_view(torch.sqrt(ve), lo), x1)
    shares = {k: a / n for k, (a, n) in shares.items()}
    print(name, wd, "shares of equal elements", shares)
    assert all(shares[k] < 1 for k in shares
               if k.endswith(("plain", "other fma", "divide")))
    if name == "adam":
        assert shares["x' fma form"] > shares["x' plain"]
