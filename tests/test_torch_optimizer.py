"""Port ``zero_one_adam`` (every scale mode) and ``zero_one_sgd`` vs the
reference, live in one process: the same numpy gradients fed to both for
8 steps, and the T_u / T_v policies and lr schedule step for step.

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
from repro.core.comm import sim_comm

from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.comm import SimComm
from repro_torch.core.leafwise import flatten_tree

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
    with pytest.raises(NotImplementedError):
        TA.OptimizerConfig(name="one_bit_adam")
    with pytest.raises(ValueError):
        TA.OptimizerConfig(name="nope")
