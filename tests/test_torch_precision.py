"""Production precision (bf16 parameters, compute and optimizer state;
``store_anchor=False``) in the port against the reference, live in one
process, from numpy inputs made from a seed.

Optimizer alone (shapes of ``test_torch_optimizer``, 4 workers, 8 steps:
syncs at 0-4 and 6, variance at 0, 1, 3; lr 1e-2) at
``state_dtype=bf16``, every style: the state rounds to bf16 once per
step on both sides, so where the two packages' f32 values agree it is
bit for bit. Measured bars, each case's own:
* ``u`` and ``v`` bit for bit, and at f32 params ``m`` (the accumulate
  and mean styles) and the per-leaf server EF (accumulate): measured
  100%; LAMB's f32 trust within 8 ulp (its norms summed in another
  order, as ``tests/test_torch_lamb.py``);
* the EF state where its scales are f32 sums in another order than
  XLA's: at most 0.31% of elements unequal (measured 0-0.31%: the
  reference's own jnp and Pallas paths differ in 0.31% of m at bf16
  params here, in up to 0.03% of the f32-params cases' EF, and in 0.2%
  of gpt2-smoke's err_w after one sync), each
  within 1% of the leaf's largest magnitude (a sign flip of a near-zero
  element moves it by two scales; measured 1.9e-3 against magnitudes
  ~1);
* the gradient style's m, carrying the 1-bit mean, and at bf16 params
  (where the reference's compiled exchange sums in yet another order)
  ``m`` and the server EF: as the EF state;
* f32 params within 1e-5 relative plus 1e-5 (the re-anchor divides by
  ``sqrt(v + eps)`` where XLA multiplies by an approximate ``rsqrt``;
  measured 8.8e-6); bf16 params with the anchor bit for bit (measured
  100%). Without the anchor, bf16 params take x_half = (x - delta)
  rounded to bf16 and then x_half + precond(u' - ubar), rounded again:
  at most 1.5% of params unequal, each within 5% of the leaf's largest
  magnitude (measured 1.28%, 3.2%), looser than the reference's own
  jnp-vs-Pallas gap (0.41%) for a measured cause: the kernel's delta is
  the correctly rounded quotient ``lr*m' / sqrt(v + eps)`` (ROADMAP §2),
  while XLA compiles the reference's (both paths) as a multiply by the
  reciprocal, 1 ulp apart in 20-80% of elements at step 0; with bf16
  params and gradients x - delta lies within an f32 ulp of a bf16
  rounding midpoint often, so x_half rounds the other way in 1-2% of
  elements. With the delta computed the reference's way (test-only, on
  the CPU path) the port is bit for bit the reference's Pallas path and
  0.41% from its jnp path, its own gap: asserted below.

Trainers (sim mode, 4 workers, batch 8 x 32, 8 steps, the schedule
above) at bf16 params, compute and state, from the reference's draw on
its batches: the forward and backward passes run bf16 products in
another order on each side (the step-0 losses differ by 4e-5 / 3e-4),
and the bf16 parameters round every update, so the gaps grow along the
trajectory. Params are held in bf16 ulps, a bar relative to each
element: a share within ULP_BAR (2) ulps of the reference's. gpt2-smoke
at lr 1e-3 with and without the anchor: losses within 1e-2 a step
(measured 4.7e-3 / 7.5e-3), 55% of params within 2 ulps (measured
69.2% / 64.5%); bert-smoke (masked LM) at lr 3e-4 (at 1e-3 both
packages' runs spike at step 6 and part chaotically, as at f32; at 5e-4
the spike begins): losses within 5e-3 (measured 1.7e-3), 80% of params
within 2 ulps (measured 89.3%). The bars have power: over the 8 steps
at least 80% of the reference's params move more than 2 ulps (measured
87.7-90.1%, a median of 37-74 ulps), so a port that never updated them
would fail the share; and the port with sync step 6's update left out
fails both bars (measured 22.4-26.4% of params within 2 ulps, and a
step-7 loss gap of 0.088-0.26), asserted in every case. The step kinds
equal the reference's at every step.
"""
import copy
import dataclasses
import functools
import importlib
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpointing import io as ref_io
from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import build_optimizer as ref_build
from repro.core import compressed_dp as ref_compressed_dp
from repro.core import schedules as RS
from repro.core.base_steps import lamb_base as ref_lamb_base
from repro.core.comm import sim_comm
from repro.core.compressed import CompressedDPState as RefState
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.train import Trainer as RefTrainer

from repro_torch import analysis, interop
from repro_torch import elastic as E
from repro_torch.checkpointing import io as port_io
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import base_steps as TB
from repro_torch.core import compressed as TC
from repro_torch.core import schedules as TS
from repro_torch.core.comm import SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.kernels import fused_adam as FA
from repro_torch.launch import mesh
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import transformer as TT
from repro_torch.train import step as TSTEP

# the reference's reshard module (its package re-exports a function of
# the same name)
RR = importlib.import_module("repro.elastic.reshard")

torch.set_num_threads(1)

N, STEPS, B, S = 4, 8, 8, 32
BF = torch.bfloat16
SHAPES = {"w": (6, 16), "b": (5,), "deep": {"k": (3, 8, 8)},
          "s": (13, 40), "t": (6, 4, 24)}
REF_SPECS = {"w": None, "b": None, "deep": {"k": None},
             "s": P(None, "model"), "t": P(None, None, "model")}
PORT_SPECS = {"w": None, "b": None, "deep": {"k": None},
              "s": (None, "model"), "t": (None, None, "model")}
EXPECT_SYNC = [True, True, True, True, True, False, True, False]
EXPECT_VAR = [True, True, False, True, False, False, False, False]
EF_UNEQUAL = 3.1e-3     # share of EF elements that may differ
EF_REL = 1e-2           # of the leaf's largest magnitude
BF16_PARAMS_UNEQUAL = 1.5e-2   # anchor-free bf16 params (docstring)
BF16_PARAMS_REL = 5e-2
TRUST_ULPS = 8          # LAMB's trust, as tests/test_torch_lamb.py


def _map(f, t):
    return {k: _map(f, v) if isinstance(v, dict) else f(v)
            for k, v in t.items()}


def _leaves(t):
    out = []
    for k in sorted(t):
        out += _leaves(t[k]) if isinstance(t[k], dict) else [t[k]]
    return out


def _f32(a):
    """A reference array or port tensor as f32 numpy (exact from bf16)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def _np(t):
    """A port tensor as numpy in its dtype (bf16: ml_dtypes' type, as the
    reference's arrays are)."""
    if t.dtype == BF:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# (name, reference's use_pallas, optimizer overrides, bf16 params); the
# fields held bit for bit (the rest of the state to the EF bars)
OPT_CASES = {
    "zero_one_adam": ("zero_one_adam", False, {}, False),
    "zero_one_adam-ref_pallas": ("zero_one_adam", True, {}, False),
    "zero_one_adam-row": ("zero_one_adam", False,
                          {"scale_mode": "row"}, False),
    "zero_one_adam-bucketed": ("zero_one_adam", False,
                               {"bucket_mb": 0.001}, False),
    "zero_one_adam-no_anchor": ("zero_one_adam", False,
                                {"store_anchor": False}, False),
    "zero_one_adam-bf16_params": ("zero_one_adam", False, {}, True),
    "zero_one_adam-bf16_params-no_anchor": (
        "zero_one_adam", False, {"store_anchor": False}, True),
    "zero_one_sgd": ("zero_one_sgd", False, {}, False),
    "zero_one_sgd-no_anchor": ("zero_one_sgd", False,
                               {"store_anchor": False}, False),
    "zero_one_lamb": ("zero_one_lamb", False, {}, False),
    "adam": ("adam", False, {}, False),
    "lamb": ("lamb", False, {}, False),
    "one_bit_adam": ("one_bit_adam", False, {}, False),
    "one_bit_lamb": ("one_bit_lamb", False, {}, False),
}


def _opt_pair(name, ref_pallas, over, jparams, n=N):
    """The reference's and the port's optimizer of ``name`` at bf16
    state, bound to ``n`` workers."""
    common = dict(name=name, onebit_warmup=2, **over)
    ref_cfg = RefOptimizerConfig(
        lr=RS.ConstantLr(1e-2), var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2),
        state_dtype=jnp.bfloat16, use_pallas=ref_pallas, **common)
    port_cfg = TA.OptimizerConfig(
        lr=TS.ConstantLr(1e-2), var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2), state_dtype=BF,
        **common)
    return (ref_build(ref_cfg, jparams, specs=REF_SPECS, n_workers=n),
            TA.build_optimizer(port_cfg, SHAPES, specs=PORT_SPECS,
                               n_workers=n))


def _run_optimizers(name, ref_pallas, over, bf16_params):
    """8 steps of both optimizers from the same numpy draw: (the
    reference's params and state, the port's, the port's optimizer, the
    reference's optimizer, the reference's params before the steps)."""
    rng = np.random.default_rng(0)
    params = _map(lambda s: rng.standard_normal(s).astype(np.float32),
                  SHAPES)
    grads = [_map(lambda s: rng.standard_normal((N,) + s).astype(
        np.float32), SHAPES) for _ in range(STEPS)]
    jdt, tdt = ((jnp.bfloat16, BF) if bf16_params
                else (jnp.float32, torch.float32))
    jparams = _map(lambda a: jnp.asarray(a, jdt), params)
    ref_opt, port_opt = _opt_pair(name, ref_pallas, over, jparams)
    comm = sim_comm("w")
    rx = _map(lambda a: jnp.broadcast_to(a, (N,) + a.shape) + 0, jparams)
    rs = jax.vmap(lambda _: ref_opt.init(jparams))(jnp.arange(N))
    ref_step = jax.jit(lambda xs, gs, st: jax.vmap(
        lambda x, g, s: ref_opt.step(comm, x, g, s), axis_name="w")(
            xs, gs, st))
    tx = _map(lambda a: torch.from_numpy(
        np.broadcast_to(a, (N,) + a.shape).copy()).to(tdt), params)
    ts = port_opt.init(tx)
    for t in range(STEPS):
        rx, rs, rm = ref_step(rx, _map(lambda a: jnp.asarray(a, jdt),
                                       grads[t]), rs)
        tx, ts, tm = port_opt.step(
            SimComm(N), tx, _map(lambda a: torch.from_numpy(a).to(tdt),
                                 grads[t]), ts)
        assert tm["synced"] == bool(rm["synced"][0]), t
        assert tm["var_round"] == bool(rm["var_round"][0]), t
    return (jax.device_get(rx), jax.device_get(rs), tx, ts, port_opt,
            ref_opt, jparams)


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def _pairs(ref_list, port_list):
    return [(r, p) for r, p in zip(ref_list, port_list) if r is not None]


def _check_ef(pairs, what):
    n = sum(np.asarray(r).size for r, _ in pairs)
    unequal = sum(int((_f32(r) != _f32(p)).sum()) for r, p in pairs)
    assert unequal <= EF_UNEQUAL * n, (what, unequal, n)
    for r, p in pairs:
        r32, p32 = _f32(r), _f32(p)
        scale = float(np.abs(r32).max()) if r32.size else 0.0
        assert np.abs(r32 - p32).max(initial=0.0) <= EF_REL * scale, what
    return unequal / max(n, 1)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_at_bf16_state_matches_reference(case):
    name, ref_pallas, over, bf16_params = OPT_CASES[case]
    rx, rs, tx, ts, opt, _, _ = _run_optimizers(name, ref_pallas, over,
                                                bf16_params)
    style = opt.cfg.style
    # every state leaf in the reference's dtype
    for field in ("u", "err_w", "err_s", "anchor"):
        for r, p in zip(getattr(rs, field), getattr(ts, field)):
            assert (r is None) == (p is None), field
            if r is not None:
                assert str(np.asarray(r).dtype) == str(p.dtype).replace(
                    "torch.", ""), field
    exact = ["u", "v"]
    if style != "gradient" and not bf16_params:
        exact.append("m")
    if style == "accumulate" and not (over.get("bucket_mb")
                                      or bf16_params):
        exact.append("err_s")
    fracs = {}
    for field in ("u", "err_w", "err_s"):
        pairs = _pairs(getattr(rs, field), getattr(ts, field))
        if field in exact:
            for r, p in pairs:
                assert np.array_equal(_f32(r), _f32(p)), field
        elif pairs:
            fracs[field] = _check_ef(pairs, field)
    for slot in rs.slots:
        pairs = _pairs(rs.slots[slot], ts.slots[slot])
        if slot == "trust":     # f32 norms summed in another order
            for r, p in pairs:
                assert _ulps(_f32(r), _f32(p)) <= TRUST_ULPS
        elif slot in exact:
            for r, p in pairs:
                assert np.array_equal(_f32(r), _f32(p)), slot
        else:
            fracs[slot] = _check_ef(pairs, slot)
    rp, tp = _leaves(rx), _leaves(tx)
    if bf16_params and opt.cfg.store_anchor:
        for r, p in zip(rp, tp):
            assert np.array_equal(_f32(r), _f32(p))
    elif bf16_params:
        share = _unequal_share(rp, tp)
        print(case, "bf16 params unequal", share)
        assert share <= BF16_PARAMS_UNEQUAL
        for r, p in zip(rp, tp):
            r32, p32 = _f32(r), _f32(p)
            assert np.abs(r32 - p32).max() <= BF16_PARAMS_REL * np.abs(
                r32).max()
    else:
        for r, p in zip(rp, tp):
            np.testing.assert_allclose(_f32(p), _f32(r), rtol=1e-5,
                                       atol=1e-5)
    print(case, "unequal shares", fracs)


def _unequal_share(xs, ys):
    return 1 - np.mean(np.concatenate(
        [(_f32(x) == _f32(y)).ravel() for x, y in zip(xs, ys)]))


def _local_step_with_xla_delta_(g, m, u, v, lr, beta1, eps=1e-8, d=None,
                                u_out=None):
    """``fused_adam.fused_local_step_plain_`` with the delta computed as
    XLA compiles the reference's ``lr*m' / sqrt(v + eps)``: a multiply by
    the reciprocal root (``fused_adam.rsqrt``), not the kernel's
    correctly rounded divide."""
    lr32, b1, omb1, eps32 = FA._scalars(lr, beta1, eps)
    mh = FA.fma_f32(FA._f32(m), b1, FA._f32(g) * omb1)
    delta = (mh * lr32) * FA.rsqrt(FA._f32(v) + eps32)
    (u if u_out is None else u_out).copy_(FA.fma_f32(mh, lr32, FA._f32(u)))
    m.copy_(mh)
    return delta if d is None else d.copy_(delta)


def test_anchor_free_bf16_params_gap_is_the_delta_divide(monkeypatch):
    """The anchor-free bf16-params case with its delta (CPU path)
    computed as XLA computes the reference's: the params are bit for bit
    the reference's Pallas path, and as far from its jnp path as the
    reference's own two paths are from each other (measured 0 and 0.41%
    of params), so the rest of ``BF16_PARAMS_UNEQUAL`` is the kernel's
    divide alone."""
    monkeypatch.setattr(FA, "fused_local_step_plain_",
                        _local_step_with_xla_delta_)
    runs = {p: _run_optimizers("zero_one_adam", p, {"store_anchor": False},
                               True) for p in (False, True)}
    (jx, _, tx, *_), (px, *_) = runs[False], runs[True]
    ref_gap = _unequal_share(_leaves(jx), _leaves(px))
    got = _unequal_share(_leaves(jx), _leaves(tx))
    print("bf16 params unequal: port-jnp", got, "jnp-pallas", ref_gap)
    assert _unequal_share(_leaves(px), _leaves(tx)) == 0.0
    assert 0.0 < got <= ref_gap


def test_lamb_refuses_no_anchor_with_the_reference_text():
    with pytest.raises(ValueError, match="store_anchor") as ref:
        ref_compressed_dp(ref_lamb_base(), store_anchor=False)
    with pytest.raises(ValueError) as got:
        TC.compressed_dp(TB.lamb_base(), store_anchor=False)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as got:
        TA.build_optimizer(TA.OptimizerConfig(name="zero_one_lamb",
                                              store_anchor=False),
                           SHAPES, n_workers=N)
    assert str(got.value) == str(ref.value)
    # the other styles keep no anchor to refuse
    TA.build_optimizer(TA.OptimizerConfig(name="one_bit_lamb",
                                          store_anchor=False), SHAPES,
                       n_workers=N)


# --- trainers -------------------------------------------------------------

def _prec_cfgs(arch, anchor=True, lr=1e-3, name="zero_one_adam"):
    ref = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(lr),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2),
        state_dtype=jnp.bfloat16, store_anchor=anchor)
    port = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(lr),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2), state_dtype=BF,
        store_anchor=anchor)
    rm = dataclasses.replace(ref_get(arch).smoke, param_dtype=jnp.bfloat16,
                             compute_dtype=jnp.bfloat16)
    pm = dataclasses.replace(port_get(arch).smoke, param_dtype=BF,
                             compute_dtype=BF)
    return (rm, ref), (pm, port)


def _port_batch(b):
    return {k: torch.from_numpy(np.array(v)) if k == "loss_mask"
            else torch.from_numpy(np.array(v)).long() for k, v in b.items()}


@pytest.mark.parametrize("arch,kind", [("gpt2", "lm"), ("bert-base", "mlm")])
def test_forward_at_bf16_matches_reference(arch, kind):
    """The models at bf16 params and compute from the reference's draw
    (key 0) on its batch: logits bf16 on both sides, within two bf16
    ulps of their largest magnitude (the bf16 products round in another
    order; measured one ulp, 25% of them bit for bit), the loss within
    5e-4 (measured 1.4e-4 / 6.5e-5)."""
    (rm, _), (pm, _) = _prec_cfgs(arch)
    # the reference jitted (one compile each, not an eager dispatch of
    # every op)
    tmpl = RT.model_template(rm)
    rp = jax.jit(lambda k: RL.init_params(tmpl, k, dtype=jnp.bfloat16))(
        jax.random.PRNGKey(0))
    tp = interop.params_from_reference(jax.device_get(rp))
    b = RefSyntheticLM(RefDataConfig(vocab=rm.vocab, seq_len=S,
                                     global_batch=4, seed=0,
                                     kind=kind)).batch(0)
    rlog, _ = jax.jit(lambda p, b_: RT.forward(p, rm, b_))(rp, b)
    plog, _ = TT.forward(tp, pm, _port_batch(b))
    assert str(rlog.dtype) == "bfloat16" and plog.dtype == BF
    r32, p32 = _f32(rlog), _f32(plog)
    assert np.abs(r32 - p32).max() <= 2 * 2.0 ** -8 * np.abs(r32).max()
    rl = jax.jit(lambda p, b_: RT.lm_loss(p, rm, b_))(rp, b)
    pl = TT.lm_loss(tp, pm, _port_batch(b))
    rl, pl = (x[0] if isinstance(x, tuple) else x for x in (rl, pl))
    assert abs(float(rl) - float(pl)) <= 5e-4


# (arch, anchor, lr, data kind) -> bars (loss gap a step, share of params
# within ULP_BAR bf16 ulps of the reference's)
TRAINERS = {"gpt2": (("gpt2", True, 1e-3, "lm"), (1e-2, 0.55)),
            "gpt2-no_anchor": (("gpt2", False, 1e-3, "lm"), (1e-2, 0.55)),
            "bert": (("bert-base", True, 3e-4, "mlm"), (5e-3, 0.8))}
ULP_BAR = 2
# the share of the reference's params that move more than ULP_BAR ulps
# over the 8 steps
MOVED = 0.8
# the sync step the trainer cases leave out to show the bars' power
FAULT_STEP = 6


def _ordered(a):
    """bf16 values as integers in their order (adjacent values one apart,
    both zeros 0)."""
    hi = (np.ascontiguousarray(_f32(a)).view(np.uint32) >> 16).astype(
        np.int64)
    return np.where(hi & 0x8000, -(hi & 0x7FFF), hi)


def _ulps_apart(xs, ys):
    """Every element's distance in bf16 ulps, leaves concatenated."""
    return np.concatenate([np.abs(_ordered(x) - _ordered(y)).ravel()
                           for x, y in zip(xs, ys)])


@pytest.fixture(scope="module")
def trainer_runs():
    """Each TRAINERS case run once in both packages (the reference's
    trainer built and compiled once a case, and shared by the tests
    below), and the port's run again from step FAULT_STEP with that
    step's update left out: (flags, loss gaps, the ulps apart of the
    port's final params, of the reference's from its draw, of the
    faulty run's, the faulty run's last loss gap, the reference's final
    state, the port's trainer, params and state, the reference's
    trainer)."""
    cache = {}

    def run(key):
        if key in cache:
            return cache[key]
        (arch, anchor, lr, kind), _ = TRAINERS[key]
        (rm, rcfg), (pm, pcfg) = _prec_cfgs(arch, anchor, lr)
        rt = RefTrainer(rm, rcfg, n_workers=N)
        rp, rs = rt.sim_init(jax.random.PRNGKey(0))
        r0 = jax.tree.leaves(jax.device_get(rp))
        step = rt.sim_step_fn()
        pt = TSTEP.Trainer(pm, pcfg, comm=SimComm(N), device="cpu")
        tp = interop.params_from_reference(jax.device_get(rp))
        ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
        data = RefSyntheticLM(RefDataConfig(vocab=rm.vocab, seq_len=S,
                                            global_batch=B, seed=0,
                                            kind=kind))
        flags, gaps = [], []
        for t in range(STEPS):
            b = data.batch(t)
            if t == FAULT_STEP:
                skipped = (copy.deepcopy(tp), ts.clone())
            rp, rs, rmet = step(rp, rs, b)
            tp, ts, tm = pt.step(tp, ts, _port_batch(b))
            flags.append((tm["synced"], tm["var_round"],
                          bool(rmet["synced"][0]),
                          bool(rmet["var_round"][0])))
            gaps.append(abs(float(tm["loss"]) - float(rmet["loss"][0])))
        fp, fs = skipped
        for t in range(FAULT_STEP + 1, STEPS):
            fp, fs, fm = pt.step(fp, fs, _port_batch(data.batch(t)))
        fault_gap = abs(float(fm["loss"]) - float(rmet["loss"][0]))
        rl = jax.tree.leaves(jax.device_get(rp))
        cache[key] = (flags, gaps, _ulps_apart(rl, flatten_tree(tp)[1]),
                      _ulps_apart(rl, r0),
                      _ulps_apart(rl, flatten_tree(fp)[1]), fault_gap,
                      jax.device_get(rs), pt, tp, ts, rt)
        return cache[key]

    return run


@pytest.mark.parametrize("key", list(TRAINERS))
def test_trainer_at_production_precision_matches_reference(trainer_runs,
                                                           key):
    (flags, gaps, apart, moved, fault_apart, fault_gap, rs, pt, tp, ts,
     _) = trainer_runs(key)
    loss_bar, share_bar = TRAINERS[key][1]
    share, fault_share = ((apart <= ULP_BAR).mean(),
                          (fault_apart <= ULP_BAR).mean())
    print(key, "loss gaps", [f"{g:.2e}" for g in gaps], "params within",
          ULP_BAR, "ulps", share, "moved past", (moved > ULP_BAR).mean(),
          "fault: within", fault_share, "last loss gap", fault_gap)
    assert [f[:2] for f in flags] == [f[2:] for f in flags]
    assert [f[0] for f in flags] == EXPECT_SYNC
    assert [f[1] for f in flags] == EXPECT_VAR
    assert max(gaps) <= loss_bar
    assert share >= share_bar
    # the bars' power: the params move well past them, and the run
    # without step FAULT_STEP's update fails both
    assert (moved > ULP_BAR).mean() >= MOVED
    assert fault_share < share_bar and fault_gap > loss_bar
    # the state in the reference's dtypes, leaf for leaf
    got = port_io.flatten(interop.state_to_reference(ts))[1]
    want = jax.tree.leaves(rs)
    assert [str(np.asarray(w).dtype) for w in want] == [
        str(g.dtype).replace("torch.", "") if isinstance(g, torch.Tensor)
        else str(np.asarray(g).dtype) for g in got]
    assert {x.dtype for x in flatten_tree(tp)[1]} == {BF}


# --- interop, checkpoints, reshard, audit ------------------------------------

def _ref_state_from_port(state):
    s = interop.state_to_reference(state)
    lst = lambda xs: [None if x is None else jnp.asarray(_np(x)) for x in xs]
    j = jnp.asarray
    return RefState(step=j(s.step), gamma_acc=j(s.gamma_acc),
                    sync_pstate=tuple(j(v) for v in s.sync_pstate),
                    var_pstate=tuple(j(v) for v in s.var_pstate),
                    slots={k: lst(v) for k, v in s.slots.items()},
                    u=lst(s.u), err_w=lst(s.err_w), err_s=lst(s.err_s),
                    anchor=lst(s.anchor))


def _bits(x):
    a = _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def test_interop_keeps_bf16_state_both_ways(trainer_runs):
    """The reference's trained bf16 state into the port and back, bit for
    bit and dtype for dtype."""
    *_, rs, pt, _, _, _ = trainer_runs("gpt2")
    got = interop.state_from_reference(rs, pt.opt)
    assert got.slots["m"][0].dtype == BF
    back = _ref_state_from_port(got)
    for a, b in zip(jax.tree.leaves(rs), jax.tree.leaves(back)):
        assert _bits(a) == _bits(b)


def test_npz_checkpoints_of_bf16_state_both_ways(trainer_runs, tmp_path):
    """The port's production-precision checkpoint: its manifest and
    arrays those the reference writes for the same tree (bf16 leaves as
    numpy's raw 2-byte records, dtype ``bfloat16``); the port restores
    the reference's file and its own bit for bit; a restore into an f32
    state refuses with the reference's text. (The reference's own
    ``restore`` cannot read any bf16 leaf back: numpy casts no raw
    2-byte record to ml_dtypes' bfloat16.)"""
    *_, pt, tp, ts, _ = trainer_runs("gpt2")
    mine, theirs = tmp_path / "port.npz", tmp_path / "ref.npz"
    pt.save(str(mine), tp, ts, step=8)
    tree = pt.checkpoint_tree(tp, ts)
    ref_tree = {"params": jax.tree.map(lambda t: jnp.asarray(_np(t)),
                                       tree["params"]),
                "state": _ref_state_from_port(ts)}
    ref_io.save(str(theirs), ref_tree, step=8)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["__manifest__"] == b["__manifest__"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[
                k].tobytes(), k
    for path in (mine, theirs):
        params, state, step, _ = pt.restore(str(path))
        assert step == 8
        for a, b in zip(port_io.flatten(tree)[1], port_io.flatten(
                pt.checkpoint_tree(params, state))[1]):
            assert _bits(a) == _bits(b)
    (rm, rcfg), (pm, pcfg) = _prec_cfgs("gpt2")
    f32 = TSTEP.Trainer(pm, dataclasses.replace(pcfg,
                                                state_dtype=torch.float32),
                        comm=SimComm(N), device="cpu")
    with pytest.raises(ValueError, match="checkpoint dtype bfloat16 != "
                                         "expected float32 — restoring"):
        f32.restore(str(mine))


@pytest.mark.parametrize("over", [{}, {"bucket_mb": 0.001}],
                         ids=["per_leaf", "bucketed"])
def test_reshard_of_bf16_state_matches_reference(over):
    """4 -> 3 workers (worker 2 dead) on the bf16 state after the 8 steps
    of ``zero_one_adam`` at bf16 params (EF state per leaf and per
    bucket, ``u``, the bf16 anchors), bit for bit and dtype for dtype
    the reference's reshard of the same state."""
    _, rs, _, ts, opt, ref_opt, jparams = _run_optimizers(
        "zero_one_adam", False, over, True)
    ref3, port3 = _opt_pair("zero_one_adam", False, over, jparams, n=3)
    want = RR.reshard(_ref_state_from_port(ts), ref_opt, ref3,
                      survivors=(0, 1, 3))
    got = E.reshard(ts, opt, port3, survivors=(0, 1, 3))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    paths, leaves, _ = port_io.flatten(interop.state_to_reference(got))
    assert paths == [jax.tree_util.keystr(k) for k, _ in flat]
    for path, (_, a), b in zip(paths, flat, leaves):
        assert _bits(a) == _bits(b), path
    assert got.slots["m"][0].dtype == BF and got.anchor[0] is not None


@pytest.mark.parametrize("anchor", [True, False])
def test_audit_of_a_production_precision_run_is_clean(trainer_runs,
                                                      anchor):
    """gpt2-smoke at production precision on a recording comm, 8 steps,
    audited clean; its state leaves in the reference's trainer's dtypes
    (``jax.eval_shape`` of its ``sim_init``)."""
    args = TLAUNCH.parse_args([
        "--arch", "gpt2", "--smoke", "--mode", "sim", "--workers", str(N),
        "--steps", str(STEPS), "--batch", str(B), "--seq", str(S),
        "--sync-warmup", "2", "--double-every", "2", "--kappa", "1",
        "--device", "cpu", "--log-every", str(STEPS)])
    tr = TLAUNCH.make_trainer(
        args, comm=analysis.RecordingComm(SimComm(N)),
        configure=functools.partial(TLAUNCH.production, store_anchor=anchor))
    trace = analysis.watch(tr)
    res = TLAUNCH.train(args, tr)
    rep = analysis.audit_trainer(tr, trace=trace)
    assert rep.ok, [v.to_dict() for v in rep.violations[:3]]
    rt = trainer_runs("gpt2" if anchor else "gpt2-no_anchor")[-1]
    _, rs = jax.eval_shape(lambda: rt.sim_init(jax.random.PRNGKey(0)))
    got = port_io.flatten(interop.state_to_reference(res["state"]))[1]
    assert [str(w.dtype) for w in jax.tree.leaves(rs)] == [
        str(g.dtype).replace("torch.", "") if isinstance(g, torch.Tensor)
        else str(np.asarray(g).dtype) for g in got]


def test_two_gloo_ranks_at_bf16_state_match_their_simulated_workers(
        tmp_path, monkeypatch):
    """gpt2-smoke at production precision without the anchor in 2 gloo
    ranks (``launch.train.rank_jobs`` with ``configure``): each rank's
    losses, params and optimizer state bit for bit its worker of the
    2-worker sim run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--arch", "gpt2", "--smoke", "--steps", "6", "--batch", "4",
            "--seq", str(S), "--sync-warmup", "2", "--double-every", "2",
            "--kappa", "1", "--device", "cpu", "--workers", "2",
            "--log-every", "6"]
    prec = functools.partial(TLAUNCH.production, store_anchor=False)
    mesh.spawn(TLAUNCH.rank_jobs, 2,
               ([(argv + ["--mode", "dist"], str(tmp_path), True, "lm",
                  False, prec)], 2), timeout_s=180)
    sim_args = TLAUNCH.parse_args(argv + ["--mode", "sim"])
    sim = TLAUNCH.train(sim_args, TLAUNCH.make_trainer(sim_args,
                                                      configure=prec))
    for r in range(2):
        res = torch.load(pathlib.Path(tmp_path) / f"rank{r}.pt")
        assert [x["losses"][0] for x in res["records"]] == [
            x["losses"][r] for x in sim["records"]]
        for a, b in zip(flatten_tree(res["params"])[1],
                        flatten_tree(sim["params"])[1]):
            assert a.dtype == BF and torch.equal(a[0], b[r])
        st = sim["state"]
        for field in ("u", "err_w", "err_s"):
            for a, b in zip(res["state"][field], getattr(st, field)):
                if b is not None:
                    assert a.dtype == BF and torch.equal(a[0], b[r])
        for name, xs in res["state"]["slots"].items():
            for a, b in zip(xs, st.slots[name]):
                assert torch.equal(a[0], b[r]), name
