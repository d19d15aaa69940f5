"""The port's MoE models training with expert parallelism against the
reference live: the 8-step trainers of llama4-smoke and deepseek-smoke
in single mode and with 2 and 4 simulated workers (EP 2, EP 4) under
``zero_one_adam`` (``adam``: ``tests/test_torch_moe.py``; 4 gloo ranks
with the real expert exchange and pods with an EP degree below the
fleet's: ``tests/test_torch_dist.py``; checkpoints across the packages:
``tests/test_torch_checkpoint.py``); the reshard of a MoE trainer; the
CLI. And the optimizer's in-place update: the storage of every params
and state tensor survives a sync step and a local step.

Tolerances, with their reasons:
* the trainers (batch 8 x 16, syncs at steps 0-4 and 6, variance rounds
  at 0, 1 and 3), at a constant lr of 1e-4 as ``test_torch_families.py``
  (f32 sums in another order; near-zero elements whose sign flips at a
  sync): step losses within 1e-4 (measured worst 4.0e-5, deepseek-smoke
  single mode), params and the state's tensors (m, v, u, the EF errors,
  the anchors) at least 99% within 1e-4 (of the leaf's largest magnitude
  where that is above 1) and all within 0.05 (measured: >= 99.97% of
  params; ``adam`` every param within 1.6e-5). An elementwise bar
  relative to each state leaf does not hold: ``adam``'s mean gradient is
  rounded to bf16, so a 1-ulp f32 difference that crosses a bf16
  rounding boundary moves m by 0.4% of the element;
* the reshard at m = n: bit for bit; the
  reshard that changes a worker's share of experts is refused as the
  reference refuses it, word for word.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import schedules as RS
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
import importlib
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.checkpointing import io as port_io
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.comm import NullComm, SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.launch import train as TLAUNCH
from repro_torch.train import step as TSTEP

# the modules (their packages export a function of the same name)
RE = importlib.import_module("repro.elastic.reshard")
TE = importlib.import_module("repro_torch.elastic.reshard")

torch.set_num_threads(1)

ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]
B, S, STEPS, LR = 8, 16, 8, 1e-4


def _opt_cfgs(name):
    sched = dict(warmup_steps=2, double_every=2, max_interval=16)
    ref = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(LR),
        sync_policy=RS.LrProportionalSyncPolicy(**sched),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1))
    port = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(LR),
        sync_policy=TS.LrProportionalSyncPolicy(**sched),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1))
    return ref, port


def _port_batch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


def _share_close(got, want, scale_floor=0.0):
    """(share within 1e-4 of the leaf's largest magnitude (at least
    ``scale_floor``) plus 1e-6, largest gap)."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    d = np.abs(got - want)
    tol = 1e-4 * max(float(np.abs(want).max()) if want.size else 0.0,
                     scale_floor) + 1e-6
    return float((d <= tol).mean()) if d.size else 1.0, float(d.max(
        initial=0.0))


# --------------------------------------------------------------------- #
# the trainers against the reference
# --------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _ref_start(arch, n, name):
    """The reference's trainer of ``arch``-smoke at ``n`` workers under
    ``name``, its draw (key 0) and its jitted step, made once a
    configuration: the trainer case and the reshard share them."""
    rt = RefTrainer(ref_get(arch).smoke, _opt_cfgs(name)[0], n_workers=n)
    key = jax.random.PRNGKey(0)
    if n == 1:
        return rt, rt.single_init(key), rt.single_step_fn()
    return rt, rt.sim_init(key), rt.sim_step_fn()


def check_trainer_against_reference(arch, n, name):
    """8 steps from the reference's draw (one worker: single mode; else
    sim mode, experts split over the workers) on its batches, under the
    module docstring's bars (``tests/test_torch_moe.py`` runs ``adam``
    through it)."""
    _, pcfg = _opt_cfgs(name)
    rt, (rp, rs), ref_step = _ref_start(arch, n, name)
    pt = TSTEP.Trainer(port_get(arch).smoke, pcfg,
                       comm=SimComm(n) if n > 1 else NullComm(),
                       device="cpu")
    assert pt.ep_degree == rt.ep_degree == n
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt,
                                      stacked=n > 1)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    for t in range(STEPS):
        b = data.batch(t)
        rp, rs, rm = ref_step(rp, rs, b)
        tp, ts, tm = pt.step(tp, ts, _port_batch(b))
        want = float(np.asarray(rm["loss"]).reshape(-1)[0])
        assert abs(float(tm["loss"]) - want) < 1e-4, t
        assert np.isfinite(tm["aux"]) and 0 <= tm["dropped_frac"] < 1
    for a, b in zip(jax.tree.leaves(rp), flatten_tree(tp)[1]):
        share, worst = _share_close(b, a, scale_floor=1.0)
        assert share >= 0.99 and worst <= 0.05, (share, worst)
    # the state's tensors (its scalars are host values in the port)
    rten = [x for x in jax.tree.leaves(jax.device_get(rs))
            if np.ndim(x) > (1 if n > 1 else 0)]
    tten = [x for x in port_io.flatten(interop.state_to_reference(
        ts, stacked=n > 1))[1] if isinstance(x, torch.Tensor)]
    assert len(tten) == len(rten)
    for a, b in zip(rten, tten):
        share, worst = _share_close(b, a, scale_floor=1.0)
        assert share >= 0.99 and worst <= 0.05, (share, worst)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference(arch, n):
    check_trainer_against_reference(arch, n, "zero_one_adam")


# --------------------------------------------------------------------- #
# the reshard, the CLI
# --------------------------------------------------------------------- #

def test_reshard_of_a_moe_trainer_matches_reference():
    """m = n: the identity, bit for bit, as the reference's; 4 -> 2
    changes each worker's share of experts, which both packages refuse
    with the same words; ep_merge / ep_split against the reference's."""
    _, cfg_p = _opt_cfgs("zero_one_adam")
    arch = "llama4-scout-17b-a16e"
    rts = {n: _ref_start(arch, n, "zero_one_adam")[0] for n in (2, 4)}
    pts = {n: TSTEP.Trainer(port_get(arch).smoke, cfg_p, comm=SimComm(n),
                            device="cpu") for n in (2, 4)}
    rp, rs = _ref_start(arch, 4, "zero_one_adam")[1]
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pts[4].opt)
    want = RE.reshard_trainer(rts[4], rts[4], rp, rs)
    got = TE.reshard_trainer(pts[4], pts[4], tp, ts)
    for a, b in zip(jax.tree.leaves(jax.device_get(want[0])),
                    flatten_tree(got[0])[1]):
        assert np.array_equal(a, b.numpy())
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(
        flatten_tree(tp)[1], flatten_tree(got[0])[1]))
    with pytest.raises(ValueError) as ref_err:
        RE.reshard_trainer(rts[4], rts[2], rp, rs)
    with pytest.raises(ValueError) as port_err:
        TE.reshard_trainer(pts[4], pts[2], tp, ts)
    assert str(port_err.value) == str(ref_err.value)
    x = np.random.default_rng(0).standard_normal((4, 2, 3, 5)).astype(
        np.float32)
    merged = TE.ep_merge(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(merged.numpy(),
                                  np.asarray(RE.ep_merge(x, 1)))
    np.testing.assert_array_equal(TE.ep_split(merged, 1, 2).numpy(),
                                  np.asarray(RE.ep_split(merged.numpy(), 1,
                                                         2)))


@pytest.mark.parametrize("mode", ["single", "sim"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_moe_configs(arch, mode, capsys):
    argv = ["--arch", arch, "--smoke", "--mode", mode, "--steps", "2",
            "--batch", "8", "--seq", "16", "--log-every", "1",
            "--device", "cpu"] + (["--workers", "4"] if mode == "sim"
                                  else [])
    TLAUNCH.main(argv)
    out = capsys.readouterr().out
    assert "DONE: 2 steps" in out and "arch=" in out
    with pytest.raises(SystemExit, match="dense layers"):
        TLAUNCH.make_trainer(TLAUNCH.parse_args(
            ["--arch", "deepseek-v2-236b", "--smoke", "--layers", "1",
             "--device", "cpu"]))
    tr = TLAUNCH.make_trainer(TLAUNCH.parse_args(
        ["--arch", arch, "--layers", "2", "--mode", "sim", "--workers", "4",
         "--device", "cpu"]))
    assert tr.model_cfg.n_layers == 2
    assert tr.model_cfg.d_model == port_get(arch).config.d_model


# --------------------------------------------------------------------- #
# the in-place update
# --------------------------------------------------------------------- #

def _tensors(params, state):
    out = flatten_tree(params)[1]
    for xs in list(state.slots.values()) + [state.u, state.err_w,
                                            state.err_s, state.anchor]:
        out += [x for x in xs if x is not None]
    return out


@pytest.mark.parametrize("arch,extra", [
    ("llama4-scout-17b-a16e", []), ("gpt2", ["--bucket-mb", "4"]),
    ("gpt2", ["--optimizer", "one_bit_adam", "--onebit-warmup", "2"]),
    ("bert-base", ["--optimizer", "zero_one_lamb"])],
    ids=["moe", "bucketed", "one_bit", "lamb"])
def test_step_updates_state_in_place(arch, extra):
    """Six steps (syncs and variance rounds, then the local step 5):
    ``Trainer.step`` returns the objects it was given, and every params
    and state tensor keeps its storage through each step."""
    args = TLAUNCH.parse_args(
        ["--arch", arch, "--smoke", "--mode", "sim", "--workers", "4",
         "--steps", "6", "--batch", "8", "--seq", "16", "--sync-warmup",
         "2", "--double-every", "2", "--kappa", "1", "--device", "cpu"]
        + extra)
    tr = TLAUNCH.make_trainer(args)
    params, state = tr.init(0)
    ptrs = [x.data_ptr() for x in _tensors(params, state)]
    data = TLAUNCH.SyntheticLM(TLAUNCH.DataConfig(
        vocab=tr.model_cfg.vocab, seq_len=16, global_batch=8, seed=0))
    kinds = []
    for t in range(6):
        p2, s2, met = tr.step(params, state, data.batch(t))
        assert p2 is params and s2 is state
        assert [x.data_ptr() for x in _tensors(params, state)] == ptrs, t
        kinds.append(bool(met["synced"]))
    assert True in kinds and (False in kinds or tr.opt.cfg.style != (
        "accumulate"))
