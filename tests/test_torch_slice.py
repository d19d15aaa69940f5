"""The port's slices end to end vs the reference: the gpt2-smoke Trainer
with ``zero_one_adam``, and the bert-smoke Trainer on masked-LM batches
with ``zero_one_adam`` under row scales and with ``zero_one_sgd``; each in
sim mode with n=4 workers, global batch 8, seq 32, 8 steps (syncs at 0-4
and 6, variance at 0, 1, 3 where the base has one), both started from the
reference's parameters (carried over by ``repro_torch.interop``) and fed
the reference's batches.

Tolerances, with their reasons:
* step losses within 1e-4 (measured worst 4.5e-5): the forward pass
  agrees to ~5e-7 on the logits, and the optimizer state drifts by a few
  ulp per sync through f32 sums taken in another order;
* parameters: at least 99% of elements within 1e-4 (about a tenth of one
  step's movement at lr=1e-3; measured 99.75%) and every element within
  0.05 (measured worst 0.021). The rest are sign flips: a near-zero
  ``u + err`` whose 1-bit sign differs between the two packages moves
  that element by about 2 * scale / sqrt(v) at the next re-anchor, and
  the difference persists through error feedback.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import schedules as RS
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.data.synthetic import _bigram_table as ref_bigram_table
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.train import Trainer as RefTrainer
from repro.train.step import accumulate_grads as ref_accumulate_grads

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.comm import SimComm
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.data import synthetic as TD
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import transformer as TT
from repro_torch.train import step as TSTEP

# The suite runs under pytest-xdist with several workers per machine;
# torch's default of one intra-op thread per core in each of them would
# oversubscribe the cores. These inputs are small: one thread suffices.
torch.set_num_threads(1)

N, B, S, STEPS = 4, 8, 32, 8


def _configs(name="zero_one_adam", scale_mode="tensor", lr=1e-3):
    # one_bit_adam: a full-precision stage of 2 steps, then 1-bit
    ref = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(lr),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2), scale_mode=scale_mode,
        onebit_warmup=2)
    port = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(lr),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2), scale_mode=scale_mode,
        onebit_warmup=2)
    return ref, port


def _port_batch(b):
    """A reference batch as the port's tensors (loss_mask stays f32)."""
    return {k: torch.from_numpy(np.array(v)) if k == "loss_mask"
            else torch.from_numpy(np.array(v)).long() for k, v in b.items()}


@pytest.fixture(scope="module")
def ref_trainer():
    return RefTrainer(ref_get("gpt2").smoke, _configs()[0], n_workers=N)


def test_gpt2_smoke_trainer_matches_reference(ref_trainer):
    _, port_cfg = _configs()
    rt = ref_trainer
    rp, rs = rt.sim_init(jax.random.PRNGKey(0))
    ref_step = rt.sim_step_fn()
    pt = TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, comm=SimComm(N),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
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
    assert diff.size == N * 346_880
    assert (diff <= 1e-4).mean() >= 0.99
    assert diff.max() <= 0.05
    assert [f[0] for f in flags] == [1, 1, 1, 1, 1, 0, 1, 0]
    assert [f[1] for f in flags] == [1, 1, 0, 1, 0, 0, 0, 0]


def test_state_from_reference_equals_port_init(ref_trainer):
    _, port_cfg = _configs()
    rp, rs = ref_trainer.sim_init(jax.random.PRNGKey(1))
    pt = TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, comm=SimComm(N),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    got = interop.state_from_reference(jax.device_get(rs), pt.opt)
    want = pt.opt.init(tp)
    assert (got.step, got.sync_pstate, got.var_pstate) == (
        want.step, want.sync_pstate, want.var_pstate)
    for name in ("u", "err_w", "err_s", "anchor"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.shape == b.shape and torch.equal(a, b), name
    for name in ("m", "v"):
        for a, b in zip(got.slots[name], want.slots[name]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adam", "momentum_sgd", "one_bit_adam"])
def test_state_from_reference_equals_port_init_every_style(name):
    """The baselines' states: the port's init equals the reference's,
    carried over, leaf for leaf, None where the style keeps nothing (u
    and anchor outside accumulate, the EF state in the mean style) and
    empty policy states."""
    ref_cfg, port_cfg = _configs(name)
    rt = RefTrainer(ref_get("gpt2").smoke, ref_cfg, n_workers=N)
    rp, rs = rt.sim_init(jax.random.PRNGKey(1))
    pt = TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, comm=SimComm(N),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    got = interop.state_from_reference(jax.device_get(rs), pt.opt)
    want = pt.opt.init(tp)
    assert (got.step, got.gamma_acc, got.sync_pstate, got.var_pstate) == (
        want.step, want.gamma_acc, (), ())
    has_ef = name == "one_bit_adam"
    for field in ("u", "err_w", "err_s", "anchor"):
        a_list, b_list = getattr(got, field), getattr(want, field)
        assert len(a_list) == len(b_list) == 19
        for a, b in zip(a_list, b_list):
            if has_ef and field in ("err_w", "err_s"):
                assert a.shape == b.shape and torch.equal(a, b), field
            else:
                assert a is None and b is None, field
    assert sorted(got.slots) == sorted(want.slots) == sorted(rs.slots)
    for name_ in got.slots:
        for a, b in zip(got.slots[name_], want.slots[name_]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adam", "one_bit_adam"])
def test_gpt2_smoke_baseline_trainer_matches_reference(name):
    """The gpt2-smoke Trainer under the paper's baselines (adam: a bf16
    mean and a variance update every step; one_bit_adam: that for 2
    steps, then the 1-bit exchange of the gradient), from the
    reference's parameters on its batches; the slice's bars (module
    docstring). Measured worst loss gaps 4.3e-6 (adam) and 4.5e-5
    (one_bit_adam); params 99.999% and 99.94% within 1e-4, all within
    1.4e-4 and 9.0e-3 (the 1-bit stage carries the sign flips)."""
    ref_cfg, port_cfg = _configs(name)
    rt = RefTrainer(ref_get("gpt2").smoke, ref_cfg, n_workers=N)
    rp, rs = rt.sim_init(jax.random.PRNGKey(0))
    ref_step = rt.sim_step_fn()
    pt = TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, comm=SimComm(N),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    flags, gaps = [], []
    for t in range(STEPS):
        b = data.batch(t)
        rp, rs, rm = ref_step(rp, rs, b)
        tp, ts, tm = pt.step(tp, ts, _port_batch(b))
        flags.append((tm["synced"], tm["var_round"]))
        gaps.append(abs(float(tm["loss"]) - float(rm["loss"][0])))
        assert gaps[-1] < 1e-4, t
    diff = np.concatenate([
        np.abs(np.asarray(a) - b.numpy()).ravel()
        for a, b in zip(jax.tree.leaves(rp), flatten_tree(tp)[1])])
    print(name, "max loss gap", max(gaps), "params within 1e-4",
          (diff <= 1e-4).mean(), "max", diff.max())
    assert diff.size == N * 346_880
    assert (diff <= 1e-4).mean() >= 0.99
    assert diff.max() <= 0.05
    assert [f[0] for f in flags] == [True] * STEPS
    assert [f[1] for f in flags] == (
        [True] * STEPS if name == "adam" else [1, 1, 0, 0, 0, 0, 0, 0])


def test_synthetic_lm_is_deterministic_and_uses_reference_table():
    np.testing.assert_array_equal(TD._bigram_table(512, 3),
                                  ref_bigram_table(512, 3))
    data = TD.SyntheticLM(TD.DataConfig(vocab=512, seq_len=16,
                                        global_batch=4, seed=3))
    a, b = data.batch(2), data.batch(2)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], data.batch(3)["tokens"])
    assert a["tokens"].shape == (4, 16) and a["labels"].shape == (4, 16)
    # next-token targets: tokens are labels shifted right by one
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < 512


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_cfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, comm=SimComm(N))
    with pytest.raises(RuntimeError, match="CUDA"):
        TLAUNCH.main(["--arch", "gpt2", "--smoke", "--steps", "1"])


def test_cli_runs_on_cpu(capsys):
    TLAUNCH.main(["--arch", "gpt2", "--smoke", "--steps", "3", "--batch",
                  "4", "--seq", "16", "--mode", "sim", "--workers", "4",
                  "--sync-warmup", "1", "--double-every", "1", "--kappa",
                  "1", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=gpt2-smoke" in out and "DONE: 3 steps" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))


@pytest.mark.parametrize("optimizer", ["adam", "one_bit_adam",
                                       "momentum_sgd"])
def test_cli_runs_baselines_on_cpu(capsys, optimizer):
    """Every step of a baseline exchanges (``sync=True``); one_bit_adam's
    variance rounds are its full-precision stage. The DONE line's tally
    is the reference's: a sync payload and, on variance rounds, a
    full-precision round counted per step."""
    TLAUNCH.main(["--arch", "gpt2", "--smoke", "--mode", "sim",
                  "--optimizer", optimizer, "--onebit-warmup", "2",
                  "--steps", "4", "--batch", "8", "--seq", "16",
                  "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    steps = [line for line in out.splitlines() if line.startswith("step")]
    assert len(steps) == 4 and all("sync=True" in ln for ln in steps)
    var = ["var=True" in ln for ln in steps]
    assert var == {"adam": [True] * 4, "one_bit_adam": [1, 1, 0, 0],
                   "momentum_sgd": [False] * 4}[optimizer]
    rounds = 4 + sum(var)
    assert f"DONE: 4 steps, {rounds} comm rounds" in out
    assert f"optimizer={optimizer}" in out


@pytest.mark.parametrize("name,scale_mode", [("zero_one_adam", "row"),
                                             ("zero_one_sgd", "tensor")])
def test_bert_smoke_mlm_trainer_matches_reference(name, scale_mode):
    """bert-smoke (bidirectional, untied lm_head, 20 leaves) on the
    reference's MLM batches; each worker's loss divides by its own mask
    sum on both sides. Same bars as the gpt2 test, for the same reasons.

    Row scales make the comparison more sensitive than tensor scales: a
    near-zero element whose sign differs between the packages (their
    gradients are not bitwise equal) changes its whole row's server scale,
    not one tensor-wide mean. lr=3e-4: at 1e-3 the row-scale run is
    unstable on this model (the reference's own loss jumps from 6.37 to
    8.57 at step 6) and one such flip grew to a 2.2e-3 loss gap. At 3e-4
    the measured worst gap is 2.4e-5 from this init (key 0); another init
    (key 2) measured 1.4e-4 at step 6."""
    ref_cfg, port_cfg = _configs(name, scale_mode, lr=3e-4)
    rt = RefTrainer(ref_get("bert-base").smoke, ref_cfg, n_workers=N)
    rp, rs = rt.sim_init(jax.random.PRNGKey(0))
    ref_step = rt.sim_step_fn()
    pt = TSTEP.Trainer(port_get("bert-base").smoke, port_cfg,
                       comm=SimComm(N), device="cpu")
    assert len(pt.opt.layouts) == 20
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0, kind="mlm"))
    flags, losses = [], []
    for t in range(STEPS):
        b = data.batch(t)
        rp, rs, rm = ref_step(rp, rs, b)
        tp, ts, tm = pt.step(tp, ts, _port_batch(b))
        flags.append((tm["synced"], tm["var_round"]))
        losses.append(float(tm["loss"]))
        assert abs(float(tm["loss"]) - float(rm["loss"][0])) < 1e-4, t
    # near-uniform logits over the padded vocab at the start
    assert abs(losses[0] - np.log(512)) < 0.5
    diff = np.concatenate([
        np.abs(np.asarray(a) - b.numpy()).ravel()
        for a, b in zip(jax.tree.leaves(rp), flatten_tree(tp)[1])])
    assert (diff <= 1e-4).mean() >= 0.99
    assert diff.max() <= 0.05
    assert [f[0] for f in flags] == [1, 1, 1, 1, 1, 0, 1, 0]
    want_var = ([1, 1, 0, 1, 0, 0, 0, 0] if name == "zero_one_adam"
                else [0] * STEPS)
    assert [f[1] for f in flags] == want_var


def test_bert_smoke_loss_and_grads_match_reference():
    """One forward/backward of bert-smoke on an MLM batch: the masked loss
    to 1e-6 and every gradient leaf to 1e-4 of its own largest magnitude
    (f32 matmuls in another order)."""
    rcfg, tcfg = ref_get("bert-base").smoke, port_get("bert-base").smoke
    rp = RL.init_params(RT.model_template(rcfg), jax.random.PRNGKey(3))
    b = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S, global_batch=2,
                                     seed=1, kind="mlm")).batch(0)
    (rl, _), rg = jax.value_and_grad(
        lambda p: RT.lm_loss(p, rcfg, b), has_aux=True)(rp)
    tp = interop.params_from_reference(jax.device_get(rp))
    paths, leaves = flatten_tree(tp)
    leaves = [x.requires_grad_(True) for x in leaves]
    tl, _ = TT.lm_loss(unflatten_tree(paths, leaves), tcfg, _port_batch(b))
    tg = torch.autograd.grad(tl, leaves)
    assert "lm_head" in tp and abs(float(tl.detach()) - float(rl)) < 1e-6
    for a, g in zip(jax.tree.leaves(rg), tg):
        a = np.asarray(a)
        np.testing.assert_allclose(g.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max() + 1e-12)


def test_synthetic_mlm_batches():
    data = TD.SyntheticLM(TD.DataConfig(vocab=512, seq_len=64,
                                        global_batch=8, seed=3, kind="mlm"))
    a, b = data.batch(2), data.batch(2)
    lm = TD.SyntheticLM(TD.DataConfig(vocab=512, seq_len=64,
                                      global_batch=8, seed=3)).batch(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    mask = a["loss_mask"]
    assert mask.dtype == torch.float32 and mask.shape == (8, 64)
    # labels are the unmasked inputs; masked inputs become 0 ([MASK])
    assert torch.equal(a["labels"], lm["tokens"])
    assert torch.equal(a["tokens"], torch.where(mask > 0, 0, lm["tokens"]))
    assert 0.08 < float(mask.mean()) < 0.22
    with pytest.raises(NotImplementedError):
        TD.DataConfig(vocab=8, seq_len=4, global_batch=2, kind="classify")


@pytest.mark.parametrize("extra", [["--scale-mode", "row"],
                                   ["--optimizer", "zero_one_sgd"]])
def test_cli_runs_bert_on_cpu(capsys, extra):
    TLAUNCH.main(["--arch", "bert-base", "--smoke", "--steps", "3",
                  "--batch", "4", "--seq", "16", "--mode", "sim",
                  "--workers", "4", "--sync-warmup", "1", "--double-every",
                  "1", "--kappa", "1", "--log-every", "1", "--device",
                  "cpu"] + extra)
    out = capsys.readouterr().out
    assert "arch=bert-smoke" in out and "DONE: 3 steps" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))


@pytest.mark.parametrize("peel", [True, False])
@pytest.mark.parametrize("mb", [2, 3])
def test_accumulate_grads_matches_reference(mb, peel):
    """Gradient accumulation over ``mb`` micro-batches of gpt2-smoke: the
    mean loss to 1e-6 and every gradient leaf to 1e-4 of its own largest
    magnitude, as the single forward/backward above (the reference's
    peeled and scanned forms are the same sum in the same order)."""
    rcfg, tcfg = ref_get("gpt2").smoke, port_get("gpt2").smoke
    rp = RL.init_params(RT.model_template(rcfg), jax.random.PRNGKey(4))
    b = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S, global_batch=6,
                                     seed=2)).batch(0)
    rl, rg = ref_accumulate_grads(lambda p, b_: RT.lm_loss(p, rcfg, b_),
                                  rp, b, mb, peel=peel)
    tl, tg = TSTEP.accumulate_grads(
        lambda p, b_: TT.lm_loss(p, tcfg, b_),
        interop.params_from_reference(jax.device_get(rp)), _port_batch(b),
        mb)
    assert abs(float(tl) - float(rl)) < 1e-6
    for a, g in zip(jax.tree.leaves(rg), flatten_tree(tg)[1]):
        a = np.asarray(a)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max() + 1e-12)


def _parser_of(run, monkeypatch):
    """The ArgumentParser that ``run()`` parses its command line with."""
    import argparse

    class Parsed(Exception):
        pass

    seen = []

    def parse_args(self, args=None, namespace=None):
        seen.append(self)
        raise Parsed

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(Parsed):
            run()
    return seen[0]


def test_cli_defaults_match_reference(monkeypatch):
    """Every flag the two training CLIs share has the same default,
    ``--mode`` (single) included, so the same command line runs the same
    number of workers in both packages; ``--optimizer`` and ``--codec``
    offer the same choices, and ``--codec-arg`` takes the same type with
    the same help."""
    from repro.launch import train as ref_launch
    parsers = (_parser_of(ref_launch.main, monkeypatch),
               _parser_of(lambda: TLAUNCH.parse_args([]), monkeypatch))
    actions = [{a.dest: a for a in p._actions if a.dest != "help"}
               for p in parsers]
    defaults = [{k: a.default for k, a in acts.items()} for acts in actions]
    shared = sorted(set(defaults[0]) & set(defaults[1]))
    assert {"mode", "workers", "optimizer", "scale_mode", "hierarchy",
            "micro_batches", "lr", "steps", "codec", "codec_arg"} <= set(
                shared)
    assert {k: defaults[1][k] for k in shared} == {
        k: defaults[0][k] for k in shared}
    for dest in ("optimizer", "codec"):
        assert actions[1][dest].choices == actions[0][dest].choices
    assert actions[1]["codec_arg"].help == actions[0]["codec_arg"].help
    assert actions[1]["codec_arg"].type is actions[0]["codec_arg"].type
    assert defaults[1]["mode"] == "single"
    args = TLAUNCH.parse_args(["--arch", "gpt2"])
    assert args.mode == "single" and args.device == "cuda"


def test_cli_runs_single_mode_on_cpu(capsys):
    TLAUNCH.main(["--arch", "gpt2", "--smoke", "--mode", "single", "--steps",
                  "3", "--batch", "2", "--seq", "16", "--sync-warmup", "1",
                  "--double-every", "1", "--kappa", "1", "--log-every", "1",
                  "--micro-batches", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "workers=1 mode=single micro_batches=2" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_cli_spawns_dist_ranks_on_cpu(capfd, monkeypatch):
    """``--mode dist`` without a launcher spawns ``--workers`` gloo ranks
    itself; only rank 0 prints."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    TLAUNCH.main(["--arch", "gpt2", "--smoke", "--mode", "dist",
                  "--workers", "2", "--steps", "3", "--batch", "4", "--seq",
                  "16", "--sync-warmup", "1", "--double-every", "1",
                  "--kappa", "1", "--log-every", "1", "--device", "cpu"])
    out = capfd.readouterr().out
    assert out.count("workers=2 mode=dist") == 1
    assert out.count("DONE: 3 steps") == 1
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
