"""The port's slice end to end vs the reference: the gpt2-smoke Trainer in
sim mode with n=4 workers, global batch 8, seq 32, 8 steps of
``zero_one_adam`` (syncs at 0-4 and 6, variance at 0, 1, 3), both started
from the reference's parameters (carried over by ``repro_torch.interop``)
and fed the reference's batches.

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
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.leafwise import flatten_tree
from repro_torch.data import synthetic as TD
from repro_torch.launch import train as TLAUNCH
from repro_torch.train import step as TSTEP

# The suite runs under pytest-xdist with several workers per machine;
# torch's default of one intra-op thread per core in each of them would
# oversubscribe the cores. These inputs are small: one thread suffices.
torch.set_num_threads(1)

N, B, S, STEPS = 4, 8, 32, 8


def _configs():
    ref = RefOptimizerConfig(
        name="zero_one_adam", lr=RS.ConstantLr(1e-3),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2))
    port = TA.OptimizerConfig(
        lr=TS.ConstantLr(1e-3), var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2))
    return ref, port


@pytest.fixture(scope="module")
def ref_trainer():
    return RefTrainer(ref_get("gpt2").smoke, _configs()[0], n_workers=N)


def test_gpt2_smoke_trainer_matches_reference(ref_trainer):
    _, port_cfg = _configs()
    rt = ref_trainer
    rp, rs = rt.sim_init(jax.random.PRNGKey(0))
    ref_step = rt.sim_step_fn()
    pt = TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, n_workers=N,
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    flags = []
    for t in range(STEPS):
        b = data.batch(t)
        rp, rs, rm = ref_step(rp, rs, b)
        tp, ts, tm = pt.sim_step(
            tp, ts, {k: torch.from_numpy(np.array(v)).long()
                     for k, v in b.items()})
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
    pt = TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, n_workers=N,
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
        TSTEP.Trainer(port_get("gpt2").smoke, port_cfg, n_workers=N)
    with pytest.raises(RuntimeError, match="CUDA"):
        TLAUNCH.main(["--arch", "gpt2", "--smoke", "--steps", "1"])


def test_cli_runs_on_cpu(capsys):
    TLAUNCH.main(["--arch", "gpt2", "--smoke", "--steps", "3", "--batch",
                  "4", "--seq", "16", "--workers", "4", "--sync-warmup", "1",
                  "--double-every", "1", "--kappa", "1", "--log-every", "1",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=gpt2-smoke" in out and "DONE: 3 steps" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
