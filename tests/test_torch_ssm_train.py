"""The port's state-space family training against the reference live:
the 8-step trainers of mamba2-smoke in single mode and with 2 and 4
simulated workers, under ``zero_one_adam`` and ``adam`` (zamba2-smoke's,
through :func:`check_trainer_against_reference`:
``tests/test_torch_ssm_hybrid_train.py`` and
``tests/test_torch_ssm_hybrid.py``, so that each file stays near 90 s).

Tolerances, with their reasons (batch 8 x 16, syncs at steps 0-4 and 6,
variance rounds at 0, 1 and 3; the bars of
``tests/test_torch_moe_train.py``): step losses within 1e-4, params and
the state's tensors (m, v, u, the EF errors, the anchors) at least 99%
within 1e-4 (of the leaf's largest magnitude where that is above 1) and
all within 0.05 (f32 sums in another order; near-zero elements whose
sign flips at a sync; ``adam``'s bf16 mean).

The learning rate: ``adam`` at a constant 1e-4; ``zero_one_adam`` at
3e-5. At 1e-4 these models are chaotic in the last bit under
``zero_one_adam`` in the reference itself: from params one ulp up, the
reference's own zamba2-smoke (single mode) loss moves by 1.04e-4 by
step 7 (the port's by 4.95e-4, from a step-0 loss 1.9e-6 off); a 1-bit
update divides by sqrt(v) frozen at near-zero for some elements, so one
flipped sign moves such an element by up to 5.6e-3. At 3e-5 the
reference's own spread is <= 2.6e-5 and the port's gap <= 3.3e-5
(measured on zamba2-smoke at 1 and 4 workers and mamba2-smoke at 2).
The bars still catch a fault there: 78-88% of the params move past 1e-4
in the 8 steps, and the port with the sync step 6's update left out has
only 31-33% of some leaf within the bar and a step-7 loss 1.6e-4 to
5.9e-4 off (measured on zamba2-smoke at 1 worker and mamba2-smoke at 2
and 4); every ``zero_one_adam`` case asserts that the run without step
6's update fails a bar.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import schedules as RS
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.checkpointing import io as port_io
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.comm import NullComm, SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.train import step as TSTEP

torch.set_num_threads(1)

B, S, STEPS = 8, 16, 8
LRS = {"zero_one_adam": 3e-5, "adam": 1e-4}
# the sync step the zero_one_adam cases leave out to show the bars' power
FAULT_STEP = 6


def _opt_cfgs(name):
    sched = dict(warmup_steps=2, double_every=2, max_interval=16)
    lr = LRS[name]
    ref = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(lr),
        sync_policy=RS.LrProportionalSyncPolicy(**sched),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1))
    port = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(lr),
        sync_policy=TS.LrProportionalSyncPolicy(**sched),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1))
    return ref, port


def _port_batch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


def _share_close(got, want, scale_floor=1.0):
    """(share within 1e-4 of the leaf's largest magnitude (at least
    ``scale_floor``) plus 1e-6, largest gap)."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    d = np.abs(got - want)
    tol = 1e-4 * max(float(np.abs(want).max()) if want.size else 0.0,
                     scale_floor) + 1e-6
    return float((d <= tol).mean()) if d.size else 1.0, float(d.max(
        initial=0.0))


def check_trainer_against_reference(arch, n, name):
    """8 steps from the reference's draw (one worker: single mode; else
    sim mode) on its batches, under the module docstring's bars; under
    zero_one_adam, the same run with step FAULT_STEP's update left out
    must fail them."""
    rcfg, pcfg = _opt_cfgs(name)
    rt = RefTrainer(ref_get(arch).smoke, rcfg, n_workers=n)
    key = jax.random.PRNGKey(0)
    rp, rs = rt.single_init(key) if n == 1 else rt.sim_init(key)
    ref_step = rt.single_step_fn() if n == 1 else rt.sim_step_fn()
    pt = TSTEP.Trainer(port_get(arch).smoke, pcfg,
                       comm=SimComm(n) if n > 1 else NullComm(),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt,
                                      stacked=n > 1)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    skipped = None
    for t in range(STEPS):
        b = data.batch(t)
        rp, rs, rm = ref_step(rp, rs, b)
        if t == FAULT_STEP and name == "zero_one_adam":
            skipped = (copy.deepcopy(tp), ts.clone())
        tp, ts, tm = pt.step(tp, ts, _port_batch(b))
        want = float(np.asarray(rm["loss"]).reshape(-1)[0])
        assert abs(float(tm["loss"]) - want) < 1e-4, t
    for a, b in zip(jax.tree.leaves(rp), flatten_tree(tp)[1]):
        share, worst = _share_close(b, a)
        assert share >= 0.99 and worst <= 0.05, (share, worst)
    rten = [x for x in jax.tree.leaves(jax.device_get(rs))
            if np.ndim(x) > (1 if n > 1 else 0)]
    tten = [x for x in port_io.flatten(interop.state_to_reference(
        ts, stacked=n > 1))[1] if isinstance(x, torch.Tensor)]
    assert len(tten) == len(rten)
    for a, b in zip(rten, tten):
        share, worst = _share_close(b, a)
        assert share >= 0.99 and worst <= 0.05, (share, worst)
    if skipped is None:
        return
    fp, fs = skipped
    for t in range(FAULT_STEP + 1, STEPS):
        fp, fs, fm = pt.step(fp, fs, _port_batch(data.batch(t)))
    worst_share = min(_share_close(b, a)[0] for a, b in zip(
        jax.tree.leaves(rp), flatten_tree(fp)[1]))
    assert worst_share < 0.7 or abs(float(fm["loss"]) - want) >= 1e-4


@pytest.mark.parametrize("name", ["zero_one_adam", "adam"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_mamba2_trainer_matches_reference(n, name):
    check_trainer_against_reference("mamba2-2.7b", n, name)
