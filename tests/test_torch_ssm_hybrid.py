"""zamba2-smoke (the hybrid) against the reference live: its 8-step
``adam`` trainers in single mode and with 2 and 4 simulated workers
(the check and bars of ``tests/test_torch_ssm_train.py``), and the
reshard of a zamba2 trainer, 4 -> 3 workers, bit for bit the
reference's on the same state, with the same report.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core.compressed import CompressedDPState as RefState
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.elastic import reshard_report as ref_report
from repro.elastic import reshard_trainer as ref_reshard_trainer
from repro.train import Trainer as RefTrainer

from repro_torch import elastic as E
from repro_torch import interop
from repro_torch.checkpointing import io as port_io
from repro_torch.configs.base import get as port_get
from repro_torch.core.comm import SimComm
from repro_torch.train import step as TSTEP
from test_torch_ssm_train import (B, S, _opt_cfgs, _port_batch,
                                  check_trainer_against_reference)

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zamba2_adam_trainer_matches_reference(n):
    check_trainer_against_reference("zamba2-1.2b", n, "adam")


def _jnp(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.dtype, a.shape, a.tobytes()


def test_reshard_of_a_zamba2_trainer_matches_reference():
    """zamba2-smoke after 2 port steps at 4 workers (from the port's
    init), resharded to 3 (worker 2 killed) by both packages from the
    same state: every params and state leaf bit for bit, and the same
    report."""
    rcfg, pcfg = _opt_cfgs("zero_one_adam")
    arch = "zamba2-1.2b"
    rts = {n: RefTrainer(ref_get(arch).smoke, rcfg, n_workers=n)
           for n in (4, 3)}
    pts = {n: TSTEP.Trainer(port_get(arch).smoke, pcfg, comm=SimComm(n),
                            device="cpu") for n in (4, 3)}
    tp, ts = pts[4].init(0)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    for t in range(2):
        tp, ts, _ = pts[4].step(tp, ts, _port_batch(data.batch(t)))
    s = interop.state_to_reference(ts)
    lst = lambda xs: [None if x is None else _jnp(x) for x in xs]
    rp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tp)
    rs = RefState(step=_jnp(s.step), gamma_acc=_jnp(s.gamma_acc),
                  sync_pstate=tuple(_jnp(v) for v in s.sync_pstate),
                  var_pstate=tuple(_jnp(v) for v in s.var_pstate),
                  slots={k: lst(v) for k, v in s.slots.items()},
                  u=lst(s.u), err_w=lst(s.err_w), err_s=lst(s.err_s),
                  anchor=lst(s.anchor))
    survivors = (0, 1, 3)
    want = ref_reshard_trainer(rts[4], rts[3], rp, rs, survivors=survivors)
    got = E.reshard_trainer(pts[4], pts[3], tp, ts, survivors=survivors)
    flat_want = jax.tree_util.tree_flatten_with_path(
        {"params": want[0], "state": want[1]})[0]
    paths, leaves, _ = port_io.flatten(
        {"params": got[0], "state": interop.state_to_reference(got[1])})
    assert paths == [jax.tree_util.keystr(k) for k, _ in flat_want]
    for path, (_, a), b in zip(paths, flat_want, leaves):
        assert _bits(a) == _bits(b), path
    assert E.reshard_report(pts[4].opt, pts[3].opt, survivors=survivors) \
        == ref_report(rts[4].opt, rts[3].opt, survivors=survivors)
