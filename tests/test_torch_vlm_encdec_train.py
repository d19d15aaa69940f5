"""qwen2-vl-2b and whisper-large-v3 training in the port against the
reference live: the 8-step ``zero_one_adam`` trainers in single mode and
with 4 simulated workers (seeded ``vision_embeds`` / ``frames`` sliced
per worker like the tokens), checkpoints across packages both ways, a
FleetSim resize, and an audited run whose recorded bytes equal
``comm_accounting``. Params from the reference's init through
``repro_torch.interop``; batches from the reference's stream.

Tolerances, with their reasons (the rotary family's bars,
``tests/test_torch_families.py``):
* the 8-step trainers (batch 8 x 16, syncs at 0-4 and 6, variance
  rounds at 0, 1 and 3) at a constant lr of 1e-4: step losses within
  1e-4, params at least 99% within 1e-4 and all within 0.05 (f32 sums in
  another order; near-zero elements whose sign flips at a sync). The
  bars catch a fault: the port with sync step 6's update left out has
  under 70% of its params within 1e-4 of the reference's, asserted in
  every case. whisper's cross ``bk``/``bv`` get a zero gradient, so they
  stay at their zero init through the 8 steps, in both packages;
* checkpoints across packages: bit for bit;
* FleetSim (6 steps, workers 1 and 3 killed before step 3): the
  trainers' bars; the resize reports equal;
* the audit: clean, its recorded bytes per round and level equal to
  ``comm_accounting``'s.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import io as ref_io
from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import schedules as RS
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.elastic import FleetSim as RefFleetSim
from repro.elastic import ResizeEvent as RefResizeEvent
from repro.train import Trainer as RefTrainer

from repro_torch import elastic as E
from repro_torch import interop
from repro_torch.checkpointing import io as port_io
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.comm import NullComm, SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.elastic import simulate as TSIM
from repro_torch.launch import audit as LA
from repro_torch.train import step as TSTEP

torch.set_num_threads(1)

ARCHS = ["qwen2-vl-2b", "whisper-large-v3"]
B, S, STEPS, LR = 8, 16, 8, 1e-4
# the sync step the trainer cases leave out to show the bars' power
FAULT_STEP = 6


def _opt_cfgs(lr=LR):
    sched = dict(warmup_steps=2, double_every=2, max_interval=16)
    ref = RefOptimizerConfig(
        name="zero_one_adam", lr=RS.ConstantLr(lr),
        sync_policy=RS.LrProportionalSyncPolicy(**sched),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1))
    port = TA.OptimizerConfig(
        name="zero_one_adam", lr=TS.ConstantLr(lr),
        sync_policy=TS.LrProportionalSyncPolicy(**sched),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1))
    return ref, port


def _extras(cfg, seed=11):
    """Seeded (normal at 0.02) frames or vision embeddings for the global
    batch, numpy, the same every step."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.enc_layers:
        out["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model))).astype(np.float32)
    if cfg.vision_tokens:
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    return out


def _both(b, extras):
    """One batch for both packages: the reference's tokens and labels and
    the extras."""
    ref = {**{k: jnp.asarray(v) for k, v in b.items()},
           **{k: jnp.asarray(v) for k, v in extras.items()}}
    port = {**{k: torch.from_numpy(np.array(v)).long() for k, v in b.items()},
            **{k: torch.from_numpy(v) for k, v in extras.items()}}
    return ref, port


def _param_diff(ref_params, port_params):
    return np.concatenate([
        np.abs(np.asarray(a) - b.numpy()).ravel()
        for a, b in zip(jax.tree.leaves(ref_params),
                        flatten_tree(port_params)[1])])


def _start(arch, n, key=0):
    rcfg, pcfg = _opt_cfgs()
    rt = RefTrainer(ref_get(arch).smoke, rcfg, n_workers=n)
    k = jax.random.PRNGKey(key)
    rp, rs = rt.single_init(k) if n == 1 else rt.sim_init(k)
    pt = TSTEP.Trainer(port_get(arch).smoke, pcfg,
                       comm=SimComm(n) if n > 1 else NullComm(),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt,
                                      stacked=n > 1)
    return rt, rp, rs, pt, tp, ts


def _data():
    return RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))


@functools.lru_cache(maxsize=None)
def _ref_run(arch, n):
    """The reference's 8 steps from its draw (key 0) on its batches plus
    the extras: (trainer, params and state after step 1, final params,
    step losses); cached, so the checkpoint cases reuse the trainer
    cases' run."""
    rt, rp, rs, *_ = _start(arch, n)
    step = rt.single_step_fn() if n == 1 else rt.sim_step_fn()
    extras, data = _extras(rt.model_cfg), _data()
    losses = []
    for t in range(STEPS):
        rp, rs, rm = step(rp, rs, _both(data.batch(t), extras)[0])
        losses.append(float(np.asarray(rm["loss"]).reshape(-1)[0]))
        if t == 1:
            after_two = (rp, rs)
    return rt, after_two, rp, losses


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference(arch, n):
    """8 steps from the reference's draw (one worker: single mode; four:
    sim mode, each worker its quarter of the tokens and of the frames or
    vision embeddings) on its batches; then the same run with step
    FAULT_STEP's update left out must fail the params bar."""
    *_, pt, tp, ts = _start(arch, n)
    _, _, rp, ref_losses = _ref_run(arch, n)
    extras, data = _extras(pt.model_cfg), _data()
    flags = []
    for t in range(STEPS):
        if t == FAULT_STEP:
            skipped = (copy.deepcopy(tp), ts.clone())
        tp, ts, tm = pt.step(tp, ts, _both(data.batch(t), extras)[1])
        flags.append((tm["synced"], tm["var_round"]))
        assert abs(float(tm["loss"]) - ref_losses[t]) < 1e-4, t
    assert [f[0] for f in flags] == [1, 1, 1, 1, 1, 0, 1, 0]
    assert [f[1] for f in flags] == [1, 1, 0, 1, 0, 0, 0, 0]
    diff = _param_diff(rp, tp)
    assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 0.05
    if pt.model_cfg.enc_layers:
        for k in ("bk", "bv"):
            assert not tp["cross"]["attn"][k].any()
            assert not np.asarray(rp["cross"]["attn"][k]).any()
    fp, fs = skipped
    for t in range(FAULT_STEP + 1, STEPS):
        fp, fs, _ = pt.step(fp, fs, _both(data.batch(t), extras)[1])
    assert (_param_diff(rp, fp) <= 1e-4).mean() < 0.7


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages(arch, tmp_path):
    """The reference's sim trainer (4 workers) after two steps (the
    trainer case's run), saved by the reference and restored by the
    port, then saved by the port and restored by the reference: every
    leaf bit for bit (the 15 or 47 parameter leaves and their optimizer
    state, whisper's zero cross biases among them)."""
    pt = _start(arch, 4)[3]
    rt, (rp, rs), *_ = _ref_run(arch, 4)
    ref_path = str(tmp_path / "ref.npz")
    ref_io.save(ref_path, {"params": rp, "state": rs}, step=2)
    p, s, step_no, _ = pt.restore(ref_path)
    assert step_no == 2
    assert len(flatten_tree(p)[1]) == {"qwen2-vl-2b": 15,
                                       "whisper-large-v3": 47}[arch]
    want = jax.tree.leaves(jax.device_get({"params": rp, "state": rs}))
    got = port_io.flatten(pt.checkpoint_tree(p, s))[1]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    port_path = str(tmp_path / "port.npz")
    pt.save(port_path, p, s, step=2)
    like = jax.eval_shape(lambda: dict(zip(
        ("params", "state"), rt.sim_init(jax.random.PRNGKey(0)))))
    tree, step_no, _ = ref_io.restore(port_path, like)
    assert step_no == 2
    for a, b in zip(jax.tree.leaves(tree), want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


class _RefStream:
    """The reference's batches as the port's tensors (the two packages
    draw from different generators; the parity run feeds one stream)."""

    def __init__(self, cfg, device=None):
        self.data = RefSyntheticLM(RefDataConfig(
            vocab=cfg.vocab, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, seed=cfg.seed))

    def batch(self, t):
        return {k: torch.from_numpy(np.array(v)).long()
                for k, v in self.data.batch(t).items()}


def test_fleet_resize_matches_reference(monkeypatch):
    """6 steps of FleetSim on qwen2vl-smoke, workers 1 and 3 killed before
    step 3 (4 -> 2), both packages feeding the zero vision embeddings of
    their CLIs (sliced over 4 workers, then 2), from the reference's init
    and batches."""
    arch = "qwen2-vl-2b"
    ref_cfg, port_cfg = _opt_cfgs()
    rc, pc = ref_get(arch).smoke, port_get(arch).smoke
    events = [(3, 2, (0, 2))]
    ref = RefFleetSim(rc, ref_cfg, 4, seed=3).run(
        6, global_batch=B, seq=S,
        events=[RefResizeEvent(*e) for e in events])
    rp0, _ = RefTrainer(rc, ref_cfg, n_workers=4).sim_init(
        jax.random.PRNGKey(3))
    start = interop.params_from_reference(jax.device_get(rp0))

    def init(self, seed):
        params = jax.tree.map(torch.clone, start)
        return params, self.opt.init(params)

    monkeypatch.setattr(TSTEP.Trainer, "init", init)
    monkeypatch.setattr(TSIM, "SyntheticLM", _RefStream)
    got = E.FleetSim(pc, port_cfg, 4, seed=3, device="cpu").run(
        6, global_batch=B, seq=S, events=[E.ResizeEvent(*e) for e in events])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=1e-4)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "reshard_ms"}
                        for r in rs]
    assert strip(got["resizes"]) == strip(ref["resizes"])
    assert [r["workers"] for r in got["records"]] == [4] * 3 + [2] * 3
    diff = _param_diff(ref["params"], got["params"])
    assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_audited_run_bytes_equal_accounting(arch):
    """``launch.audit``'s 8 recorded steps (4 workers, the CLI's zero
    frames / vision embeddings): clean, every round the style declares
    seen, the bytes a worker sends per round and level equal to
    ``comm_accounting``'s, and the frame pre-check clean."""
    rec = LA.audit_one(arch, device="cpu")
    assert rec["ok"], (rec["violations"][:3], rec["frame_issues"][:3])
    s = rec["summary"]
    acct = s["accounting"]
    assert set(s["rounds"]) == {"sync+fullprec", "sync", "local-only"}
    for name, key in (("sync", "compressed_bytes_per_sync"),
                      ("fullprec", "fullprec_bytes_per_round")):
        got = s["recorded_bytes"][name]
        assert (got["inner"], got["outer"]) == (acct[f"{key}_inner"],
                                                acct[f"{key}_outer"])
