"""The port's dense rotary family (granite-3-8b, phi4-mini-3.8b,
chatglm3-6b, gemma3-12b: rmsnorm, swiglu, standard and partial rotary at
the config's theta, sliding-window layers, remat) on the training side,
against the reference live in one process: configs, templates and comm
layouts at SMOKE and FULL (FULL as metadata only), the elementary layers,
``forward`` and ``lm_loss`` gradients, remat, the 8-step ``zero_one_adam``
sim trainer, the CLI, checkpoints across packages, and the kernels' frame
pre-check on every FULL unit.

Tolerances, with their reasons:
* configs, templates, layouts, pre-check verdicts: equal;
* ``rms_norm``, swiglu and ``apply_rope``: 1e-6 (measured <= 2.4e-7:
  f32 reductions and ``pow`` in another order);
* ``forward`` logits within 1e-5 and the loss within 1e-5 (measured
  <= 6e-7 and 1e-6); each gradient leaf within 1e-5 of its own largest
  magnitude (measured <= 1.02e-6: f32 matmuls in another order);
* remat on against off, in the port: bit for bit;
* the 8-step sim trainer (4 workers, batch 8 x 32, syncs at 0-4 and 6)
  at a constant lr of 1e-4: step losses within 1e-4 (measured worst
  4.9e-5, granite-smoke), params at least 99% within 1e-4 (measured
  >= 99.95%) and all within 0.05, as ``test_torch_slice.py``. At its lr
  of 1e-3 these models are chaotic in the last bit in the reference
  itself: from params one ulp up, the reference's own granite-smoke
  losses move by 3.4e-4 by step 6 (gpt2-smoke: 1.1e-5), so the
  comparison is made where the trajectory is not (the reference's own
  spread at 1e-4: <= 2.6e-5). The bars still catch a fault: 74-86% of
  the params move past 1e-4 in the 8 steps, and the port with one sync
  step's update left out (step 6) has only 33-59% within 1e-4 of the
  reference (held under 70%) and a step-7 loss 1.7e-4 to 5.6e-3 off;
* checkpoints across packages: bit for bit.
"""
import copy
import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import io as ref_io
from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import leafwise as RLW
from repro.core import schedules as RS
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import layers as RL
from repro.models import rope as RR
from repro.models import transformer as RT
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import compressor as TC
from repro_torch.core import leafwise as TLW
from repro_torch.core import schedules as TS
from repro_torch.core.comm import SimComm
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.kernels import dispatch as KD
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import layers as TL
from repro_torch.models import rope as TR
from repro_torch.models import transformer as TT
from repro_torch.train import step as TSTEP

# one intra-op thread: the inputs are small, and the suite runs several
# pytest-xdist workers per machine
torch.set_num_threads(1)

ARCHS = ["granite-3-8b", "phi4-mini-3.8b", "chatglm3-6b", "gemma3-12b"]
N, B, S, STEPS = 4, 8, 32, 8
LR = 1e-4
# the sync step the 8-step trainer test leaves out to show its bars' power
FAULT_STEP = 6


def _cfgs(arch, which):
    attr = "smoke" if which == "smoke" else "config"
    return getattr(ref_get(arch), attr), getattr(port_get(arch), attr)


def _ref_leaves(tmpl):
    flat, _ = jax.tree_util.tree_flatten_with_path(tmpl, is_leaf=RL.is_pd)
    return [(tuple(str(k.key) for k in path), pd) for path, pd in flat]


def _port_leaves(tmpl):
    out = []
    TL._map(tmpl, lambda path, pd: out.append((path, pd)))
    return sorted(out, key=lambda x: x[0])


def _grads(params, cfg, batch):
    paths, leaves = flatten_tree(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss, _ = TT.lm_loss(unflatten_tree(paths, leaves), cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _batch(vocab, seed=0, b=2, s=24):
    """Next-token tokens/labels as numpy int32 (s = 24 > gemma3-smoke's
    window of 8, so its sliding layers mask)."""
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


# --------------------------------------------------------------------- #
# configs, templates, layouts
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, which):
    rc, pc = _cfgs(arch, which)
    for f in dataclasses.fields(pc):
        if f.name in ("param_dtype", "compute_dtype"):
            continue
        assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    assert (pc.hd, pc.padded_vocab, pc.n_global_layers) == (
        rc.hd, rc.padded_vocab, rc.n_global_layers)


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_templates_match_reference(arch, which):
    """Leaf for leaf: paths, shapes, init kinds and scales, tensor-parallel
    specs and DP membership (FULL as templates only, nothing
    allocated)."""
    rc, pc = _cfgs(arch, which)
    ref, port = (_ref_leaves(RT.model_template(rc)),
                 _port_leaves(TT.model_template(pc)))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, port):
        assert tuple(b.shape) == tuple(a.shape), path
        assert (b.init, b.scale, b.dp) == (a.init, a.scale, a.dp), path
        assert b.spec == (None if a.spec is None else tuple(a.spec)), path
    if which == "full":
        total = sum(int(np.prod(pd.shape)) for _, pd in port)
        # counted with the reference's templates
        assert total == {"granite-3-8b": 8_374_259_712,
                         "phi4-mini-3.8b": 4_451_404_800,
                         "chatglm3-6b": 6_243_584_000,
                         "gemma3-12b": 11_765_395_200}[arch]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_match_reference(arch, which, n):
    rc, pc = _cfgs(arch, which)
    rt, tt = RT.model_template(rc), TT.model_template(pc)
    ref = RLW.make_plan(RL.abstract_params(rt), RL.param_specs(rt), None, n)
    port = TLW.make_plan(TL.param_shapes(tt), TL.param_specs(tt),
                         TL.dp_mask(tt), n)
    assert len(port.layouts) == len(ref.layouts)
    for a, b in zip(ref.layouts, port.layouts):
        assert dataclasses.astuple(b) == dataclasses.astuple(a)
    if which == "full" and n == 2:
        views = {"/".join(p): lo.view_shape
                 for p, lo in zip(port.paths, port.layouts)}
        want = {"granite-3-8b": {"blocks/mlp/w_gate": (2, 2048, 40, 12800),
                                 "embed": (2, 2048, 49408)},
                "gemma3-12b": {"embed": (2, 1920, 262144)},
                "chatglm3-6b": {"blocks/attn/bk": (2, 14, 256)},
                "phi4-mini-3.8b": {"lm_head": (2, 1536, 200192)}}[arch]
        assert {k: views[k] for k in want} == want


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_frame_precheck_passes_on_every_full_unit(arch, n):
    """Every unit of the FULL configs at full depth, ``n`` workers stacked
    in one launch, within the CUDA kernels' launch contract; gemma3's
    embed frame at 4 workers holds 4.03e9 elements (n4 1.007e9 < 2**31)."""
    pc = port_get(arch).config
    tt = TT.model_template(pc)
    plan = TLW.make_plan(TL.param_shapes(tt), TL.param_specs(tt),
                         TL.dp_mask(tt), n)
    for path, lo in zip(plan.paths, plan.layouts):
        assert KD.frame_precheck(lo, stack=n) == [], path
    if arch == "gemma3-12b":
        emb = plan.layouts[plan.paths.index(("embed",))]
        rows, cols = TC.view_rows_cols(emb)
        assert n * rows * cols == n * 262144 * 3840


# --------------------------------------------------------------------- #
# elementary layers
# --------------------------------------------------------------------- #

def test_rms_norm_and_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    want = RL.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    # zeros-initialized scale: a gain of exactly one
    assert TL.norm_template("rmsnorm", 64)["scale"].init == "zeros"
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    # weights at the templates' init scale
    p = {k: (rng.standard_normal(s) * 0.02).astype(np.float32) for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    got = TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), "swiglu")
    want = RL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), "swiglu")
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.3])
def test_apply_rope_matches_reference(fraction, theta):
    """Full and partial rotation (0.3 of 32 dims rounds down to 8) at
    gpt2's theta and gemma3's; positions up to 30000."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 30000, (2, 7)).astype(np.int32)
    got = TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                        fraction)
    want = RR.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    rot = int(32 * fraction) // 2 * 2
    assert np.array_equal(got.numpy()[..., rot:], x[..., rot:])


# --------------------------------------------------------------------- #
# forward, gradients, remat
# --------------------------------------------------------------------- #

FORWARD_CASES = [(a, {}) for a in ARCHS] + [
    ("gemma3-12b", {"rope_theta": 1e6}),          # FULL's theta
    ("chatglm3-6b", {"blockwise_threshold": 16}),  # the flash-style path
    ("gemma3-12b", {"blockwise_threshold": 16})]


@pytest.mark.parametrize("arch,change", FORWARD_CASES,
                         ids=[f"{a}-{'-'.join(c) or 'as-is'}"
                              for a, c in FORWARD_CASES])
def test_forward_and_grads_match_reference(arch, change):
    rc, pc = (dataclasses.replace(c, **change) for c in _cfgs(arch, "smoke"))
    rp = RL.init_params(RT.model_template(rc), jax.random.PRNGKey(3))
    tp = interop.params_from_reference(jax.device_get(rp))
    toks, labels = _batch(rc.vocab)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    want, _ = RT.forward(rp, rc, rb)
    got, _ = TT.forward(tp, pc, tb)
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 1e-5
    (rl, _), rg = jax.value_and_grad(lambda p: RT.lm_loss(p, rc, rb),
                                     has_aux=True)(rp)
    tl, tg = _grads(tp, pc, tb)
    assert abs(float(tl) - float(rl)) <= 1e-5
    for a, g in zip(jax.tree.leaves(rg), tg):
        a = np.asarray(a)
        assert np.abs(g.numpy() - a).max() <= 1e-5 * np.abs(a).max() + 1e-12


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_for_bit(arch, monkeypatch):
    """``cfg.remat``: every layer checkpointed in the backward, loss and
    gradients bit for bit the run without it; prefill and decode run
    without autograd and checkpoint nothing."""
    pc = port_get(arch).smoke
    tp = TL.init_params(TT.model_template(pc), 0)
    toks, labels = _batch(pc.vocab, seed=2)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    calls = []
    real = TT.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TT, "checkpoint", counted)
    l0, g0 = _grads(tp, dataclasses.replace(pc, remat=False), tb)
    assert not calls
    rcfg = dataclasses.replace(pc, remat=True)
    l1, g1 = _grads(tp, rcfg, tb)
    assert len(calls) == pc.n_layers
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    cache = TT.init_cache(rcfg, 2, 32, torch.float32)
    TT.prefill(tp, rcfg, {"tokens": tb["tokens"][:, :8]}, cache)
    assert len(calls) == pc.n_layers


def _old_apply_rope(x, positions, theta=10000.0):
    """The port's rotary embedding before it took a theta and a fraction
    from the config: the whole head dim at 10000."""
    half = x.shape[-1] // 2
    inv = TR._freqs(half, 10000.0, x.device)
    ang = positions.to(torch.float32)[..., None] * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@pytest.mark.parametrize("arch", ["gpt2", "bert-base"])
def test_theta_repair_leaves_gpt2_and_bert_bit_for_bit(arch, monkeypatch):
    """gpt2 and bert rotate at theta 1e4 over the whole head: their loss,
    gradients and decode logits are bit for bit those of the rotary
    embedding the port had before it honoured ``cfg.rope_theta`` and
    ``cfg.rope_fraction``."""
    pc = port_get(arch).smoke
    tp = TL.init_params(TT.model_template(pc), 0)
    toks, labels = _batch(pc.vocab, seed=4)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}

    def serve():
        cache = TT.init_cache(pc, 2, 32, torch.float32)
        out, _ = TT.prefill(tp, pc, {"tokens": tb["tokens"][:, :9]}, cache)
        lg, _ = TT.decode(tp, pc, tb["tokens"][:, 9:10], cache, 9)
        return out, lg

    new = (_grads(tp, pc, tb), serve())
    monkeypatch.setattr(TR, "apply_rope", lambda x, pos, theta, frac: (
        _old_apply_rope(x, pos) if (theta, frac) == (10000.0, 1.0)
        else pytest.fail("gpt2/bert asked for another rotation")))
    old = (_grads(tp, pc, tb), serve())
    (l0, g0), s0 = new
    (l1, g1), s1 = old
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


# --------------------------------------------------------------------- #
# the trainer, the CLI, checkpoints
# --------------------------------------------------------------------- #

def _opt_cfgs(lr=LR):
    ref = RefOptimizerConfig(
        name="zero_one_adam", lr=RS.ConstantLr(lr),
        var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2))
    port = TA.OptimizerConfig(
        name="zero_one_adam", lr=TS.ConstantLr(lr),
        var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2))
    return ref, port


def _port_batch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


def _param_diff(ref_params, port_params):
    return np.concatenate([
        np.abs(np.asarray(a) - b.numpy()).ravel()
        for a, b in zip(jax.tree.leaves(ref_params),
                        flatten_tree(port_params)[1])])


@pytest.mark.parametrize("arch", ARCHS)
def test_sim_trainer_matches_reference(arch):
    """8 steps of ``zero_one_adam`` with 4 simulated workers from the
    reference's draw and on its batches (see the module docstring for
    the lr)."""
    rcfg, pcfg = _opt_cfgs()
    rt = RefTrainer(ref_get(arch).smoke, rcfg, n_workers=N)
    rp, rs = rt.sim_init(jax.random.PRNGKey(0))
    ref_step = rt.sim_step_fn()
    pt = TSTEP.Trainer(port_get(arch).smoke, pcfg, comm=SimComm(N),
                       device="cpu")
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    flags = []
    for t in range(STEPS):
        b = data.batch(t)
        rp, rs, rm = ref_step(rp, rs, b)
        if t == FAULT_STEP:
            skipped = copy.deepcopy((tp, ts))
        tp, ts, tm = pt.step(tp, ts, _port_batch(b))
        flags.append((tm["synced"], tm["var_round"]))
        assert abs(float(tm["loss"]) - float(rm["loss"][0])) < 1e-4, t
    diff = _param_diff(rp, tp)
    assert (diff <= 1e-4).mean() >= 0.99
    assert diff.max() <= 0.05
    # the bars' power: the port with the sync step FAULT_STEP's update
    # left out (its params and state kept, then the last steps taken)
    # fails the params bar by far
    fp, fs = skipped
    for t in range(FAULT_STEP + 1, STEPS):
        fp, fs, _ = pt.step(fp, fs, _port_batch(data.batch(t)))
    assert (_param_diff(rp, fp) <= 1e-4).mean() < 0.7
    assert [f[0] for f in flags] == [1, 1, 1, 1, 1, 0, 1, 0]
    assert [f[1] for f in flags] == [1, 1, 0, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_each_family_config_on_cpu(arch, capsys):
    TLAUNCH.main(["--arch", arch, "--smoke", "--mode", "sim", "--workers",
                  "4", "--steps", "3", "--batch", "8", "--seq", "16",
                  "--sync-warmup", "2", "--double-every", "2", "--kappa",
                  "1", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    name = port_get(arch).smoke.name
    assert f"arch={name}" in out and "DONE: 3 steps" in out
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert abs(losses[0] - np.log(512)) < 0.5


def test_chip_smoke_cut_depth_cuts_depth_only(monkeypatch):
    """``chip_smoke.cut_depth``, which phase 9 trains the FULL configs
    through: the CLI's trainer at the cut depth and the config's widths
    inside the block, the registered config after it."""
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    smoke = importlib.import_module("chip_smoke")
    args = TLAUNCH.parse_args(["--arch", "granite-3-8b", "--device", "cpu"])
    full = port_get("granite-3-8b").config
    with smoke.cut_depth(1):
        cut = TLAUNCH.make_trainer(args).model_cfg
    assert cut == dataclasses.replace(full, n_layers=1)
    with smoke.cut_depth(None):
        assert TLAUNCH.make_trainer(args).model_cfg == full
    assert TLAUNCH.get is port_get


def test_checkpoints_cross_packages_for_granite(tmp_path):
    """granite-smoke after 2 sim steps: the port's checkpoint restores in
    the reference and the reference's in the port, params and state bit
    for bit."""
    rcfg, pcfg = _opt_cfgs(3e-4)
    arch = "granite-3-8b"
    rt = RefTrainer(ref_get(arch).smoke, rcfg, n_workers=N)
    pt = TSTEP.Trainer(port_get(arch).smoke, pcfg, comm=SimComm(N),
                       device="cpu")
    rp, rs = rt.sim_init(jax.random.PRNGKey(0))
    tp = interop.params_from_reference(jax.device_get(rp))
    ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=S,
                                        global_batch=B, seed=0))
    for t in range(2):
        tp, ts, _ = pt.step(tp, ts, _port_batch(data.batch(t)))
    port_path, ref_path = str(tmp_path / "p.npz"), str(tmp_path / "r.npz")
    pt.save(port_path, tp, ts, step=2, meta={"arch": "granite-smoke"})
    like = jax.eval_shape(lambda: dict(zip(
        ("params", "state"), rt.sim_init(jax.random.PRNGKey(0)))))
    tree, step, meta = ref_io.restore(port_path, like)
    assert (step, meta) == (2, {"arch": "granite-smoke"})
    got_p = interop.params_from_reference(jax.device_get(tree["params"]))
    got_s = interop.state_from_reference(jax.device_get(tree["state"]),
                                         pt.opt)
    _same_trees(got_p, got_s, tp, ts)
    ref_io.save(ref_path, tree, step=2, meta=meta)
    p2, s2, step2, _ = pt.restore(ref_path)
    assert step2 == 2
    _same_trees(p2, s2, tp, ts)


def _same_trees(p, s, want_p, want_s):
    assert (s.step, s.sync_pstate, s.var_pstate) == (
        want_s.step, want_s.sync_pstate, want_s.var_pstate)
    for a, b in zip(flatten_tree(p)[1], flatten_tree(want_p)[1]):
        assert torch.equal(a, b)
    for name in ("u", "err_w", "err_s", "anchor"):
        for a, b in zip(getattr(s, name), getattr(want_s, name)):
            assert torch.equal(a, b), name
    for name in want_s.slots:
        for a, b in zip(s.slots[name], want_s.slots[name]):
            assert torch.equal(a, b), name
