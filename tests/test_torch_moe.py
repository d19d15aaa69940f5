"""The port's mixture of experts (``models/moe.py``) and multi-head latent
attention (``attention.mla_forward``) against the reference live, in one
process: the llama4-scout and deepseek-v2 configs, templates with their
expert-parallel leaves, the trainer's EP planning and layouts, the
router's dispatch, the MoE layer, MLA, the logits, the routing of the
simulator against one worker, and ``comm_accounting``.

Tolerances, with their reasons:
* configs, templates (shape, spec, ``dp``, ``ep_axis``), the EP degree,
  layouts and exchange units, ``_dispatch_indices`` and
  ``comm_accounting``: equal;
* ``moe_forward`` (outputs, aux loss, dropped fraction; with and without
  drops, top-1 with a shared expert and top-2 without) and
  ``mla_forward``: within 1e-6 (f32 matmuls and reductions in another
  order; measured <= 2.4e-7 on the outputs); the MoE layer's gradients
  within 1e-5 of each leaf's largest magnitude;
* ``forward`` logits and ``lm_loss`` within 1e-5 (measured <= 4.8e-7 and
  <= 1e-6);
* the 8-step trainers under ``adam`` (single mode, EP 2, EP 4): the bars
  of ``tests/test_torch_moe_train.py``, whose runner they share
  (measured: every param within 1.6e-5);
* the simulator's routing against one worker, the reference's own bars
  (``tests/test_train_integration.py``): the first-step loss within 0.05
  (each simulated worker's capacity drops tokens that one worker over
  the whole batch keeps) and, with ``capacity_factor=8`` where nothing
  drops, within 2e-3 (the aux term averages per-worker histograms).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core.api import comm_accounting as ref_accounting
from repro.core.comm import Hierarchy as RefHierarchy
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models import rope as RR
from repro.models import transformer as RT
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import schedules as TS
from repro_torch.core.comm import Hierarchy, NullComm, SimComm
from repro_torch.core.compressed import comm_accounting
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.models import attention as TATT
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.train import step as TSTEP
from test_torch_moe_train import check_trainer_against_reference

torch.set_num_threads(1)

ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]


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


def _port_cfg(name="zero_one_adam", inner=None):
    return TA.OptimizerConfig(
        name=name, hierarchy=Hierarchy(inner) if inner else None)


def _ref_cfg(name="zero_one_adam", inner=None):
    return RefOptimizerConfig(
        name=name, hierarchy=RefHierarchy(inner=inner) if inner else None)


# --------------------------------------------------------------------- #
# configs, templates, the EP plan, layouts
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, which):
    rc, pc = _cfgs(arch, which)
    for f in dataclasses.fields(pc):
        if f.name in ("param_dtype", "compute_dtype"):
            continue
        assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    assert (pc.hd, pc.padded_vocab) == (rc.hd, rc.padded_vocab)


@pytest.mark.parametrize("ep", [1, 2, 4])
@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_templates_match_reference(arch, which, ep):
    """Every leaf's path, shape, init, spec, DP membership and expert
    axis (the dense prefix, MLA, the router, the experts, the shared
    experts)."""
    rc, pc = _cfgs(arch, which)
    ref = _ref_leaves(RT.model_template(rc, ep_workers=ep))
    port = _port_leaves(TT.model_template(pc, ep_workers=ep))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(port, ref):
        spec = tuple(b.spec) if b.spec is not None else None
        assert (a.shape, a.init, a.dp, a.ep_axis) == (
            tuple(b.shape), b.init, b.dp, b.ep_axis), path
        assert a.spec == spec and a.scale == b.scale, path
    n_ep = sum(1 for _, pd in port if not pd.dp)
    assert n_ep == (3 if ep > 1 else 0)


@pytest.mark.parametrize("n,inner", [(1, None), (2, None), (4, None),
                                     (2, 2), (4, 2)])
@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_plan_and_layouts_match_reference(arch, which, n, inner):
    """The trainer's EP degree, its workers' local shapes, the optimizer's
    DP mask, layouts and exchange units, at n workers flat and in pods of
    two (the plan only: nothing is allocated at FULL)."""
    rc, pc = _cfgs(arch, which)
    rt = RefTrainer(rc, _ref_cfg(inner=inner), n_workers=n)
    pt = TSTEP.Trainer(pc, _port_cfg(inner=inner),
                       comm=SimComm(n) if n > 1 else NullComm(),
                       device="cpu")
    assert pt.ep_degree == rt.ep_degree
    assert pt.ep_degree == (n if n > 1 else 1)
    ro, po = rt.opt, pt.opt
    assert list(po.dp) == list(ro.dp_mask)
    assert [tuple(s) for s in flatten_tree(pt.local_shapes)[1]] == [
        tuple(x.shape) for x in jax.tree.leaves(rt.local_abstract)]
    for a, b in zip(po.layouts, ro.layouts):
        assert (a.shape, a.view_shape, a.pad, a.flatten) == (
            tuple(b.shape), tuple(b.view_shape), b.pad, b.flatten)
    assert [u.members for u in po.units] == [u.members for u in ro.units]


@pytest.mark.parametrize("E,n,inner", [(4, 4, None), (4, 8, None),
                                       (4, 8, 4), (6, 4, 2), (160, 4, None),
                                       (16, 32, 16), (5, 4, 2), (0, 4, None)])
def test_choose_ep_matches_reference(E, n, inner):
    """The largest suffix of the worker axes whose size divides E."""
    cfg = dataclasses.replace(ref_get("llama4-scout-17b-a16e").smoke,
                              n_experts=max(E, 1))
    rt = RefTrainer.__new__(RefTrainer)
    rt.mesh, rt.n_workers, rt.model_cfg = None, n, dataclasses.replace(
        cfg, n_experts=E)
    rt.hierarchy = RefHierarchy(inner=inner) if inner else None
    rt.tc = None
    _, want = rt._choose_ep(("workers",))
    got = TSTEP.choose_ep(E, n, Hierarchy(inner) if inner else None)
    assert got == want


# --------------------------------------------------------------------- #
# the router's dispatch, the MoE layer, MLA
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("E,T", [(4, 64), (16, 200), (160, 1024)])
def test_dispatch_indices_match_reference(E, T, seed):
    eids = np.random.default_rng(seed).integers(0, E, T).astype(np.int32)
    want = np.asarray(RMOE._dispatch_indices(jnp.asarray(eids), E, 8))
    got = TMOE._dispatch_indices(torch.from_numpy(eids).long(), E, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


MOE_CASES = {   # id -> (top_k, n_shared, capacity_factor)
    "top1_shared_drops": (1, 1, 1.0), "top1_shared": (1, 1, 2.0),
    "top2_drops": (2, 0, 0.5), "top2_shared_cf8": (2, 1, 8.0)}


def _moe_inputs(case, seed=0):
    k, shared, cf = MOE_CASES[case]
    d, ff, E = 32, 48, 4
    tmpl = RMOE.moe_template(d, ff, E, shared, 1)
    rp = RL.init_params(tmpl, jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).standard_normal((2, 24, d)).astype(
        np.float32)
    return rp, x, dict(top_k=k, n_experts=E, capacity_factor=cf)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(case):
    rp, x, kw = _moe_inputs(case)
    want, wmet = RMOE.moe_forward(rp, jnp.asarray(x), **kw)
    tp = interop.params_from_reference(jax.device_get(rp))
    got, gmet = TMOE.moe_forward(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    for key in ("aux_loss", "dropped_frac"):
        assert abs(float(gmet[key]) - float(wmet[key])) <= 1e-6, key
    dropped = float(wmet["dropped_frac"])
    assert (dropped > 0) == case.endswith("drops"), dropped


@pytest.mark.parametrize("case", ["top1_shared_drops", "top2_shared_cf8"])
def test_moe_grads_match_reference(case):
    """The gradients of every MoE leaf and of the input, dropped
    assignments included (they get none through the dispatch)."""
    rp, x, kw = _moe_inputs(case, seed=3)

    def ref_loss(p, xx):
        out, met = RMOE.moe_forward(p, xx, **kw)
        return jnp.sum(out * out) + met["aux_loss"]

    rg, rgx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in
          interop.params_from_reference(jax.device_get(rp)).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, met = TMOE.moe_forward(tp, tx, **kw)
    (torch.sum(out * out) + met["aux_loss"]).backward()
    for k in tp:
        want = np.asarray(rg[k])
        np.testing.assert_allclose(
            tp[k].grad.numpy(), want, rtol=0,
            atol=1e-5 * float(np.abs(want).max()) + 1e-12, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgx), rtol=0,
                               atol=1e-5 * float(np.abs(rgx).max()))


def test_mla_forward_matches_reference():
    rc, pc = _cfgs("deepseek-v2-236b", "smoke")
    tmpl = RA.mla_template(rc.d_model, rc.n_heads, rc.kv_lora_rank,
                           rc.mla_qk_nope, rc.mla_qk_rope, rc.mla_v_dim)
    rp = RL.init_params(tmpl, jax.random.PRNGKey(4))
    x = np.random.default_rng(4).standard_normal(
        (2, 20, rc.d_model)).astype(np.float32)
    pos = np.array(RR.text_positions(2, 20))
    want, _ = RA.mla_forward(rp, rc, jnp.asarray(x), jnp.asarray(pos))
    tp = interop.params_from_reference(jax.device_get(rp))
    got, _ = TATT.mla_forward(tp, pc, torch.from_numpy(x),
                              torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss_match_reference(arch):
    rc, pc = _cfgs(arch, "smoke")
    rp = RL.init_params(RT.model_template(rc), jax.random.PRNGKey(0))
    tp = interop.params_from_reference(jax.device_get(rp))
    toks = np.random.default_rng(0).integers(0, rc.vocab, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    want, waux = RT.forward(rp, rc, {"tokens": jnp.asarray(batch["tokens"])})
    got, gaux = TT.forward(tp, pc, {"tokens": torch.from_numpy(
        batch["tokens"]).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert abs(float(gaux) - float(waux)) <= 1e-6
    wl, wm = RT.lm_loss(rp, rc, {k: jnp.asarray(v) for k, v in batch.items()})
    gl, gm = TT.lm_loss(tp, pc, {k: torch.from_numpy(v).long()
                                 for k, v in batch.items()})
    assert abs(float(gl) - float(wl)) <= 1e-5
    assert abs(float(gm["nll"]) - float(wm["nll"])) <= 1e-5


@pytest.mark.parametrize("how", ["comm", "mesh"])
def test_dense_server_across_devices_is_refused(how):
    """A dense model's Server given a comm or a mesh needs tensor
    parallelism (ROADMAP item 3); MoE and MLA serve (their caches exist)."""
    from repro_torch.serve import Server

    kw = {"comm": SimComm(2)} if how == "comm" else {"mesh": object()}
    with pytest.raises(NotImplementedError, match="ROADMAP queue item 3"):
        Server(port_get("gpt2").smoke, device="cpu", **kw)
    for arch in ARCHS:
        assert TT.init_cache(port_get(arch).smoke, 1, 16)


def test_ep_exchange_of_one_worker():
    """A process's EP exchange of one worker: NullComm returns it; the
    simulator, whose forward runs one worker at a time, refuses it."""
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert NullComm().ep_all_to_all(x) is x
    with pytest.raises(NotImplementedError, match="merged experts"):
        SimComm(4).ep_all_to_all(torch.zeros(4, 2))


# --------------------------------------------------------------------- #
# the simulator's routing against one worker (the reference's tests)
# --------------------------------------------------------------------- #


def _port_first_loss(cfg, n):
    opt = TA.OptimizerConfig(
        name="zero_one_adam",
        lr=TS.LinearWarmupExpDecay(peak_lr=2e-3, warmup_steps=10,
                                   decay=0.97, decay_period=20),
        var_policy=TS.AdaptiveFreezePolicy(kappa=4),
        sync_policy=TS.LrProportionalSyncPolicy(
            warmup_steps=10, double_every=20, max_interval=4))
    tr = TSTEP.Trainer(cfg, opt, comm=SimComm(n) if n > 1 else NullComm(),
                       device="cpu")
    rt = RefTrainer(ref_get("llama4-scout-17b-a16e").smoke,
                    RefOptimizerConfig(), n_workers=1)
    # both regimes start from the reference's draw, merged per worker
    rp = jax.device_get(RL.init_params(rt.template, jax.random.PRNGKey(0)))
    paths, leaves = flatten_tree(interop.params_from_reference(rp))
    stacked = []
    for i, x in enumerate(leaves):
        a = tr.ep_leaf_axes.get(i)
        stacked.append(x[None].expand((n,) + x.shape).clone() if a is None
                       else x.unflatten(a, (n, -1)).movedim(a, 0)
                       .contiguous())
    params = unflatten_tree(paths, stacked)
    state = tr.opt.init(params)
    data = RefSyntheticLM(RefDataConfig(vocab=cfg.vocab, seq_len=16,
                                        global_batch=8, seed=3))
    batch = {k: torch.from_numpy(np.array(v)).long()
             for k, v in data.batch(0).items()}
    _, _, met = tr.step(params, state, batch)
    return float(met["loss"])


def test_moe_ep_sim_matches_single_worker_routing():
    cfg = port_get("llama4-scout-17b-a16e").smoke
    l1, l4 = _port_first_loss(cfg, 1), _port_first_loss(cfg, 4)
    assert abs(l1 - l4) < 0.05, (l1, l4)


def test_moe_ep_sim_exact_when_no_drops():
    cfg = dataclasses.replace(port_get("llama4-scout-17b-a16e").smoke,
                              capacity_factor=8.0)
    l1, l4 = _port_first_loss(cfg, 1), _port_first_loss(cfg, 4)
    assert abs(l1 - l4) < 2e-3, (l1, l4)


# --------------------------------------------------------------------- #
# comm_accounting: DP leaves only
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("inner", [None, 2])
@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_comm_accounting_matches_reference(arch, which, inner):
    rc, pc = _cfgs(arch, which)
    rt = RefTrainer(rc, _ref_cfg(inner=inner), n_workers=4)
    pt = TSTEP.Trainer(pc, _port_cfg(inner=inner), comm=SimComm(4),
                       device="cpu")
    want = ref_accounting(rt.opt)
    got = comm_accounting(pt.opt)
    for k, v in got.items():
        assert k in want and want[k] == v, (k, v, want.get(k))
    dp = sum(int(np.prod(s)) for s, d in zip(
        flatten_tree(pt.local_shapes)[1], pt.opt.dp) if d)
    assert got["dp_params"] == dp < sum(
        int(np.prod(s)) for s in flatten_tree(pt.local_shapes)[1])


# --------------------------------------------------------------------- #
# the trainers under the uncompressed baseline
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_adam_trainer_matches_reference(arch, n):
    """``adam`` (a bf16 mean of the DP gradients every step; the experts'
    plain local step) for 8 steps against the reference."""
    check_trainer_against_reference(arch, n, "adam")
