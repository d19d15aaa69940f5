"""The port's state-space family (mamba2-2.7b; zamba2-1.2b, the hybrid
with one shared attention block) on the training side, against the
reference live in one process: configs, templates, comm layouts and
``comm_accounting`` at SMOKE and FULL (FULL as metadata only), the
kernels' frame pre-check on every FULL unit, the SSM layer's parts
(``_causal_conv``, ``_conv_step``, ``ssd_chunked`` with its gradients,
``ssm_forward`` in its three modes), whole-model logits and gradients,
remat, prefill + decode against the full forward, the audit and the
CLI (the trainers: ``tests/test_torch_ssm_train.py`` and
``tests/test_torch_ssm_hybrid_train.py``; zamba2's ``adam`` trainers
and its reshard: ``tests/test_torch_ssm_hybrid.py``). Inputs from
numpy seeds; params from the reference's draw through
``repro_torch.interop``.

Tolerances, with their reasons:
* configs, templates, layouts, ``comm_accounting``, pre-check verdicts,
  the audit's verdict: equal;
* the SSM layer's parts, logits, gradients: 1e-5 (f32 sums, ``cumsum``
  and the SSD's contractions in another order); the model's gradients
  within 1e-5 of each leaf's largest magnitude;
* ``ssd_chunked`` at chunk 256 on a 2-head toy (dt = softplus(0), A =
  -1): the reference's dt-gradient is NaN in every element (its
  ``where(causal, exp(seg), 0)`` sends 0 * inf into ``exp``'s VJP); the
  port's is finite and within 1e-5 of its own gradient at chunk 64 on
  the same inputs (the SSD does not depend on the chunk); its forward
  within 1e-4 of the f64 recurrence (relative to the largest output)
  and no further from it than twice the reference's error, since the
  cumulative decay reaches -177 within the chunk, where an f32 ulp is
  1.5e-5 in either package;
* remat on against off, in the port: bit for bit;
* prefill + decode against the full forward at a chunk of the whole
  sequence: 2e-3, the reference's own bar
  (``tests/test_arch_smoke.py::test_smoke_decode_consistency``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import leafwise as RLW
from repro.core.api import comm_accounting as ref_accounting
from repro.models import layers as RL
from repro.models import ssm as RSSM
from repro.models import transformer as RT
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.analysis import ir_audit as IA
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import leafwise as TLW
from repro_torch.core.comm import SimComm
from repro_torch.core.compressed import comm_accounting
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.kernels import dispatch as KD
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.train import step as TSTEP

torch.set_num_threads(1)

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
_MODELS = {}


def _cfgs(arch, which):
    attr = "smoke" if which == "smoke" else "config"
    return getattr(ref_get(arch), attr), getattr(port_get(arch), attr)


def _model(arch, seed=3):
    """(reference cfg, port cfg, reference params, port params) of the
    smoke config, cached per (arch, seed)."""
    if (arch, seed) not in _MODELS:
        rc, pc = _cfgs(arch, "smoke")
        rp = RL.init_params(RT.model_template(rc), jax.random.PRNGKey(seed))
        _MODELS[arch, seed] = (rc, pc, rp, interop.params_from_reference(
            jax.device_get(rp)))
    return _MODELS[arch, seed]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _maxdiff(a, b):
    return float(np.abs(_np(a).astype(np.float64) - _np(b)).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_leaves(tmpl):
    flat, _ = jax.tree_util.tree_flatten_with_path(tmpl, is_leaf=RL.is_pd)
    return [(tuple(str(k.key) for k in path), pd) for path, pd in flat]


def _port_leaves(tmpl):
    out = []
    TL._map(tmpl, lambda path, pd: out.append((path, pd)))
    return sorted(out, key=lambda x: x[0])


# --------------------------------------------------------------------- #
# configs, templates, layouts, accounting
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, which):
    rc, pc = _cfgs(arch, which)
    for f in dataclasses.fields(pc):
        if f.name in ("param_dtype", "compute_dtype"):
            continue
        assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    assert (pc.ssm_heads, pc.d_inner, pc.n_attn_apps, pc.padded_vocab) == (
        rc.ssm_heads, rc.d_inner, rc.n_attn_apps, rc.padded_vocab)


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_templates_match_reference(arch, which):
    """Leaf for leaf: paths, shapes, init kinds and scales, tensor-parallel
    specs and DP membership (FULL as templates only)."""
    rc, pc = _cfgs(arch, which)
    ref, port = (_ref_leaves(RT.model_template(rc)),
                 _port_leaves(TT.model_template(pc)))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, port):
        assert tuple(b.shape) == tuple(a.shape), path
        assert (b.init, b.scale, b.dp) == (a.init, a.scale, a.dp), path
        assert b.spec == (None if a.spec is None else tuple(a.spec)), path
    inits = {p[-1]: pd.init for p, pd in port if p[0] == "blocks"}
    assert (inits["A_log"], inits["D"], inits["dt_bias"], inits["norm"]) \
        == ("zeros", "ones", "zeros", "zeros")
    assert ("shared_attn" in {p[0] for p, _ in port}) == (arch ==
                                                           "zamba2-1.2b")
    if which == "full":
        total = sum(int(np.prod(pd.shape)) for _, pd in port)
        # counted with the reference's templates
        assert total == {"mamba2-2.7b": 2_831_730_176,
                         "zamba2-1.2b": 1_170_313_344}[arch]


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


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_comm_accounting_matches_reference(arch, which):
    rc, pc = _cfgs(arch, which)
    rt = RefTrainer(rc, RefOptimizerConfig(name="zero_one_adam"),
                    n_workers=4)
    pt = TSTEP.Trainer(pc, TA.OptimizerConfig(name="zero_one_adam"),
                       comm=SimComm(4), device="cpu")
    want, got = ref_accounting(rt.opt), comm_accounting(pt.opt)
    for k, v in got.items():
        assert k in want and want[k] == v, (k, v, want.get(k))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_frame_precheck_passes_on_every_full_unit(arch, n):
    """Every unit of the FULL configs at full depth, ``n`` workers stacked
    in one launch, within the CUDA kernels' launch contract (the stacked
    (64, 2560, 5120) projections and the (64, 80) leaves among them)."""
    pc = port_get(arch).config
    tt = TT.model_template(pc)
    plan = TLW.make_plan(TL.param_shapes(tt), TL.param_specs(tt),
                         TL.dp_mask(tt), n)
    for path, lo in zip(plan.paths, plan.layouts):
        assert KD.frame_precheck(lo, stack=n) == [], path


# --------------------------------------------------------------------- #
# the SSM layer's parts
# --------------------------------------------------------------------- #

def test_causal_conv_and_conv_step_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    assert _maxdiff(TSSM._causal_conv(_t(x), _t(w)),
                    RSSM._causal_conv(jnp.asarray(x), jnp.asarray(w))) \
        <= 1e-5
    y, s2 = TSSM._conv_step(_t(x[:, 0]), _t(st), _t(w))
    ry, rs2 = RSSM._conv_step(jnp.asarray(x[:, 0]), jnp.asarray(st),
                              jnp.asarray(w))
    assert _maxdiff(y, ry) <= 1e-5
    assert np.array_equal(s2.numpy(), np.asarray(rs2))


def _ssd_inputs(seed, b=2, L=32, h=4, p=8, n=6, dt_zero=False):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, L, h, p)).astype(np.float32)
    raw = (np.zeros((b, L, h)) if dt_zero
           else rng.standard_normal((b, L, h)))
    dt = np.log1p(np.exp(raw)).astype(np.float32)          # softplus
    A = (-np.ones(h) if dt_zero
         else -np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    Bh = rng.standard_normal((b, L, h, n)).astype(np.float32)
    Ch = rng.standard_normal((b, L, h, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xh, dt, A, Bh, Ch, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    xh, dt, A, Bh, Ch, h0 = _ssd_inputs(1)
    args = (xh, dt, A, Bh, Ch)
    y, hT = TSSM.ssd_chunked(*map(_t, args), chunk,
                             _t(h0) if with_h0 else None)
    ry, rh = RSSM.ssd_chunked(*map(jnp.asarray, args), chunk,
                              jnp.asarray(h0) if with_h0 else None)
    assert _maxdiff(y, ry) <= 1e-5 and _maxdiff(hT, rh) <= 1e-5
    assert hT.dtype == torch.float32


def _ssd_grads_port(args, chunk):
    ts = [_t(a).requires_grad_(True) for a in args]
    y, hT = TSSM.ssd_chunked(*ts, chunk)
    (y.sum() + hT.sum()).backward()
    return [t.grad.numpy() for t in ts]


def _ssd_grads_ref(args, chunk):
    def f(*a):
        y, hT = RSSM.ssd_chunked(*a, chunk)
        return y.sum() + hT.sum()
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))]


@pytest.mark.parametrize("chunk", [8, 64])
def test_ssd_chunked_gradients_match_reference(chunk):
    """Every input's gradient of ``y.sum() + hT.sum()`` within 1e-5 (of
    the leaf's largest magnitude where that is above 1)."""
    args = _ssd_inputs(2, b=1, L=128, h=2, p=4, n=4)[:5]
    for g, r in zip(_ssd_grads_port(args, chunk),
                    _ssd_grads_ref(args, chunk)):
        assert np.isfinite(r).all()
        assert np.abs(g - r).max() <= 1e-5 * max(1.0, np.abs(r).max())


def test_chunk_256_gradient_finite_where_the_reference_is_nan():
    """The published chunk on a 2-head toy (dt = softplus(0), A = -1, so
    the segment sums above the diagonal reach 0.69 * 255 > 88.7): the
    reference's dt-gradient of ``y.sum()`` is NaN in all 1024 elements;
    the port's is finite and equals its own chunk-64 gradient."""
    xh, dt, A, Bh, Ch, _ = _ssd_inputs(3, b=2, L=256, h=2, p=4, n=4,
                                       dt_zero=True)
    assert dt.size == 1024

    def ref_loss(d):
        return RSSM.ssd_chunked(jnp.asarray(xh), d, jnp.asarray(A),
                                jnp.asarray(Bh), jnp.asarray(Ch), 256)[0].sum()
    rg = np.asarray(jax.grad(ref_loss)(jnp.asarray(dt)))
    assert np.isnan(rg).all()

    def port_grad(chunk):
        d = _t(dt).requires_grad_(True)
        TSSM.ssd_chunked(_t(xh), d, _t(A), _t(Bh), _t(Ch), chunk)[0].sum(
        ).backward()
        return d.grad.numpy()
    g256, g64 = port_grad(256), port_grad(64)
    assert np.isfinite(g256).all()
    assert np.abs(g256 - g64).max() <= 1e-5 * max(1.0, np.abs(g64).max())
    # the forward: the cumulative decay reaches -177 within the chunk,
    # where an f32 ulp is 1.5e-5, so both packages' segment sums carry
    # that much error; each is held to the f64 recurrence, the port no
    # further from it than the reference
    y = TSSM.ssd_chunked(*map(_t, (xh, dt, A, Bh, Ch)), 256)[0].numpy()
    ry = np.asarray(RSSM.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bh, Ch)),
                                     256)[0])
    exact = _recurrence_f64(xh, dt, A, Bh, Ch)
    port_err, ref_err = (float(np.abs(v - exact).max()) for v in (y, ry))
    assert port_err <= 1e-4 * np.abs(exact).max()
    assert port_err <= 2 * ref_err + 1e-6, (port_err, ref_err)


def _recurrence_f64(xh, dt, A, Bh, Ch):
    """y of the SSM by its sequential recurrence in f64: h_t = exp(dt_t
    A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t."""
    b, L, H, P = xh.shape
    h = np.zeros((b, H, P, Bh.shape[-1]))
    ys = []
    for t in range(L):
        d = dt[:, t].astype(np.float64)                      # (b, H)
        h = (h * np.exp(d * A)[:, :, None, None]
             + np.einsum("bhp,bhn->bhpn", xh[:, t] * d[..., None],
                         Bh[:, t].astype(np.float64)))
        ys.append(np.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return np.stack(ys, axis=1)


def test_ssd_chunked_refuses_a_partial_chunk():
    xh, dt, A, Bh, Ch, _ = _ssd_inputs(4, L=20)
    with pytest.raises(ValueError, match="not a multiple of the chunk 8"):
        TSSM.ssd_chunked(*map(_t, (xh, dt, A, Bh, Ch)), 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_matches_reference(arch):
    """Layer 0 of the smoke model: train (no state), prefill from a zero
    state (the final state returned, in place in the port), then three
    decodes of one token."""
    rc, pc, rp, tp = _model(arch)
    lp = {k: v[0] for k, v in tp["blocks"]["ssm"].items()}
    rlp = jax.tree.map(lambda v: v[0], rp["blocks"]["ssm"])
    x = np.random.default_rng(5).standard_normal((2, 19, rc.d_model)
                                                 ).astype(np.float32)
    got, none = TSSM.ssm_forward(lp, pc, _t(x[:, :16]))
    want, _ = RSSM.ssm_forward(rlp, rc, jnp.asarray(x[:, :16]))
    assert none is None and _maxdiff(got, want) <= 1e-5
    state = TSSM.init_ssm_state(pc, 2)
    rstate = RSSM.init_ssm_state(rc, 2)
    got, st = TSSM.ssm_forward(lp, pc, _t(x[:, :16]), state=state)
    want, rstate = RSSM.ssm_forward(rlp, rc, jnp.asarray(x[:, :16]),
                                    state=rstate)
    assert st is state and _maxdiff(got, want) <= 1e-5
    for i in range(16, 19):
        got, _ = TSSM.ssm_forward(lp, pc, _t(x[:, i:i + 1]), state=state,
                                  decode=True)
        want, rstate = RSSM.ssm_forward(rlp, rc, jnp.asarray(x[:, i:i + 1]),
                                        state=rstate, decode=True)
        assert _maxdiff(got, want) <= 1e-5, i
    for k in ("h", "conv_x", "conv_B", "conv_C"):
        assert _maxdiff(state[k], rstate[k]) <= 1e-5, k


# --------------------------------------------------------------------- #
# the model: logits, gradients, remat, prefill and decode
# --------------------------------------------------------------------- #

def _grads(params, cfg, batch):
    paths, leaves = flatten_tree(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss, _ = TT.lm_loss(unflatten_tree(paths, leaves), cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _batch(vocab, seed=0, b=2, s=24):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_grads_match_reference(arch):
    rc, pc, rp, tp = _model(arch)
    toks, labels = _batch(rc.vocab)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks).long(), "labels": _t(labels).long()}
    want, _ = RT.forward(rp, rc, rb)
    got, aux = TT.forward(tp, pc, tb)
    assert _maxdiff(got, want) <= 1e-5 and float(aux) == 0.0
    (rl, _), rg = jax.value_and_grad(lambda p: RT.lm_loss(p, rc, rb),
                                     has_aux=True)(rp)
    tl, tg = _grads(tp, pc, tb)
    assert abs(float(tl) - float(rl)) <= 1e-5
    for a, g in zip(jax.tree.leaves(rg), tg):
        a = np.asarray(a)
        assert np.abs(g.numpy() - a).max() <= 1e-5 * np.abs(a).max() + 1e-12


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_for_bit(arch, monkeypatch):
    """``cfg.remat``: every layer (the shared block with its layer)
    checkpointed in the backward, loss and gradients bit for bit the run
    without it; prefill and decode checkpoint nothing."""
    pc = port_get(arch).smoke
    tp = TL.init_params(TT.model_template(pc), 0)
    toks, labels = _batch(pc.vocab, seed=2)
    tb = {"tokens": _t(toks).long(), "labels": _t(labels).long()}
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
    TT.decode(tp, rcfg, tb["tokens"][:, 8:9], cache, 8)
    assert len(calls) == pc.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistent_with_forward(arch):
    """The reference's ``test_smoke_decode_consistency`` on the port: a
    prefill of 16 tokens, one decode at position 16, against the full
    forward at a chunk of the whole 17 tokens, in both packages."""
    rc, pc, rp, tp = _model(arch, seed=0)
    toks = np.random.default_rng(5).integers(0, rc.vocab, (2, 17)).astype(
        np.int32)
    cache = TT.init_cache(pc, 2, 32, torch.float32)
    TT.prefill(tp, pc, {"tokens": _t(toks[:, :16]).long()}, cache)
    lg, cache = TT.decode(tp, pc, _t(toks[:, 16:]).long(), cache, 16)
    full, _ = TT.forward(tp, dataclasses.replace(pc, ssm_chunk=17),
                         {"tokens": _t(toks).long()})
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 16].numpy(),
                               rtol=2e-3, atol=2e-3)
    rfull, _ = RT.forward(rp, dataclasses.replace(rc, ssm_chunk=17),
                          {"tokens": jnp.asarray(toks)})
    assert _maxdiff(full, rfull) <= 1e-5


# --------------------------------------------------------------------- #
# the audit, the CLI
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_trainer_audits_clean(arch):
    """A sim trainer of 4 workers under the audit's schedule: clean, with
    no allowance but the one every trainer has (the step's loss, a
    metric scalar): the family adds no collective; every round seen, the
    recorded bytes a round ``comm_accounting``'s."""
    from repro_torch.launch import audit as LA

    opt = TLAUNCH.build_opt_cfg(TLAUNCH.parse_args(
        ["--arch", arch, *LA.SCHEDULE]))
    tr = TSTEP.Trainer(port_get(arch).smoke, opt, comm=SimComm(4),
                       device="cpu")
    cfg = tr.model_cfg
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4, seed=0), device="cpu")
    rep = IA.audit_trainer(tr, *tr.init(0),
                           [data.batch(t) for t in range(LA.STEPS)])
    assert rep.ok, rep.violations[:3]
    s = rep.summary
    assert s["allowed"] == {"control/metric scalar": LA.STEPS}
    assert set(s["rounds"]) == {"sync+fullprec", "sync", "local-only"}
    acct = s["accounting"]
    for name, key in (("sync", "compressed_bytes_per_sync"),
                      ("fullprec", "fullprec_bytes_per_round")):
        got = s["recorded_bytes"][name]
        assert (got["inner"], got["outer"]) == (acct[f"{key}_inner"],
                                                acct[f"{key}_outer"])


@pytest.mark.parametrize("mode", ["single", "sim"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_ssm_configs(arch, mode, capsys):
    argv = ["--arch", arch, "--smoke", "--mode", mode, "--steps", "2",
            "--batch", "8", "--seq", "16", "--log-every", "1",
            "--device", "cpu"] + (["--workers", "4"] if mode == "sim"
                                  else [])
    TLAUNCH.main(argv)
    out = capsys.readouterr().out
    name = port_get(arch).smoke.name
    assert f"arch={name}" in out and "DONE: 2 steps" in out
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert abs(losses[0] - np.log(512)) < 0.5
    tr = TLAUNCH.make_trainer(TLAUNCH.parse_args(
        ["--arch", arch, "--layers", "2", "--mode", "sim", "--workers", "2",
         "--device", "cpu"]))
    assert tr.model_cfg == dataclasses.replace(port_get(arch).config,
                                               n_layers=2)
