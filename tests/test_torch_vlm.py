"""The port's vlm (qwen2-vl-2b: M-RoPE and the vision prefix) against the
reference live, in one process: the config, template and comm layouts at
SMOKE and FULL (FULL as metadata only), ``mrope_positions`` at int and
per-row offsets, ``apply_rope`` with sections, ``forward`` and
``lm_loss`` gradients with and without ``vision_embeds`` and through
``blockwise_attn``, the prefix's two-way mask, ``prefill`` then
``decode`` against the reference and against the full forward, a decode
at per-row positions, the ``Scheduler``'s tokens and the serve CLI.
Params from the reference's init through ``repro_torch.interop``, inputs
from numpy seeds. The metadata checks here also run for whisper
(``tests/test_torch_encdec.py``).

Tolerances, with their reasons:
* configs, templates (paths, shapes, init, scale, spec, DP membership),
  layouts, ``comm_accounting``, the frame pre-check, positions, the
  scheduler's tokens and ``stats``: equal;
* ``apply_rope``: 1e-6 (``cos``/``sin`` of f32 angles in another
  library; measured <= 4.8e-7);
* ``forward`` logits and the loss: 1e-5 (f32 matmuls in another order;
  measured <= 5e-7); each gradient leaf within 1e-5 of its own largest
  magnitude plus 1e-10 (an unrotated key bias, as the encoder's in
  whisper, has a gradient that is zero in exact arithmetic: both
  packages give noise near 1e-12);
* prefill and decode logits and caches against the reference: 1e-5;
  decode logits against the port's own full forward at the same
  positions, and a per-row decode against lone decodes: 1e-5 (the same
  arithmetic in other shapes).
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
from repro.models import rope as RR
from repro.models import transformer as RT
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import Server as RefServer
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import leafwise as TLW
from repro_torch.core.comm import SimComm
from repro_torch.core.compressed import comm_accounting
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.kernels import dispatch as KD
from repro_torch.launch import serve as TLAUNCH
from repro_torch.models import layers as TL
from repro_torch.models import rope as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, Scheduler, Server
from repro_torch.train import step as TSTEP

torch.set_num_threads(1)

ARCH = "qwen2-vl-2b"
_MODELS = {}


# --------------------------------------------------------------------- #
# shared with tests/test_torch_encdec.py
# --------------------------------------------------------------------- #

def cfgs(arch, which="smoke", **change):
    attr = "smoke" if which == "smoke" else "config"
    return tuple(dataclasses.replace(getattr(get(arch), attr), **change)
                 for get in (ref_get, port_get))


def model(arch, seed=0, **change):
    """(reference cfg, port cfg, reference params, port params) of the
    smoke config (with ``change``), cached."""
    key = (arch, seed, tuple(sorted(change.items())))
    if key not in _MODELS:
        rc, pc = cfgs(arch, **change)
        rp = RL.init_params(RT.model_template(rc), jax.random.PRNGKey(seed))
        _MODELS[key] = (rc, pc, rp, interop.params_from_reference(
            jax.device_get(rp)))
    return _MODELS[key]


def np_(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def maxdiff(a, b):
    return float(np.abs(np_(a).astype(np.float64) - np_(b)).max())


def batches(cfg, seed=0, b=2, s=24, vision=True):
    """The same batch for both packages: tokens and next-token labels,
    and (seeded normal at 0.02) whisper's ``frames`` or, with
    ``vision``, qwen2-vl's ``vision_embeds``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_layers:
        out["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model))).astype(np.float32)
    if cfg.vision_tokens and vision:
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    ref = {k: jnp.asarray(v) for k, v in out.items()}
    port = {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in out.items()}
    return ref, port


def grads(params, cfg, batch):
    """The port's loss and every leaf's gradient (zeros where the loss
    does not reach a leaf, as ``jax.grad`` gives)."""
    paths, leaves = flatten_tree(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss, _ = TT.lm_loss(unflatten_tree(paths, leaves), cfg, batch)
    return paths, loss.detach(), torch.autograd.grad(
        loss, leaves, materialize_grads=True)


def check_forward_and_grads(arch, change, vision=True):
    """Logits, loss and every gradient against the reference's (the
    module docstring's bars); returns {leaf path: (port, reference)}
    gradients."""
    rc, pc, rp, tp = model(arch, **change)
    rb, tb = batches(rc, vision=vision)
    want, _ = jax.jit(lambda p, b: RT.forward(p, rc, b))(rp, rb)
    got, _ = TT.forward(tp, pc, tb)
    assert maxdiff(got, want) <= 1e-5
    (rl, _), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rc, b), has_aux=True))(rp, rb)
    paths, tl, tg = grads(tp, pc, tb)
    assert abs(float(tl) - float(rl)) <= 1e-5
    out = {}
    for path, a, g in zip(paths, jax.tree.leaves(rg), tg):
        a = np.asarray(a)
        assert np.abs(g.numpy() - a).max() <= (
            1e-5 * np.abs(a).max() + 1e-10), path
        out["/".join(path)] = (g, a)
    return out


def _ref_leaves(tmpl):
    flat, _ = jax.tree_util.tree_flatten_with_path(tmpl, is_leaf=RL.is_pd)
    return [(tuple(str(k.key) for k in path), pd) for path, pd in flat]


def _port_leaves(tmpl):
    out = []
    TL._map(tmpl, lambda path, pd: out.append((path, pd)))
    return sorted(out, key=lambda x: x[0])


def check_config(arch, which):
    rc, pc = cfgs(arch, which)
    for f in dataclasses.fields(pc):
        if f.name not in ("param_dtype", "compute_dtype"):
            assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    assert (pc.hd, pc.padded_vocab) == (rc.hd, rc.padded_vocab)
    assert {f.name for f in dataclasses.fields(pc)} == {
        f.name for f in dataclasses.fields(rc)}


def check_template(arch, which, full_total, full_leaves):
    """Leaf for leaf: paths, shapes, init kinds and scales,
    tensor-parallel specs and DP membership (FULL as templates only)."""
    rc, pc = cfgs(arch, which)
    ref, port = (_ref_leaves(RT.model_template(rc)),
                 _port_leaves(TT.model_template(pc)))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, port):
        assert tuple(b.shape) == tuple(a.shape), path
        assert (b.init, b.scale, b.dp) == (a.init, a.scale, a.dp), path
        assert b.spec == (None if a.spec is None else tuple(a.spec)), path
    if which == "full":
        # counted with the reference's templates
        assert sum(int(np.prod(pd.shape)) for _, pd in port) == full_total
        assert len(port) == full_leaves
    return port


def check_layouts(arch, which, n):
    rc, pc = cfgs(arch, which)
    rt, tt = RT.model_template(rc), TT.model_template(pc)
    ref = RLW.make_plan(RL.abstract_params(rt), RL.param_specs(rt), None, n)
    port = TLW.make_plan(TL.param_shapes(tt), TL.param_specs(tt),
                         TL.dp_mask(tt), n)
    assert len(port.layouts) == len(ref.layouts)
    for a, b in zip(ref.layouts, port.layouts):
        assert dataclasses.astuple(b) == dataclasses.astuple(a)
    return {"/".join(p): lo.view_shape
            for p, lo in zip(port.paths, port.layouts)}


def check_accounting(arch, which):
    rc, pc = cfgs(arch, which)
    want = ref_accounting(RefTrainer(
        rc, RefOptimizerConfig(name="zero_one_adam"), n_workers=4).opt)
    got = comm_accounting(TSTEP.Trainer(
        pc, TA.OptimizerConfig(name="zero_one_adam"), comm=SimComm(4),
        device="cpu").opt)
    for k, v in got.items():
        assert k in want and want[k] == v, (k, v, want.get(k))


def check_precheck(arch, n):
    """Every unit of the FULL config at full depth, ``n`` workers stacked
    in one launch, within the CUDA kernels' launch contract."""
    tt = TT.model_template(port_get(arch).config)
    plan = TLW.make_plan(TL.param_shapes(tt), TL.param_specs(tt),
                         TL.dp_mask(tt), n)
    for path, lo in zip(plan.paths, plan.layouts):
        assert KD.frame_precheck(lo, stack=n) == [], path


# --------------------------------------------------------------------- #
# config, template, layouts
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_matches_reference(which):
    check_config(ARCH, which)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_template_matches_reference(which):
    port = check_template(ARCH, which, 1_777_481_216, 15)
    shapes = {"/".join(p): tuple(pd.shape) for p, pd in port}
    if which == "full":
        assert shapes["embed"] == (152064, 1536)
        assert shapes["blocks/mlp/w_gate"] == (28, 1536, 8960)
        assert shapes["blocks/attn/bk"] == (28, 256)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_layouts_match_reference(which, n):
    check_layouts(ARCH, which, n)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_comm_accounting_matches_reference(which):
    check_accounting(ARCH, which)


@pytest.mark.parametrize("n", [2, 4])
def test_frame_precheck_passes_on_every_full_unit(n):
    check_precheck(ARCH, n)


# --------------------------------------------------------------------- #
# M-RoPE
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("batch,seq,n_vision,grid,offset", [
    (2, 14, 8, 4, 0),          # the smoke config's prefix and text
    (2, 5, 8, 4, 6),           # a window across the prefix's end
    (1, 1, 8, 4, 11),          # a decode step: (5, 5, 5)
    (3, 1200, 1024, 32, 0),    # the FULL config's 1024-token prefix
    (1, 6, 7, 3, 0),           # a grid the prefix does not fill
    (1, 4, 5, 0, 2),           # grid 0
    (2, 9, 0, 32, 3)])         # no prefix: plain text positions
def test_mrope_positions_match_reference(batch, seq, n_vision, grid, offset):
    want = np.asarray(RR.mrope_positions(batch, seq, n_vision, grid, offset))
    got = TR.mrope_positions(batch, seq, n_vision, grid, offset)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    if (seq, n_vision, offset) == (1, 8, 11):
        assert got[:, 0, 0].tolist() == [5, 5, 5]


def test_mrope_positions_per_row_offsets_match_reference():
    """One offset per row (the Scheduler's slots): each row the
    reference's positions at its own offset (it ``vmap``s decode)."""
    offsets = np.array([0, 3, 7, 8, 11, 40], np.int32)
    want = jax.vmap(lambda o: RR.mrope_positions(1, 2, 8, 4, o))(
        jnp.asarray(offsets))                       # (B, 3, 1, 2)
    want = np.moveaxis(np.asarray(want)[:, :, 0], 0, 1)
    got = TR.mrope_positions(6, 2, 8, 4, torch.from_numpy(offsets))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_rope_with_sections_matches_reference(hd, sections):
    """Independent random streams, so every band reads its own stream;
    and (3, B, S) positions without sections rotate by stream 0."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 12)).astype(np.int32)
    for sec in (sections, None):
        want = RR.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, 1.0, sec)
        got = TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                            1.0, sec)
        assert maxdiff(got, want) <= 1e-6
    same = TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]))
    assert torch.equal(same, TR.apply_rope(torch.from_numpy(x),
                                           torch.from_numpy(pos)))
    with pytest.raises(ValueError, match="M-RoPE"):
        TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e4,
                      1.0, sections)


# --------------------------------------------------------------------- #
# forward, gradients, the prefix's mask
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("vision,change", [
    (True, {}), (False, {}), (True, {"blockwise_threshold": 16})],
    ids=["vision", "text-only", "vision-blockwise"])
def test_forward_and_grads_match_reference(vision, change):
    """At S = 24 (the 8-token prefix and 16 text tokens); with the
    threshold lowered to 16 in both packages, M-RoPE's attention goes
    through ``blockwise_attn``, its mask on the temporal stream."""
    check_forward_and_grads(ARCH, change, vision)


def test_embed_gets_no_gradient_through_the_prefix():
    """The vision embeddings replace the prefix's token embeddings, so a
    token that occurs only in the prefix gets an embedding gradient of
    exactly zero, in both packages."""
    rc, pc, rp, tp = model(ARCH)
    rb, tb = batches(rc, seed=4)
    rest = tb["tokens"][:, rc.vision_tokens:]
    free = next(t for t in range(rc.vocab) if not (rest == t).any()
                and not (tb["labels"] == t).any())
    tb["tokens"][:, :rc.vision_tokens] = free
    rb["tokens"] = jnp.asarray(tb["tokens"].numpy().astype(np.int32))
    rg = jax.jit(jax.grad(lambda p, b: RT.lm_loss(p, rc, b)[0]))(
        rp, rb)["embed"]
    paths, _, tg = grads(tp, pc, tb)
    g = tg[paths.index(("embed",))]
    assert float(np.abs(np.asarray(rg)[free]).max()) == 0.0
    assert float(g[free].abs().max()) == 0.0
    assert float(g.abs().max()) > 0.0


def test_zero_vision_prefix_overflows_the_gradient_at_full_depth():
    """The CLIs' zero vision embeddings keep the prefix rows exactly zero
    through every layer, and each RMSNorm passes their gradient on times
    ``rsqrt(eps)`` = 1000: at qwen2-vl's 28 layers (smoke widths here)
    the gradient overflows to NaN in the reference and in the port
    alike. Seeded embeddings keep it finite in both, as chip_smoke.py's
    12a feeds them."""
    rc, pc, rp, tp = model(ARCH, n_layers=28)
    ref_grad = jax.jit(jax.grad(lambda p, b: RT.lm_loss(p, rc, b)[0]))
    for zero in (True, False):
        rb, tb = batches(rc, seed=9)
        if zero:
            tb["vision_embeds"].zero_()
            rb["vision_embeds"] = jnp.zeros_like(rb["vision_embeds"])
        rg = ref_grad(rp, rb)
        _, _, tg = grads(tp, pc, tb)
        ref_ok = all(bool(np.isfinite(np.asarray(a)).all())
                     for a in jax.tree.leaves(rg))
        port_ok = all(bool(torch.isfinite(g).all()) for g in tg)
        assert ref_ok == port_ok == (not zero)


@pytest.mark.parametrize("vision", [False, True], ids=["tokens", "vision"])
def test_prefix_attends_both_ways(vision):
    """Every prefix position sits at temporal position 0, so changing
    prefix position 5 (its token, or its vision embedding) moves the
    logits at position 0: by the same amount in both packages."""
    rc, pc, rp, tp = model(ARCH)
    rb, tb = batches(rc, seed=5, b=1, s=16, vision=vision)
    rb2, tb2 = dict(rb), dict(tb)
    if vision:
        ve = tb["vision_embeds"].clone()
        ve[0, 5] += 0.5
        tb2["vision_embeds"], rb2["vision_embeds"] = ve, jnp.asarray(
            ve.numpy())
    else:
        toks = tb["tokens"].clone()
        toks[0, 5] = (toks[0, 5] + 1) % rc.vocab
        tb2["tokens"] = toks
        rb2["tokens"] = jnp.asarray(toks.numpy().astype(np.int32))
    moved = {}
    ref_fwd = jax.jit(lambda p, b: RT.forward(p, rc, b)[0])
    moved["ref"] = np_(ref_fwd(rp, rb2)) - np_(ref_fwd(rp, rb))
    moved["port"] = np_(TT.forward(tp, pc, tb2)[0]) - np_(
        TT.forward(tp, pc, tb)[0])
    assert np.abs(moved["port"][0, 0]).max() > 0.05
    assert np.abs(moved["port"] - moved["ref"]).max() <= 1e-5


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("vision", [True, False], ids=["vision", "tokens"])
def test_prefill_then_decode_match_reference_and_forward(vision):
    """Prefill 11 tokens (the 8-token prefix first), then 4 decode steps
    at slots 11-14 (M-RoPE text positions 5-8): logits and caches against
    the reference's jitted ``prefill``/``decode``, and each decode's
    logits against the port's full forward over the 15 tokens."""
    rc, pc, rp, tp = model(ARCH)
    B, P, STEPS, S = 2, 11, 4, 32
    rb, tb = batches(rc, seed=6, b=B, s=P + STEPS, vision=vision)
    pre_r = {k: v[:, :P] if k == "tokens" else v for k, v in rb.items()
             if k != "labels"}
    pre_t = {k: v[:, :P] if k == "tokens" else v for k, v in tb.items()
             if k != "labels"}
    rcache = RT.init_cache(rc, B, S, jnp.float32)
    tcache = TT.init_cache(pc, B, S, torch.float32)
    rl, rcache = jax.jit(lambda p, b, c: RT.prefill(p, rc, b, c))(
        rp, pre_r, rcache)
    tl, tcache = TT.prefill(tp, pc, pre_t, tcache)
    assert maxdiff(tl, rl) <= 1e-5
    full, _ = TT.forward(tp, pc, tb)
    assert maxdiff(tl[:, 0], full[:, P - 1]) <= 1e-5
    step = jax.jit(lambda p, t, c, pos: RT.decode(p, rc, t, c, pos))
    for i in range(STEPS):
        t = tb["tokens"][:, P + i:P + i + 1]
        rl, rcache = step(rp, jnp.asarray(t.numpy().astype(np.int32)),
                          rcache, jnp.int32(P + i))
        tl, tcache = TT.decode(tp, pc, t, tcache, P + i)
        assert maxdiff(tl, rl) <= 1e-5, i
        assert maxdiff(tl[:, 0], full[:, P + i]) <= 1e-5, i
    for k in ("k", "v"):
        assert maxdiff(tcache[k], rcache[k]) <= 1e-5


def test_decode_with_per_row_positions():
    """One batched decode of 3 rows at slots 4, 9 and 12 (inside the
    prefix, just past it, further on) against each row decoded alone at
    its slot, from the same prefilled caches."""
    _, pc, _, tp = model(ARCH)
    rng = np.random.default_rng(8)
    lens = [4, 9, 12]
    caches, toks = [], torch.from_numpy(rng.integers(0, pc.vocab, (3, 1)))
    for n in lens:
        c = TT.init_cache(pc, 1, 32, torch.float32)
        TT.prefill(tp, pc, {"tokens": torch.from_numpy(
            rng.integers(0, pc.vocab, (1, n)))}, c)
        caches.append(c)
    batched = {k: torch.cat([c[k] for c in caches], dim=1)
               for k in ("k", "v")}
    got, _ = TT.decode(tp, pc, toks, batched, torch.tensor(lens))
    for r, (n, c) in enumerate(zip(lens, caches)):
        want, _ = TT.decode(tp, pc, toks[r:r + 1], c, n)
        assert maxdiff(got[r:r + 1], want) <= 1e-5, r


def _serve(pkg, mix, kv_quant=None):
    rc, pc, rp, tp = model(ARCH)
    kw = {"kv_quant": kv_quant, "kv_page": 8} if kv_quant else {}
    if pkg == "ref":
        sch = RefScheduler(RefServer(rc, batch=3, max_seq=64,
                                     cache_dtype=jnp.float32), rp, **kw)
        reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(mix)]
    else:
        sch = Scheduler(Server(pc, batch=3, max_seq=64,
                               cache_dtype=torch.float32, device="cpu"),
                        tp, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(mix)]
    sch.run(reqs)
    return [r.output for r in reqs], dict(sch.stats)


@pytest.mark.parametrize("kv_quant", [None, "qint8"])
def test_scheduler_matches_reference(kv_quant):
    """Five staggered requests of 5 and 13 tokens (inside the 8-token
    prefix, and past it) over 3 slots, tokens only: tokens and every stat
    equal the reference's Scheduler's."""
    rng = np.random.default_rng(7)
    mix = [(rng.integers(0, 512, (5, 13)[i % 2]).tolist(), 3 + i)
           for i in range(5)]
    (rt, rs), (tt, ts) = (_serve(pkg, mix, kv_quant)
                          for pkg in ("ref", "port"))
    assert tt == rt and ts == rs
    if kv_quant:
        assert ts["pages_quantized"] > 0


def test_cli_serves_qwen2vl(capsys):
    TLAUNCH.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--gen", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert all("5 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("# 3 requests over 2 slots: 15 tokens in ")
