"""The port's dense rotary family on the serving side, against the
reference live in one process: the sliding mask, sliding
``blockwise_attn``, sliding and ring ``decode_attn`` (one position, and
one per row as the reference's vmapped decode), prefill and decode caches
and logits, gemma3's split window cache (ring decode against the full
cache, the reference's own test on the port), the ``Scheduler``'s tokens
and ``stats`` with and without paged qint8 KV, and the serve CLI on every
family config. Params from the reference's init through
``repro_torch.interop``, inputs from numpy seeds.

Tolerances, with their reasons:
* masks, cache shapes, scheduler tokens and ``stats``: equal;
* ``blockwise_attn`` and ``decode_attn``: 1e-6 (measured <= 5e-7: f32
  products and softmax sums in another order);
* prefill and decode logits and caches: 1e-5 (measured <= 5.1e-7);
* the ring cache against the full cache (either package's): 2e-4, the
  reference's own bar for its ring test (the two sum the same keys in
  another slot order; measured <= 5.1e-7).

The reference's ``prefill`` cannot fill the split window cache (its layer
scan refuses stacks of unequal length, a ``ValueError``), so neither can
its Scheduler serve one; the port's prefill fills the rings, and its
window-cache Scheduler is held to the reference's full-cache one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import Server as RefServer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.launch import serve as TLAUNCH
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, Scheduler, Server
from repro_torch.serve.scheduler import cache_leaves

torch.set_num_threads(1)

ARCHS = ["granite-3-8b", "phi4-mini-3.8b", "chatglm3-6b", "gemma3-12b"]
_MODELS = {}


def _model(arch, seed=0):
    """(reference cfg, port cfg, reference params, port params) of the
    smoke config, cached per (arch, seed)."""
    if (arch, seed) not in _MODELS:
        rc, pc = ref_get(arch).smoke, port_get(arch).smoke
        rp = ref_init(RT.model_template(rc), jax.random.PRNGKey(seed))
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


# --------------------------------------------------------------------- #
# masks and attention
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kind,window", [("sliding", 1), ("sliding", 5),
                                         ("sliding", 0), ("causal", 5),
                                         ("bidir", 5)])
def test_mask_bias_matches_reference(kind, window):
    """Queries against keys with padding sentinels among them (key
    positions >= 2**29), the sliding window's edges included."""
    rng = np.random.default_rng(window)
    q = rng.integers(0, 24, 13).astype(np.int32)
    k = np.concatenate([np.arange(20), [2 ** 29, 2 ** 29 + 3]]).astype(
        np.int32)
    want = np.asarray(RA._mask_bias(jnp.asarray(q), jnp.asarray(k), kind,
                                    window))
    got = TA._mask_bias(_t(q), _t(k), kind, window).numpy()
    assert np.array_equal(got, want)
    if kind == "sliding" and window:
        rel = q[:, None] - k[None, :]
        assert np.array_equal(got == 0, (rel >= 0) & (rel < window)
                              & (k < 2 ** 29)[None, :])


@pytest.mark.parametrize("window", [3, 8, 40])
@pytest.mark.parametrize("sq,sk,bq,bk", [(37, 37, 8, 16), (29, 13, 8, 4)])
def test_blockwise_sliding_matches_reference(sq, sk, bq, bk, window):
    """Sliding ``blockwise_attn`` on ragged lengths, GQA 2:1; a window
    shorter than a KV block leaves whole blocks masked for some rows."""
    rng = np.random.default_rng(sq + window)
    B, H, K, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, sk, K, hd)).astype(np.float32)
    qpos = np.arange(sq, dtype=np.int32) + max(sk - sq, 0)
    kpos = np.arange(sk, dtype=np.int32)
    want = jax.jit(lambda *a: RA.blockwise_attn(
        *a, "sliding", window, bq=bq, bk=bk))(q, k, v, qpos, kpos)
    got = TA.blockwise_attn(*(_t(a) for a in (q, k, v, qpos, kpos)),
                            "sliding", window, bq=bq, bk=bk)
    assert _maxdiff(got, want) <= 1e-6


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("kind,window,ring", [
    ("sliding", 6, False), ("sliding", 8, True), ("causal", 0, False)])
def test_decode_attn_matches_reference(kind, window, ring, per_row):
    """One query a row against a cache of 8 slots at positions before,
    at and past the window (ring: a slot is valid once written); per row,
    against the reference one row at a time (its scheduler's vmap)."""
    rng = np.random.default_rng(11)
    B, S, H, K, hd = 4, 8, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    rows = [[2, 7, 9, 20], [0, 8, 15, 3]]
    for pos in (rows if per_row else [3, 7, 13]):
        if per_row:
            want = np.concatenate([np.asarray(RA.decode_attn(
                q[b:b + 1], kc[b:b + 1], vc[b:b + 1], jnp.int32(p), kind,
                window, ring=ring)) for b, p in enumerate(pos)])
            got = TA.decode_attn(_t(q), _t(kc), _t(vc),
                                 torch.tensor(pos), kind, window, ring)
        else:
            want = RA.decode_attn(q, kc, vc, jnp.int32(pos), kind, window,
                                  ring=ring)
            got = TA.decode_attn(_t(q), _t(kc), _t(vc), pos, kind, window,
                                 ring)
        assert _maxdiff(got, want) <= 1e-6, pos


# --------------------------------------------------------------------- #
# caches, prefill, decode
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("window_cache", [False, True])
@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma3-12b"])
def test_init_cache_matches_reference(arch, window_cache):
    rc, pc = (dataclasses.replace(c, window_cache=window_cache) for c in
              (ref_get(arch).smoke, port_get(arch).smoke))
    want = RT.init_cache(rc, 3, 40, jnp.bfloat16)
    got = TT.init_cache(pc, 3, 40, torch.bfloat16)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, got))
    for a, b in zip(jax.tree.leaves(want), cache_leaves(got)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.bfloat16
        assert not b.any()
    if window_cache and arch == "gemma3-12b":
        assert got["local"]["k"].shape[2] == pc.sliding_window
        assert got["global"]["k"].shape[0] == pc.n_global_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 13 tokens (past gemma3-smoke's window of 8), then 6 decode
    steps, against the reference's jitted ``prefill``/``decode``; f32
    caches."""
    rc, pc, rp, tp = _model(arch)
    B, P, STEPS, S = 2, 13, 6, 32
    toks = np.random.default_rng(1).integers(0, rc.vocab, (B, P + STEPS))
    toks = toks.astype(np.int32)
    rcache = RT.init_cache(rc, B, S, jnp.float32)
    tcache = TT.init_cache(pc, B, S, torch.float32)
    rl, rcache = jax.jit(lambda p, b, c: RT.prefill(p, rc, b, c))(
        rp, {"tokens": toks[:, :P]}, rcache)
    tl, tcache = TT.prefill(tp, pc, {"tokens": _t(toks[:, :P]).long()},
                            tcache)
    assert _maxdiff(tl, rl) <= 1e-5
    step = jax.jit(lambda p, t, c, pos: RT.decode(p, rc, t, c, pos))
    for i in range(STEPS):
        t = toks[:, P + i:P + i + 1]
        rl, rcache = step(rp, t, rcache, jnp.int32(P + i))
        tl, tcache = TT.decode(tp, pc, _t(t).long(), tcache, P + i)
        assert _maxdiff(tl, rl) <= 1e-5, i
    for k in ("k", "v"):
        assert _maxdiff(tcache[k], rcache[k]) <= 1e-5


def test_window_cache_ring_decode_equals_full_cache():
    """The reference's ``test_window_cache_ring_decode_equals_full_cache``
    on the port (24 decode steps from position 0, > 2x the window of 8):
    the ring cache's logits within 2e-4 of the full cache's, in the port
    and against the reference's full cache."""
    rc, pc, rp, tp = _model("gemma3-12b")
    wcfg = dataclasses.replace(pc, window_cache=True)
    B, STEPS = 2, 24
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5),
                                         (B, STEPS), 0, rc.vocab))
    ref_full = RT.init_cache(rc, B, 32, dtype=jnp.float32)
    full = TT.init_cache(pc, B, 32, torch.float32)
    ring = TT.init_cache(wcfg, B, 32, torch.float32)
    assert ring["local"]["k"].shape[2] == pc.sliding_window
    assert ring["global"]["k"].shape[0] == pc.n_global_layers
    step = jax.jit(lambda p, t, c, pos: RT.decode(p, rc, t, c, pos))
    for i in range(STEPS):
        t = toks[:, i:i + 1]
        rf, ref_full = step(rp, t, ref_full, jnp.int32(i))
        lf, full = TT.decode(tp, pc, _t(t).long(), full, i)
        lr_, ring = TT.decode(tp, wcfg, _t(t).long(), ring, i)
        np.testing.assert_allclose(lr_.numpy(), lf.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(lr_.numpy(), np.asarray(rf), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("prompt", [5, 8, 13, 21])
def test_window_cache_prefill_then_decode_equals_full_cache(prompt):
    """The port's prefill into the split cache (the last ``window``
    positions into the rings, the prompt into the global stack), then
    decode past it, per row at different positions: logits within 2e-4
    of the full cache's. The reference's prefill refuses the split
    cache."""
    rc, pc, rp, tp = _model("gemma3-12b")
    wcfg = dataclasses.replace(pc, window_cache=True)
    with pytest.raises(ValueError, match="leading axis"):
        RT.prefill(rp, dataclasses.replace(rc, window_cache=True),
                   {"tokens": jnp.zeros((1, prompt), jnp.int32)},
                   RT.init_cache(dataclasses.replace(rc, window_cache=True),
                                 1, 40, jnp.float32))
    B = 2
    toks = _t(np.random.default_rng(prompt).integers(
        0, rc.vocab, (B, prompt + 12))).long()
    caches = [TT.init_cache(c, B, 40, torch.float32) for c in (pc, wcfg)]
    outs = [TT.prefill(tp, c, {"tokens": toks[:, :prompt]}, cache)[0]
            for c, cache in zip((pc, wcfg), caches)]
    assert _maxdiff(outs[1], outs[0]) <= 2e-4
    pos = torch.tensor([prompt, prompt])
    for i in range(12):
        a, _ = TT.decode(tp, pc, toks[:, prompt + i:prompt + i + 1],
                         caches[0], pos + i)
        b, _ = TT.decode(tp, wcfg, toks[:, prompt + i:prompt + i + 1],
                         caches[1], pos + i)
        assert _maxdiff(b, a) <= 2e-4, i


# --------------------------------------------------------------------- #
# the scheduler and the CLI
# --------------------------------------------------------------------- #

def _prompts(vocab, seed, n, base_prompt=5, base_gen=3):
    """Prompts of 5, 7, 9, ... tokens (past gemma3-smoke's window from the
    third) and budgets of 3, 4, 5, ..."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, base_prompt + 2 * i).tolist(),
             base_gen + i) for i in range(n)]


def _serve(arch, pkg, mix, kv_quant=None, window_cache=False):
    rc, pc, rp, tp = _model(arch)
    kw = {"kv_quant": kv_quant, "kv_page": 8} if kv_quant else {}
    if pkg == "ref":
        sch = RefScheduler(RefServer(rc, batch=3, max_seq=64,
                                     cache_dtype=jnp.float32), rp, **kw)
        reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(mix)]
    else:
        cfg = dataclasses.replace(pc, window_cache=window_cache)
        sch = Scheduler(Server(cfg, batch=3, max_seq=64,
                               cache_dtype=torch.float32, device="cpu"),
                        tp, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(mix)]
    sch.run(reqs)
    return [r.output for r in reqs], dict(sch.stats)


@pytest.mark.parametrize("kv_quant", [None, "qint8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_matches_reference(arch, kv_quant):
    """Five staggered requests over 3 slots (slot reuse), with and without
    the paged qint8 KV cache at pages of 8: tokens and every stat equal
    the reference's Scheduler's."""
    mix = _prompts(512, 7, 5)
    (rt, rs), (tt, ts) = (_serve(arch, pkg, mix, kv_quant)
                          for pkg in ("ref", "port"))
    assert tt == rt and ts == rs
    if kv_quant:
        assert ts["pages_quantized"] > 0


@pytest.mark.parametrize("kv_quant", [None, "qint8"])
def test_window_cache_scheduler_matches_reference_full_cache(kv_quant):
    """gemma3-smoke served from the split window cache: tokens and stats
    equal the reference's full-cache Scheduler (pages quantized in the
    global stack only: the rings are not seq-indexed)."""
    mix = _prompts(512, 9, 5)
    (rt, rs), (tt, ts) = (_serve("gemma3-12b", "ref", mix, kv_quant),
                          _serve("gemma3-12b", "port", mix, kv_quant,
                                 window_cache=True))
    assert tt == rt and ts == rs


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_each_family_config_on_cpu(arch, capsys):
    """``launch.serve --arch <name>`` with no new flag; gemma3-smoke's
    prompts of 12 run past its window of 8."""
    TLAUNCH.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--gen", "5",
                  "--kv-quant", "qint8", "--kv-page", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["req 0", "req 1",
                                                      "req 2"]
    assert all("5 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("# 3 requests over 2 slots: 15 tokens in ")
