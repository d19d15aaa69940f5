"""The port's serving path (``repro_torch.models`` cache entry points,
``blockwise_attn``, ``repro_torch.serve`` engine and scheduler, and
``repro_torch.launch.serve``) against the reference, live in one
process, at gpt2-smoke (bert-smoke for bidirectional attention), params
from the reference's init through ``repro_torch.interop``, inputs from
numpy seeds.

Tolerances, with their reasons:
* cache shapes and dtypes, scheduler tokens and ``stats``: equal;
* ``prefill`` and 4 ``decode`` steps: logits and caches within 1e-5 of
  the reference's (measured <= 5e-7: the two packages' f32 matrix
  products sum in different orders); with a bf16 cache the logits too,
  the cache within one bf16 ulp (a key ~5e-7 apart may round to the
  neighbouring bf16 value);
* the port's prefill -> decode against its own teacher-forced
  ``forward``: 2e-4, the reference's own bar for the same check;
* ``blockwise_attn`` within 1e-6 of the reference's (measured <= 4.2e-7),
  and ``forward``, ``lm_loss`` and its gradients with
  ``blockwise_threshold`` lowered, within 1e-5 (logits, gradients) and
  1e-6 (loss);
* per-row decode positions against one row at a time: 1e-6 (the same
  rows go through batched products);
* ``quant_page`` bit for bit the reference's jitted ``_quant_page``, on
  f32 and bf16 caches (its ``/ 127.0`` as XLA compiles it, a multiply by
  the f32 reciprocal).
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
from repro.serve import PublishConfig as RefPublishConfig
from repro.serve import Publisher as RefPublisher
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import Server as RefServer
from repro.serve import Subscriber as RefSubscriber

from repro_torch import interop
from repro_torch.checkpointing.io import leaf_paths
from repro_torch.configs.base import get as port_get
from repro_torch.launch import serve as TLAUNCH
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve import (Publisher, PublishConfig, Request, Scheduler,
                               Server, Subscriber)
from repro_torch.serve.scheduler import quant_page

# one intra-op thread: the inputs are small, and the suite runs several
# pytest-xdist workers per machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gpt2():
    """(reference cfg, port cfg, reference params, port params)."""
    rc, pc = ref_get("gpt2").smoke, port_get("gpt2").smoke
    rp = ref_init(RT.model_template(rc), jax.random.PRNGKey(0))
    return rc, pc, rp, interop.params_from_reference(jax.device_get(rp))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _maxdiff(a, b):
    return float(np.abs(_np(a).astype(np.float64) - _np(b)).max())


# --------------------------------------------------------------------- #
# caches and entry points
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["gpt2", "bert-base"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(arch, dtype):
    rc, pc = ref_get(arch).smoke, port_get(arch).smoke
    want = RT.init_cache(rc, 3, 48, getattr(jnp, dtype))
    got = TT.init_cache(pc, 3, 48, getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not got[k].any()


def _cache_close(got, want, dtype):
    """f32 caches within 1e-5; a bf16 cache within one bf16 ulp (2**-7
    relative: the f32 keys and values agree to ~5e-7, which can round to
    neighbouring bf16 values)."""
    g = got.to(torch.float32).numpy()
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        return np.abs(g - w).max() <= 1e-5
    return (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-6).all()


@pytest.mark.parametrize("arch", ["gpt2", "bert-base"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(gpt2, arch, dtype):
    """Prefill, then 4 decode steps, against the reference's jitted
    ``prefill``/``decode``, with an f32 cache and with the Server's
    default bf16 cache (the products then mix f32 queries with bf16 keys,
    which both packages take in f32); bert-smoke's bidirectional prefill
    and its decode, which masks keys after the position as the
    reference's does."""
    if arch == "gpt2":
        rc, pc, rp, tp = gpt2
    else:
        rc, pc = ref_get(arch).smoke, port_get(arch).smoke
        rp = ref_init(RT.model_template(rc), jax.random.PRNGKey(6))
        tp = interop.params_from_reference(jax.device_get(rp))
    B, P, STEPS, S = 2, 10, 4, 32
    toks = np.random.default_rng(1).integers(0, rc.vocab, (B, P + STEPS))
    toks = toks.astype(np.int32)
    rcache = RT.init_cache(rc, B, S, getattr(jnp, dtype))
    tcache = TT.init_cache(pc, B, S, getattr(torch, dtype))
    rl, rcache = jax.jit(lambda p, b, c: RT.prefill(p, rc, b, c))(
        rp, {"tokens": toks[:, :P]}, rcache)
    tl, tcache = TT.prefill(tp, pc, {"tokens": torch.from_numpy(
        toks[:, :P]).long()}, tcache)
    assert tuple(tl.shape) == rl.shape == (B, 1, rc.padded_vocab)
    assert _maxdiff(tl, rl) <= 1e-5
    for k in ("k", "v"):
        assert tcache[k].dtype == getattr(torch, dtype)
        assert _cache_close(tcache[k], rcache[k], dtype)
    step = jax.jit(lambda p, t, c, pos: RT.decode(p, rc, t, c, pos))
    for i in range(STEPS):
        t = toks[:, P + i:P + i + 1]
        rl, rcache = step(rp, t, rcache, jnp.int32(P + i))
        tl, tcache = TT.decode(tp, pc, torch.from_numpy(t).long(), tcache,
                               P + i)
        assert _maxdiff(tl, rl) <= 1e-5, i
        for k in ("k", "v"):
            assert _cache_close(tcache[k], rcache[k], dtype), (i, k)


def test_engine_prefill_decode_matches_forward(gpt2):
    """The reference's test on the port: prefill -> decode through the
    Server's callables equals the teacher-forced forward."""
    _, cfg, _, params = gpt2
    B, PROMPT, GEN = 2, 10, 4
    srv = Server(cfg, batch=B, max_seq=32, cache_dtype=torch.float32,
                 device="cpu")
    prefill, decode = srv.prefill_fn(), srv.decode_fn()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PROMPT + GEN)))
    cache = TT.init_cache(cfg, B, 32, dtype=torch.float32)
    lg, cache = prefill(params, {"tokens": toks[:, :PROMPT]}, cache)
    got = [lg[:, 0]]
    for i in range(GEN - 1):
        lg, cache = decode(params, cache, toks[:, PROMPT + i:PROMPT + i + 1],
                           PROMPT + i)
        got.append(lg[:, 0])
    with torch.no_grad():
        full, _ = TT.forward(params, cfg, {"tokens": toks})
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), full[:, PROMPT - 1 + i].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_decode_per_row_positions(gpt2):
    """A batched decode at per-row positions: each row as that row alone
    at its own position (cache and logits), the rows' lanes written only
    at their own positions."""
    _, cfg, _, params = gpt2
    rng = np.random.default_rng(2)
    lens = [5, 9, 12]
    cache = TT.init_cache(cfg, 3, 32, torch.float32)
    lone = []
    for b, n in enumerate(lens):
        lane = {k: c[:, b:b + 1] for k, c in cache.items()}
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n)))
        TT.prefill(params, cfg, {"tokens": prompt}, lane)
        lone.append({k: c.clone() for k, c in lane.items()})
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
    before = {k: c.clone() for k, c in cache.items()}
    got, cache = TT.decode(params, cfg, toks, cache, torch.tensor(lens))
    for b, n in enumerate(lens):
        want, lane = TT.decode(params, cfg, toks[b:b + 1], lone[b], n)
        assert _maxdiff(got[b:b + 1], want) <= 1e-6
        for k in ("k", "v"):
            assert _maxdiff(cache[k][:, b:b + 1], lane[k]) <= 1e-6
            changed = (cache[k][:, b] != before[k][:, b]).any(dim=(0, 2, 3))
            assert changed.nonzero().flatten().tolist() == [n]


def test_positions_past_the_table_raise(gpt2):
    """The reference's ``dynamic_slice`` clamps a position-table read past
    ``max_seq``; the port refuses the serve shapes that would need it."""
    _, cfg, _, params = gpt2
    with pytest.raises(ValueError, match="max_seq"):
        Server(cfg, max_seq=cfg.max_seq + 1, device="cpu")
    cache = TT.init_cache(cfg, 1, cfg.max_seq, torch.float32)
    with pytest.raises(ValueError, match="learned position table"):
        TT.decode(params, cfg, torch.zeros((1, 1), dtype=torch.long), cache,
                  cfg.max_seq)


# --------------------------------------------------------------------- #
# blockwise attention
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["causal", "bidir"])
@pytest.mark.parametrize("sq,sk,bq,bk", [(37, 37, 8, 16), (13, 29, 4, 8),
                                         (29, 13, 8, 4), (40, 40, 8, 8)])
def test_blockwise_attn_matches_reference(kind, sq, sk, bq, bk):
    """Ragged lengths (not multiples of the blocks), Sq != Sk, GQA with 2
    query heads per KV head; the key positions start where the queries'
    do, so some query rows see no key of a whole block."""
    rng = np.random.default_rng(sq * 100 + sk)
    B, H, K, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, sk, K, hd)).astype(np.float32)
    qpos = np.arange(sq, dtype=np.int32) + max(sk - sq, 0)
    kpos = np.arange(sk, dtype=np.int32)
    want = jax.jit(lambda *a: RA.blockwise_attn(*a, kind, bq=bq, bk=bk))(
        q, k, v, qpos, kpos)
    got = TA.blockwise_attn(*(torch.from_numpy(a) for a in
                              (q, k, v, qpos, kpos)), kind, bq=bq, bk=bk)
    assert tuple(got.shape) == want.shape
    assert _maxdiff(got, want) <= 1e-6


@pytest.mark.parametrize("arch", ["gpt2", "bert-base"])
def test_forward_blockwise_matches_reference(arch):
    """``forward``, ``lm_loss`` and its gradients at S = 40 with
    ``blockwise_threshold`` lowered to 16 in both packages (blocks of 512
    queries cover the whole sequence: one query block, one KV block); the
    port's blockwise forward also against its own ``dot_attn`` one."""
    rc = dataclasses.replace(ref_get(arch).smoke, blockwise_threshold=16)
    pc = dataclasses.replace(port_get(arch).smoke, blockwise_threshold=16)
    rp = ref_init(RT.model_template(rc), jax.random.PRNGKey(3))
    tp = interop.params_from_reference(jax.device_get(rp))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, rc.vocab, (2, 40)).astype(np.int32)
    labels = rng.integers(0, rc.vocab, (2, 40)).astype(np.int32)
    rb = {"tokens": toks, "labels": labels}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    rlog, _ = jax.jit(lambda p, b: RT.forward(p, rc, b))(rp, rb)
    tlog, _ = TT.forward(tp, pc, tb)
    assert _maxdiff(tlog, rlog) <= 1e-5
    dense = dataclasses.replace(pc, blockwise_threshold=10 ** 9)
    assert _maxdiff(tlog, TT.forward(tp, dense, tb)[0]) <= 1e-5
    (rloss, _), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rc, b), has_aux=True))(rp, rb)
    tp = jax.tree.map(lambda x: x.requires_grad_(True), tp)
    tloss, _ = TT.lm_loss(tp, pc, tb)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(rloss)) <= 1e-6
    for a, b in zip(jax.tree.leaves(rg), jax.tree.leaves(tp)):
        assert _maxdiff(b.grad, a) <= 1e-5


# --------------------------------------------------------------------- #
# the scheduler against the reference's
# --------------------------------------------------------------------- #

def _prompts(vocab, seed, n, base_prompt=5, base_gen=3):
    """The reference test's staggered mix, from a numpy seed: prompts of
    5, 7, 9, ... tokens and budgets of 3, 4, 5, ..."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, base_prompt + 2 * i).tolist(),
             base_gen + i) for i in range(n)]


def _run_both(gpt2, mix, slots, max_seq=64, dtype="float32", **kw):
    """The same requests through the reference's Scheduler and the
    port's, with caches of ``dtype``; returns (reference requests and
    stats, port's)."""
    rc, pc, rp, tp = gpt2
    out = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            sch = RefScheduler(RefServer(rc, batch=slots, max_seq=max_seq,
                                         cache_dtype=getattr(jnp, dtype)),
                               rp, **kw)
            reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=g)
                    for i, (p, g) in enumerate(mix)]
        else:
            sch = Scheduler(Server(pc, batch=slots, max_seq=max_seq,
                                   cache_dtype=getattr(torch, dtype),
                                   device="cpu"), tp, **kw)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=g)
                    for i, (p, g) in enumerate(mix)]
        sch.run(reqs)
        out.append((reqs, dict(sch.stats), sch))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_quant", [None, "qint8"])
def test_scheduler_matches_reference(gpt2, kv_quant, dtype):
    """Five staggered requests over 3 slots (slot reuse), and with the
    paged qint8 KV cache at pages of 8, with f32 and bf16 caches:
    per-request tokens and every stat equal the reference's scheduler on
    the same params."""
    kw = {"kv_quant": kv_quant, "kv_page": 8} if kv_quant else {}
    (rr, rs, _), (tr, ts, _) = _run_both(
        gpt2, _prompts(gpt2[0].vocab, 7, 5), slots=3, dtype=dtype, **kw)
    assert [r.output for r in tr] == [r.output for r in rr]
    assert all(r.done for r in tr)
    assert ts == rs
    if kv_quant:
        assert ts["pages_quantized"] > 0


def test_scheduler_matches_unbatched_decode(gpt2):
    """The reference's acceptance test on the port: each request's tokens
    equal the unbatched prefill/decode loop."""
    _, cfg, _, params = gpt2
    srv = Server(cfg, batch=3, max_seq=64, cache_dtype=torch.float32,
                 device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(_prompts(cfg.vocab, 7, 5))]
    Scheduler(srv, params).run(reqs)
    for r in reqs:
        cache = TT.init_cache(cfg, 1, 64, torch.float32)
        lg, cache = TT.prefill(params, cfg, {"tokens": torch.tensor(
            [r.prompt])}, cache)
        out = [int(lg[0, -1, :cfg.vocab].argmax())]
        for i in range(r.max_new_tokens - 1):
            lg, cache = TT.decode(params, cfg, torch.tensor([[out[-1]]]),
                                  cache, len(r.prompt) + i)
            out.append(int(lg[0, 0, :cfg.vocab].argmax()))
        assert r.done and r.output == out


def test_scheduler_slot_admit_evict_invariants(gpt2):
    _, cfg, _, params = gpt2
    srv = Server(cfg, batch=2, max_seq=64, cache_dtype=torch.float32,
                 device="cpu")
    sch = Scheduler(srv, params)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(_prompts(cfg.vocab, 3, 5,
                                                base_gen=2))]
    for r in reqs:
        sch.submit(r)
    seen_active = 0
    for _ in range(200):
        if sch.idle:
            break
        sch.tick()
        assert sch.active <= sch.n_slots
        seen_active = max(seen_active, sch.active)
        for r in reqs:
            assert len(r.output) <= r.max_new_tokens
            if r.done:                       # evicted on completion
                assert r not in sch.slots
        in_flight = ([r for r in sch.slots if r is not None]
                     + list(sch.queue))
        assert len(in_flight) + sum(r.done for r in reqs) == len(reqs)
    assert sch.idle
    assert seen_active == sch.n_slots        # batching actually happened
    assert all(r.done and len(r.output) == r.max_new_tokens
               for r in reqs)
    assert sch.stats["prefills"] == len(reqs)


def test_admit_leaves_no_residue(gpt2):
    """A slot's lane after a new tenant's prefill is the batch-1 prefill
    cache over the whole lane: zeros past the prompt, whatever the
    previous tenant wrote."""
    _, cfg, _, params = gpt2
    srv = Server(cfg, batch=1, max_seq=32, cache_dtype=torch.float32,
                 device="cpu")
    sch = Scheduler(srv, params)
    sch.run([Request(rid=0, prompt=list(range(3, 15)), max_new_tokens=6)])
    sch.submit(Request(rid=1, prompt=[7, 8, 9], max_new_tokens=4))
    sch._admit()
    want = TT.init_cache(cfg, 1, 32, torch.float32)
    TT.prefill(params, cfg, {"tokens": torch.tensor([[7, 8, 9]])}, want)
    for k in ("k", "v"):
        assert torch.equal(sch.cache[k], want[k])


REJECTS = {
    "oversized": (lambda S, R, sch: sch.submit(
        R(rid=0, prompt=list(range(12)), max_new_tokens=8)), "max_seq"),
    "kv_page_not_dividing": (lambda S, R, sch: S(
        sch.server, sch.params, kv_quant="qint8", kv_page=5), "kv_page"),
    "kv_page_zero": (lambda S, R, sch: S(
        sch.server, sch.params, kv_quant="qint8", kv_page=0), "kv_page"),
    "kv_quant": (lambda S, R, sch: S(sch.server, sch.params,
                                     kv_quant="qint4"), "kv_quant"),
    "empty_prompt": (lambda S, R, sch: R(rid=3, prompt=[]),
                     "empty prompt"),
    "no_budget": (lambda S, R, sch: R(rid=3, prompt=[1], max_new_tokens=0),
                  "max_new_tokens"),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_scheduler_rejects_as_reference(gpt2, case):
    """Each bad request or argument raises ``ValueError`` with the
    reference's text."""
    rc, pc, rp, tp = gpt2
    make, match = REJECTS[case]
    texts = []
    for S, R, sch in (
            (RefScheduler, RefRequest,
             RefScheduler(RefServer(rc, batch=1, max_seq=16), rp)),
            (Scheduler, Request,
             Scheduler(Server(pc, batch=1, max_seq=16, device="cpu"), tp))):
        with pytest.raises(ValueError, match=match) as e:
            make(S, R, sch)
        texts.append(str(e.value))
    assert texts[1] == texts[0]


def test_server_entry_points(gpt2):
    """The abstract trees match the reference's leaf for leaf; a mesh is
    refused, naming the queue item it waits for."""
    rc, pc, _, _ = gpt2
    rsrv = RefServer(rc, batch=2, max_seq=32)
    srv = Server(pc, batch=2, max_seq=32, device="cpu")
    ra, ta = rsrv.abstract_params(), srv.abstract_params()
    assert leaf_paths(ta) == [jax.tree_util.keystr(p) for p, _ in
                              jax.tree_util.tree_flatten_with_path(ra)[0]]
    for a, b in zip(jax.tree.leaves(ra), jax.tree.leaves(ta)):
        assert (tuple(b.shape), str(b.dtype)) == (a.shape,
                                                  f"torch.{a.dtype}")
    rcache, tcache = rsrv.abstract_cache(), srv.abstract_cache()
    for k in rcache:
        assert tuple(tcache[k].shape) == rcache[k].shape
        assert str(tcache[k].dtype) == f"torch.{rcache[k].dtype}"
    with pytest.raises(NotImplementedError, match="queue item 3"):
        Server(pc, mesh=object(), device="cpu")


def test_scheduler_weight_swap_transparent_and_counted(gpt2):
    """A mid-serve identity publish of the same params changes no token
    (the swap is at a tick boundary, the decoded tree bit for bit the
    served one) and is counted, as in the reference's scheduler."""
    rc, cfg, rp, params = gpt2
    mix = _prompts(cfg.vocab, 11, 3, base_gen=4)

    def run(with_swap, pkg):
        ref = pkg == "ref"
        sub = None
        if with_swap:
            pc = (RefPublishConfig if ref else PublishConfig)(
                codec="identity", bucket_mb=4.0)
            P_, S_ = ((RefPublisher, RefSubscriber) if ref
                      else (Publisher, Subscriber))
            p = rp if ref else params
            pub, sub = P_(p, pc), S_(p, pc)
        sch = (RefScheduler(RefServer(rc, batch=2, max_seq=64,
                                      cache_dtype=jnp.float32), rp,
                            subscriber=sub) if ref else
               Scheduler(Server(cfg, batch=2, max_seq=64,
                                cache_dtype=torch.float32, device="cpu"),
                         params, subscriber=sub))
        R_ = RefRequest if ref else Request
        reqs = [R_(rid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(mix)]
        for r in reqs:
            sch.submit(r)
        ticks = 0
        while not sch.idle:
            if with_swap and ticks == 2:
                sub.push(pub.publish(rp if ref else params, step=1))
            sch.tick()
            ticks += 1
        return [r.output for r in reqs], sch.stats["weight_swaps"]

    base, swaps0 = run(False, "port")
    swapped, swaps1 = run(True, "port")
    assert swaps0 == 0 and swaps1 >= 1
    assert base == swapped
    assert run(True, "ref") == (swapped, swaps1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_page_matches_reference(dtype):
    """The port's ``quant_page`` bit for bit the reference scheduler's
    jitted ``_quant_page`` over 120 pages (every page of 3 slots, 10
    draws, each page at its own magnitude) and an all-zero page (scale
    0). XLA turns the reference's ``max|z| / 127.0`` into a multiply by
    the f32 reciprocal: a true divide misses on a few percent of pages."""
    rc = ref_get("gpt2").smoke
    rsch = RefScheduler(RefServer(rc, batch=3, max_seq=32,
                                  cache_dtype=getattr(jnp, dtype)),
                        ref_init(RT.model_template(rc),
                                 jax.random.PRNGKey(0)),
                        kv_quant="qint8", kv_page=8)
    shape = rsch.cache["k"].shape                    # (L, 3, 32, K, hd)
    for draw in range(10):
        rng = np.random.default_rng(draw)
        mag = np.exp(rng.uniform(-5, 1, (1, 3, 4, 1, 1, 1)))
        base = {k: (rng.standard_normal(shape).reshape(
            shape[0], 3, 4, 8, *shape[3:]) * mag).reshape(shape).astype(
                np.float32) for k in ("k", "v")}
        if draw == 0:
            for k in base:
                base[k][:, 2, 8:16] = 0.0
        rcache = {k: jnp.asarray(v, getattr(jnp, dtype))
                  for k, v in base.items()}
        tcache = {k: torch.tensor(v).to(getattr(torch, dtype))
                  for k, v in base.items()}
        for slot in range(3):
            for start in range(0, 32, 8):
                rcache = rsch._quant_page(rcache, jnp.int32(slot),
                                          jnp.int32(start))
                quant_page(tcache, slot, start, 8, 32)
        for k in rcache:
            got = tcache[k].to(torch.float32).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(rcache[k].astype(jnp.float32)))
            assert (got != base[k].astype(got.dtype)).any()


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #

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
    """Every flag of the reference's serve CLI, with the same default,
    choices and help; the port adds only ``--device`` (cuda) and
    ``--layers`` (no default: the config's depth, as in the training
    CLI)."""
    from repro.launch import serve as ref_launch
    parsers = (_parser_of(ref_launch.main, monkeypatch),
               _parser_of(lambda: TLAUNCH.parse_args([]), monkeypatch))
    actions = [{a.dest: a for a in p._actions if a.dest != "help"}
               for p in parsers]
    assert set(actions[1]) == set(actions[0]) | {"device", "layers"}
    assert actions[1]["layers"].default is None
    for dest, a in actions[0].items():
        b = actions[1][dest]
        assert (b.default, b.choices, b.type, b.help, b.required) == (
            a.default, a.choices, a.type, a.help, a.required), dest
    assert TLAUNCH.parse_args(["--arch", "gpt2"]).device == "cuda"


def test_cli_runs_on_cpu(capsys):
    TLAUNCH.main(["--arch", "gpt2", "--smoke", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--gen", "5",
                  "--publish-every", "2", "--kv-quant", "qint8",
                  "--kv-page", "8"])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["req 0", "req 1",
                                                      "req 2"]
    assert all("5 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("# 3 requests over 2 slots: 15 tokens in ")
    assert "tok/s), 3 prefills, " in lines[-1]
    assert "weight swap(s)" in lines[-1] and "KV page(s)" in lines[-1]
