"""The port's MoE and MLA serving against the reference live, in one
process: llama4-scout (GQA, top-1 MoE with a shared expert) and
deepseek-v2 (MLA's latent cache and absorbed decode, a dense first
layer, top-2 MoE): caches, ``mla_forward``, prefill and decode, the
per-row routing groups, the ``Scheduler`` (its tokens and ``stats``,
with and without paged qint8 KV, with a sign1bit publish swap, and 8
slots of one prompt), the ``Server``'s expert-parallel plan and a
process's block of experts, expert-parallel serving in 2 gloo ranks,
and the serve CLI. Params from the reference's init through
``repro_torch.interop`` (the ranks: the port's seeded init, handed to the
reference as arrays), inputs from numpy seeds.

Tolerances, with their reasons:
* cache keys, shapes and dtypes, Scheduler tokens and ``stats``: equal;
* ``mla_forward`` with a bf16 cache (the reference's default cache
  dtype): ``ckv``/``kr`` bit for bit; with an f32 cache within 2e-6
  (``rms_norm``'s mean and rope's sin/cos round differently in torch and
  XLA: measured <= 4.8e-7 on the latent, 6e-8 on the rope key); the
  outputs within 1e-5 (measured <= 5.5e-7);
* ``prefill`` / ``decode`` logits and f32 caches at batch 2: within 1e-5
  (measured <= 4.2e-7 on the logits, 1.3e-6 on the caches after 3
  layers);
* the routing groups against each row routed alone: within 1e-6 (the
  expert GEMMs over other row counts; measured <= 2.4e-7);
* expert-parallel ranks: their logits within 1e-5 of the reference's
  single-device run of the rank's rows (the reference's MoE mesh path is
  bit for bit that per-worker run; measured <= 5.4e-7), tokens equal;
  against the port's one-process run of the same rows bit for bit on
  deepseek-smoke and within 1e-6 on llama4-smoke (its experts' GEMMs
  take 2 x the rows; measured <= 3.6e-7).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core.comm import NullComm as RefNullComm
from repro.models import attention as RA
from repro.models import moe as RMOE
from repro.models import rope as RR
from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init
from repro.serve import PublishConfig as RefPublishConfig
from repro.serve import Publisher as RefPublisher
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import Server as RefServer
from repro.serve import Subscriber as RefSubscriber

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core.leafwise import flatten_tree
from repro_torch.launch import mesh
from repro_torch.launch import serve as TLAUNCH
from repro_torch.launch import train as TTRAIN
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import rope as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import (Publisher, PublishConfig, Request, Scheduler,
                               Server, Subscriber)
from repro_torch.serve.scheduler import cache_leaves

torch.set_num_threads(1)

ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]
_MODELS = {}
_REF_BUILT = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params) of the
    smoke config, cached per arch."""
    if arch not in _MODELS:
        rc, pc = ref_get(arch).smoke, port_get(arch).smoke
        rp = ref_init(RT.model_template(rc), jax.random.PRNGKey(0))
        _MODELS[arch] = (rc, pc, rp, interop.params_from_reference(
            jax.device_get(rp)))
    return _MODELS[arch]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _maxdiff(a, b):
    return float(np.abs(_np(a).astype(np.float64) - _np(b)).max())


def _t(a):
    return torch.from_numpy(np.array(a))


class _RefScheduler(RefScheduler):
    """The reference's Scheduler, its jitted step functions built once a
    model and shape (they take the params as arguments) and shared by
    every run of this file."""

    def _build(self):
        key = (self.cfg.name, self.n_slots, self.max_seq, self.kv_page)
        names = ("_prefill_one", "_write_slot", "_decode_tick",
                 "_quant_page")
        if key not in _REF_BUILT:
            super()._build()
            _REF_BUILT[key] = [getattr(self, n) for n in names]
        for n, f in zip(names, _REF_BUILT[key]):
            setattr(self, n, f)


_ref_prefill = jax.jit(lambda p, b, c, cfg: RT.prefill(
    p, cfg, b, c, comm=RefNullComm()), static_argnums=3)
_ref_decode = jax.jit(lambda p, t, c, pos, cfg: RT.decode(
    p, cfg, t, c, pos, comm=RefNullComm()), static_argnums=4)


# --------------------------------------------------------------------- #
# caches and MLA
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, which):
    """Keys, shapes and dtypes of the reference's cache: MLA's {"ckv",
    "kr"} (L, B, S, r) / (L, B, S, dr), GQA's dense {"k", "v"}; the FULL
    configs as abstract shapes (the reference's ``eval_shape``, the
    port's ``meta`` tensors)."""
    attr = "smoke" if which == "smoke" else "config"
    rc, pc = getattr(ref_get(arch), attr), getattr(port_get(arch), attr)
    B, S = 3, 40
    want = jax.eval_shape(lambda: RT.init_cache(rc, B, S, jnp.bfloat16))
    dev = "cpu" if which == "smoke" else "meta"
    got = TT.init_cache(pc, B, S, torch.bfloat16, device=dev)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == \
            jnp.bfloat16
    if which == "smoke":
        assert not any(x.any() for x in cache_leaves(got))
    if pc.attn_type == "mla":
        assert tuple(got["ckv"].shape) == (pc.n_layers, B, S,
                                           pc.kv_lora_rank)
        assert tuple(got["kr"].shape) == (pc.n_layers, B, S, pc.mla_qk_rope)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mla_forward_prefill_and_absorbed_decode(dtype, per_row):
    """One MLA layer of deepseek-smoke: a prefill of 11 positions, then 6
    absorbed decode steps, against the reference's jitted
    ``mla_forward``; with ``per_row`` each row decodes at its own
    position (a (B,) ``cache_pos``, against the reference one row at a
    time, its Scheduler's vmap)."""
    rc, pc = ref_get("deepseek-v2-236b").smoke, \
        port_get("deepseek-v2-236b").smoke
    tmpl = RA.mla_template(rc.d_model, rc.n_heads, rc.kv_lora_rank,
                           rc.mla_qk_nope, rc.mla_qk_rope, rc.mla_v_dim)
    rp = ref_init(tmpl, jax.random.PRNGKey(3))
    tp = interop.params_from_reference(jax.device_get(rp))
    B, P, STEPS, S = 2, 11, 6, 24
    x = np.random.default_rng(0).standard_normal(
        (B, P + STEPS, rc.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    shapes = {"ckv": (B, S, rc.kv_lora_rank), "kr": (B, S, rc.mla_qk_rope)}
    rcache = {k: jnp.zeros(s, jd) for k, s in shapes.items()}
    tcache = {k: torch.zeros(s, dtype=td) for k, s in shapes.items()}
    f = jax.jit(lambda p, x, pos, c, cp: RA.mla_forward(
        p, rc, x, pos, cache=c, cache_pos=cp))
    cache_tol = 0.0 if dtype == "bfloat16" else 2e-6

    def check(to, ro, what):
        assert _maxdiff(to, ro) <= 1e-5, what
        for k in shapes:
            assert _maxdiff(tcache[k], rcache[k]) <= cache_tol, (what, k)

    ro, rcache = f(rp, x[:, :P], RR.text_positions(B, P), rcache, 0)
    to, tcache = TA.mla_forward(tp, pc, _t(x[:, :P]),
                                TR.text_positions(B, P), cache=tcache,
                                cache_pos=0)
    check(to, ro, "prefill")
    start = np.array([P, P - 4]) if per_row else np.array([P, P])
    for i in range(STEPS):
        pos = start + i
        xs = x[:, P + i:P + i + 1]
        if per_row:
            outs = []
            for b in range(B):
                lane = {k: v[b:b + 1] for k, v in rcache.items()}
                o, lane = f(rp, xs[b:b + 1], RR.text_positions(
                    1, 1, int(pos[b])), lane, int(pos[b]))
                outs.append(o)
                rcache = {k: rcache[k].at[b:b + 1].set(lane[k])
                          for k in shapes}
            ro = jnp.concatenate(outs)
            tpos = torch.from_numpy(pos)
        else:
            ro, rcache = f(rp, xs, RR.text_positions(B, 1, int(pos[0])),
                           rcache, int(pos[0]))
            tpos = int(pos[0])
        to, tcache = TA.mla_forward(tp, pc, _t(xs), TR.text_positions(
            B, 1, tpos), cache=tcache, cache_pos=tpos)
        check(to, ro, i)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Batch 2, a prefill of 13 tokens, then 6 decode steps at an int
    position, ``comm=None`` against the reference's ``NullComm``: logits
    and the f32 caches (deepseek's dense first layer in slot 0 of the
    stack, as the reference splits and re-concatenates it)."""
    rc, pc, rp, tp = _model(arch)
    B, P, STEPS, S = 2, 13, 6, 32
    toks = np.random.default_rng(1).integers(
        0, rc.vocab, (B, P + STEPS)).astype(np.int32)
    rcache = RT.init_cache(rc, B, S, jnp.float32)
    tcache = TT.init_cache(pc, B, S, torch.float32)
    rl, rcache = _ref_prefill(rp, {"tokens": toks[:, :P]}, rcache, rc)
    tl, tcache = TT.prefill(tp, pc, {"tokens": _t(toks[:, :P]).long()},
                            tcache)
    assert _maxdiff(tl, rl) <= 1e-5
    for i in range(STEPS):
        t = toks[:, P + i:P + i + 1]
        rl, rcache = _ref_decode(rp, t, rcache, jnp.int32(P + i), rc)
        tl, tcache = TT.decode(tp, pc, _t(t).long(), tcache, P + i)
        assert _maxdiff(tl, rl) <= 1e-5, i
    for k in rcache:
        assert _maxdiff(tcache[k], rcache[k]) <= 1e-5, k


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_per_row_positions_and_routing(arch):
    """Two prompts of 7 and 12 tokens prefilled each into its lane (the
    Scheduler's admission), then 4 decodes of both rows at once, each at
    its own position and routed alone (``groups=2``): each row's logits
    within 1e-5 of the reference's batch-1 decode of that row."""
    rc, pc, rp, tp = _model(arch)
    rng = np.random.default_rng(4)
    lens, S, STEPS = (7, 12), 32, 4
    prompts = [rng.integers(0, rc.vocab, n).astype(np.int32) for n in lens]
    follow = rng.integers(0, rc.vocab, (2, STEPS)).astype(np.int32)
    tcache = TT.init_cache(pc, 2, S, torch.float32)
    rcaches = []
    for b, p in enumerate(prompts):
        lane = {k: v[:, b:b + 1] for k, v in tcache.items()}
        TT.prefill(tp, pc, {"tokens": _t(p[None]).long()}, lane)
        _, rcache = _ref_prefill(rp, {"tokens": p[None]},
                                 RT.init_cache(rc, 1, S, jnp.float32), rc)
        rcaches.append(rcache)
    pos = torch.tensor(lens)
    for i in range(STEPS):
        tl, tcache = TT.decode(tp, pc, _t(follow[:, i:i + 1]).long(),
                               tcache, pos + i, groups=2)
        for b in range(2):
            rl, rcaches[b] = _ref_decode(rp, follow[b:b + 1, i:i + 1],
                                         rcaches[b], jnp.int32(lens[b] + i),
                                         rc)
            assert _maxdiff(tl[b:b + 1], rl) <= 1e-5, (i, b)


# --------------------------------------------------------------------- #
# the routing groups
# --------------------------------------------------------------------- #

def _moe_layer(arch):
    rc, pc, rp, tp = _model(arch)
    return (rc, {k: v[0] for k, v in rp["blocks"]["moe"].items()},
            {k: v[0] for k, v in tp["blocks"]["moe"].items()})


@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_groups_route_each_row_alone(arch, same):
    """``moe_forward(groups=B)`` on 8 rows of one token (``same``: all the
    same token, so every row picks the same experts): each row's output
    and the dropped fraction as the reference's ``moe_forward`` of that
    row alone; ``groups=1`` is the batch-wide capacity of the reference's
    batched call, which drops where the rows collide."""
    rc, rmoe, tmoe = _moe_layer(arch)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1 if same else 8, 1, rc.d_model))
    x = np.broadcast_to(x, (8, 1, rc.d_model)).astype(np.float32)
    kw = dict(top_k=rc.top_k, n_experts=rc.n_experts,
              capacity_factor=rc.capacity_factor)
    ref_one = jax.jit(lambda p, x: RMOE.moe_forward(p, x, **kw))
    got, met = TMOE.moe_forward(tmoe, _t(x), groups=8, **kw)
    drops = []
    for b in range(8):
        want, wmet = ref_one(rmoe, x[b:b + 1])
        assert _maxdiff(got[b:b + 1], want) <= 1e-6, b
        drops.append(float(wmet["dropped_frac"]))
    assert float(met["dropped_frac"]) == pytest.approx(np.mean(drops))
    whole, wmet = ref_one(rmoe, x)
    one, omet = TMOE.moe_forward(tmoe, _t(x), **kw)
    assert _maxdiff(one, whole) <= 1e-6
    assert float(omet["dropped_frac"]) == pytest.approx(
        float(wmet["dropped_frac"]))
    assert float(omet["aux_loss"]) == pytest.approx(float(wmet["aux_loss"]),
                                                    abs=1e-6)
    if same and arch == "llama4-scout-17b-a16e":
        # 8 assignments to one expert of capacity 4: half dropped
        assert float(omet["dropped_frac"]) == 0.5
        assert float(met["dropped_frac"]) == 0.0
    with pytest.raises(ValueError, match="routing groups"):
        TMOE.moe_forward(tmoe, _t(x), groups=3, **kw)


# --------------------------------------------------------------------- #
# the scheduler
# --------------------------------------------------------------------- #

def _prompts(vocab, seed, n, base_gen=3):
    """Prompts of 5 and 9 tokens in turn, budgets of 3, 4, 5, ..."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (5, 9)[i % 2]).tolist(), base_gen + i)
            for i in range(n)]


def _serve(arch, pkg, mix, slots=3, kv_quant=None, publish=None):
    """Serve ``mix`` through either package's Scheduler; ``publish``: a
    codec whose delta of the params plus seeded noise is pushed before
    tick 2. Returns (tokens, stats)."""
    rc, pc, rp, tp = _model(arch)
    ref = pkg == "ref"
    kw = {"kv_quant": kv_quant, "kv_page": 8}
    params = rp if ref else tp
    sub = None
    if publish:
        P_, S_, C_ = ((RefPublisher, RefSubscriber, RefPublishConfig) if ref
                      else (Publisher, Subscriber, PublishConfig))
        pub, sub = P_(params, C_(codec=publish)), S_(params,
                                                     C_(codec=publish))
        sub.push(pub.publish(params, step=0))
        rng = np.random.default_rng(5)
        noise = jax.tree.map(lambda a: 1e-3 * rng.standard_normal(
            a.shape).astype(np.float32), jax.device_get(rp))
        moved = jax.tree.map(lambda a, n: a + n, rp, noise) if ref else \
            interop.params_from_reference(jax.tree.map(
                lambda a, n: np.asarray(a) + n, jax.device_get(rp), noise))
    if ref:
        sch = _RefScheduler(RefServer(rc, batch=slots, max_seq=64,
                                      cache_dtype=jnp.float32), rp,
                            subscriber=sub, **kw)
    else:
        sch = Scheduler(Server(pc, batch=slots, max_seq=64,
                               cache_dtype=torch.float32, device="cpu"),
                        tp, subscriber=sub, **kw)
    R_ = RefRequest if ref else Request
    reqs = [R_(rid=i, prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(mix)]
    for r in reqs:
        sch.submit(r)
    ticks = 0
    while not sch.idle:
        if publish and ticks == 2:
            sub.push(pub.publish(moved, step=1))
        sch.tick()
        ticks += 1
    return [r.output for r in reqs], dict(sch.stats)


@pytest.mark.parametrize("kv_quant", [None, "qint8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_matches_reference(arch, kv_quant):
    """Five staggered requests over 3 slots (slot reuse), with and without
    the paged qint8 KV cache at pages of 8 (MLA: ``ckv`` and ``kr``
    paged): tokens and every stat equal the reference's Scheduler's."""
    mix = _prompts(512, 7, 5)
    (rt, rs), (tt, ts) = (_serve(arch, pkg, mix, kv_quant=kv_quant)
                          for pkg in ("ref", "port"))
    assert tt == rt and ts == rs
    if kv_quant:
        assert ts["pages_quantized"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_sign1bit_swap_matches_reference(arch):
    """A sign1bit delta of the params plus seeded noise, published before
    tick 2 and swapped in at its boundary (the MoE leaves' frames among
    the buckets): tokens and stats equal the reference's, and the swap
    moved some token against a run without it."""
    mix = _prompts(512, 13, 4, base_gen=6)
    (rt, rs), (tt, ts) = (_serve(arch, pkg, mix, kv_quant="qint8",
                                 publish="sign1bit")
                          for pkg in ("ref", "port"))
    assert tt == rt and ts == rs
    assert ts["weight_swaps"] == 2
    base, _ = _serve(arch, "port", mix, kv_quant="qint8")
    assert base != tt


def test_scheduler_routes_identical_slots_alone():
    """llama4-smoke, 8 slots holding one prompt: the Scheduler's tokens
    are the reference's (its vmap routes each slot's token alone). The
    batch-wide decode of the same inputs (one prefilled prompt in every
    row, then one decode) drops half the assignments (capacity 4 of 8 to
    one expert), and its logits part from the per-slot ones."""
    arch = "llama4-scout-17b-a16e"
    rc, pc, rp, tp = _model(arch)
    prompt = np.random.default_rng(5).integers(0, rc.vocab, 9).tolist()
    mix = [(prompt, 6)] * 8
    (rt, rs), (tt, ts) = (_serve(arch, pkg, mix, slots=8)
                          for pkg in ("ref", "port"))
    assert tt == rt and ts == rs
    cache = TT.init_cache(pc, 8, 16, torch.float32)
    tokens = torch.tensor([prompt] * 8)
    TT.prefill(tp, pc, {"tokens": tokens}, cache)
    nxt = torch.tensor([[tt[0][0]]] * 8)
    outs = {}
    for groups in (1, 8):
        stats = []
        c = {k: v.clone() for k, v in cache.items()}
        outs[groups] = TT.decode(tp, pc, nxt, c, 9, groups=groups,
                                 moe_stats=stats)[0]
        outs[groups, "drop"] = max(float(m["dropped_frac"]) for m in stats)
    assert outs[1, "drop"] == 0.5 and outs[8, "drop"] == 0.0
    assert _maxdiff(outs[1], outs[8]) > 1e-3


# --------------------------------------------------------------------- #
# the Server across processes
# --------------------------------------------------------------------- #

class _Rank:
    """A comm's index and size alone: the plan of one process."""

    def __init__(self, n, i):
        self.n, self.i = n, i

    def size(self):
        return self.n

    def index(self):
        return np.array([self.i])


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_server_expert_parallel_plan(arch, n):
    """The EP degree by the reference's suffix rule (``n`` when it
    divides the experts, else 1), the template with it (the reference's
    ``Server.template``), this process's abstract params (its block of
    the experts); ``init_params`` equals ``interop.expert_block`` of the
    whole seeded init, bit for bit."""
    pc, rc = port_get(arch).smoke, ref_get(arch).smoke
    for i in range(n):
        srv = Server(pc, comm=_Rank(n, i), device="cpu")
        want = n if rc.n_experts % n == 0 else 1
        assert srv.ep_degree == want
        assert (srv.comm is not None) == (want > 1)
        rt = RT.model_template(rc, ep_workers=want)
        ref_axes = [pd.ep_axis for pd in jax.tree.leaves(
            rt, is_leaf=lambda x: hasattr(x, "ep_axis"))]
        assert flatten_tree(TL.ep_axes(srv.template))[1] == ref_axes
        mine = srv.init_params(0)
        whole = TL.init_params(srv.template, 0)
        cut = interop.expert_block(jax.tree.map(
            lambda t: t.numpy(), whole, is_leaf=torch.is_tensor),
            srv.template, want, i if want > 1 else 0)
        abstract = srv.abstract_params(torch.float32)
        for a, b, c in zip(*(flatten_tree(t)[1] for t in (mine, cut,
                                                          abstract))):
            assert torch.equal(a, b) and a.shape == c.shape
        if want > 1:
            e = mine["blocks"]["moe"]["w_gate"]
            assert e.shape[1] == pc.n_experts // n
            assert torch.equal(e, whole["blocks"]["moe"]["w_gate"][
                :, i * e.shape[1]:(i + 1) * e.shape[1]])


@pytest.mark.parametrize("chunk", [16, 48, 4096])
def test_expert_block_drawn_in_chunks(chunk, monkeypatch):
    """A process's block of an expert leaf drawn chunk by chunk (chunks
    crossing the rows, the blocks and a tail under 16) is that block of
    the whole draw, bit for bit, at every block of 1, 2 and 4."""
    monkeypatch.setattr(TL, "_BLOCK_CHUNK", chunk)
    for shape, axis in (((3, 4, 5, 7), 1), ((8, 6, 3), 0), ((2, 4, 3), 1)):
        pd = TL.PD(shape, ep_axis=axis, dp=False)
        whole = TL.init_params({"w": pd}, 7)["w"]
        for n in (1, 2, 4):
            if shape[axis] % n:
                continue
            for i in range(n):
                got = TL.init_params({"w": pd}, 7, ep_block=(n, i))["w"]
                want = whole.unflatten(axis, (n, -1)).select(axis, i)
                assert torch.equal(got, want), (shape, n, i)


def test_server_refusals():
    """A mesh is item 3's, for any model; a MoE model takes a comm."""
    cfg = port_get("llama4-scout-17b-a16e").smoke
    with pytest.raises(NotImplementedError, match="ROADMAP queue item 3"):
        Server(cfg, mesh=object(), device="cpu")
    Server(cfg, comm=_Rank(2, 1), device="cpu")


EP_N, EP_SLOTS, EP_PROMPT, EP_GEN = 2, 2, 13, 5


def _ep_argv(arch):
    return ["--arch", arch, "--smoke", "--slots", str(EP_SLOTS),
            "--requests", str(EP_N * EP_SLOTS), "--prompt-len",
            str(EP_PROMPT), "--gen", str(EP_GEN), "--device", "cpu"]


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    """Both smokes served expert parallel in one spawn of 2 gloo ranks
    (``launch.train.rank_jobs``, a serve job each): arch -> each rank's
    saved result."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    dirs = {a: tmp_path_factory.mktemp(a.split("-")[0]) for a in ARCHS}
    try:
        mesh.spawn(TTRAIN.rank_jobs, EP_N,
                   ([(_ep_argv(a), str(d), False, "serve", False)
                     for a, d in dirs.items()], EP_N), timeout_s=240.0)
    finally:
        mp.undo()
    return {a: [torch.load(pathlib.Path(d) / f"rank{r}.pt")
                for r in range(EP_N)] for a, d in dirs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_ranks_match_reference_rows(arch, ep_ranks):
    """Each of 2 gloo ranks (EP 2: half the experts each, the dispatch
    buffers exchanged by ``all_to_all``) prefills its 2 rows and decodes
    5 greedy tokens: its logits within 1e-5 of the reference's
    single-device prefill/decode of those rows (``NullComm``, from the
    same weights) and its tokens the reference's; against the port's
    one-process ``Server`` run of the same rows bit for bit (deepseek) or
    within 1e-6 (llama4); every decode tick timed its exchanges."""
    args = TLAUNCH.parse_args(_ep_argv(arch))
    cfg = TLAUNCH.config_of(args)
    rc = ref_get(arch).smoke
    prompts = TLAUNCH.prompts_of(args, cfg)
    srv = Server(cfg, batch=EP_SLOTS, max_seq=EP_PROMPT + EP_GEN,
                 cache_dtype=torch.float32, device="cpu")
    params = srv.init_params(args.seed)
    rp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params,
                      is_leaf=torch.is_tensor)
    for r, res in enumerate(ep_ranks[arch]):
        assert res["ep_degree"] == EP_N and res["backend"] == "gloo"
        rows = prompts[r * EP_SLOTS:(r + 1) * EP_SLOTS]
        cache = RT.init_cache(rc, EP_SLOTS, 32, jnp.float32)
        rl, cache = _ref_prefill(rp, {"tokens": np.asarray(rows, np.int32)},
                                 cache, rc)
        want = [np.asarray(rl[:, -1, :rc.vocab])]
        for i in range(EP_GEN):
            tok = want[-1].argmax(-1)[:, None].astype(np.int32)
            rl, cache = _ref_decode(rp, tok, cache,
                                    jnp.int32(EP_PROMPT + i), rc)
            want.append(np.asarray(rl[:, 0, :rc.vocab]))
        want = np.stack(want, 1)
        assert _maxdiff(res["logits"], want) <= 1e-5, r
        assert np.array_equal(res["tokens"].numpy(), want.argmax(-1)), r
        mine = TLAUNCH.serve_rows(srv, params, rows, EP_GEN)
        if arch == "deepseek-v2-236b":
            assert torch.equal(res["logits"], mine["logits"]), r
        else:
            assert _maxdiff(res["logits"], mine["logits"]) <= 1e-6, r
        assert len(res["ep_ms"]) == EP_GEN and min(res["ep_ms"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_moe_configs_on_cpu(arch, capsys):
    """``launch.serve --arch <name>`` with the flags that exist: paged
    qint8 KV and a sign1bit publish every 3 ticks."""
    TLAUNCH.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--gen", "5",
                  "--kv-quant", "qint8", "--kv-page", "8", "--codec",
                  "sign1bit", "--publish-every", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert all("5 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("# 3 requests over 2 slots: 15 tokens in ")
    assert "weight swap(s)" in lines[-1] and " 0 weight swap" not in \
        lines[-1]


def test_dense_prefix_takes_the_first_cache_slots():
    """deepseek-smoke's dense first layer writes slot 0 of the latent
    stack: a prefill with the MoE layers' caches left out of the port's
    stack equals the reference's dense-prefix scan alone on slot 0."""
    rc, pc, rp, tp = _model("deepseek-v2-236b")
    toks = np.random.default_rng(2).integers(0, rc.vocab, (1, 6)).astype(
        np.int32)
    tcache = TT.init_cache(pc, 1, 8, torch.float32)
    TT.prefill(tp, pc, {"tokens": _t(toks).long()}, tcache)
    h = RT._embed(rp, rc, jnp.asarray(toks))
    pre = jax.tree.map(lambda x: x[:1], RT.init_cache(rc, 1, 8, jnp.float32))
    _, want, _ = RT._decoder_scan(rp, rc, h, RT._positions(rc, 1, 6),
                                  cache=pre, cache_pos=0, prefix=True)
    for k in ("ckv", "kr"):
        assert _maxdiff(tcache[k][:1], want[k]) <= 1e-6, k
        assert tcache[k][1:].abs().sum() > 0
