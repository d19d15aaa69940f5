"""The port's state-space family on the serving side, against the
reference live in one process: the cache (per-layer SSM states in f32,
zamba2's shared KV slots), prefill and decode logits and caches, a
decode with one position per row against lone decodes, the
``Scheduler``'s tokens and ``stats`` (f32 and bf16 caches, with and
without paged qint8 KV, and the reference's ``quant_page`` quirk on the
SSM state), the refusal of a prompt that is not a multiple of the
chunk, and the serve CLI with weight swaps. Params from the reference's
init through ``repro_torch.interop``, inputs from numpy seeds.

Tolerances, with their reasons:
* cache shapes and dtypes, scheduler tokens and ``stats``: equal;
* prefill and decode logits and caches: 1e-5 (f32 sums in another
  order; measured <= 8e-7);
* a batched decode at per-row positions against each row decoded alone:
  1e-5 (the same arithmetic on other batch shapes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import Server as RefServer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.launch import serve as TLAUNCH
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, Scheduler, Server
from repro_torch.serve.scheduler import cache_leaves

torch.set_num_threads(1)

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
_MODELS = {}


def _model(arch, seed=0, **change):
    """(reference cfg, port cfg, reference params, port params) of the
    smoke config (with ``change``), cached."""
    key = (arch, seed, tuple(sorted(change.items())))
    if key not in _MODELS:
        rc, pc = (dataclasses.replace(c, **change) for c in
                  (ref_get(arch).smoke, port_get(arch).smoke))
        rp = ref_init(RT.model_template(rc), jax.random.PRNGKey(seed))
        _MODELS[key] = (rc, pc, rp, interop.params_from_reference(
            jax.device_get(rp)))
    return _MODELS[key]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _maxdiff(a, b):
    return float(np.abs(_np(a).astype(np.float64) - _np(b)).max())


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- #
# caches, prefill, decode
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, dtype):
    """The reference's layout leaf for leaf: the SSM states stacked over
    the layers in f32 whatever ``dtype``; zamba2's shared K/V
    (n_attn_apps, B, max_seq, K, hd) in ``dtype``."""
    rc, pc = ref_get(arch).smoke, port_get(arch).smoke
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = RT.init_cache(rc, 3, 40, jd)
    got = TT.init_cache(pc, 3, 40, td)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, got))
    for a, b in zip(jax.tree.leaves(want), cache_leaves(got)):
        assert tuple(b.shape) == a.shape and not b.any()
        assert str(b.dtype).split(".")[1] == str(a.dtype)
    if arch == "zamba2-1.2b":
        assert got["shared"]["k"].shape[0] == pc.n_attn_apps == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 16 tokens, then 6 decode steps, against the reference's
    jitted ``prefill``/``decode``; f32 caches, every leaf compared."""
    rc, pc, rp, tp = _model(arch)
    B, P, STEPS, S = 2, 16, 6, 32
    toks = np.random.default_rng(1).integers(0, rc.vocab, (B, P + STEPS))
    toks = toks.astype(np.int32)
    rcache = RT.init_cache(rc, B, S, jnp.float32)
    tcache = TT.init_cache(pc, B, S, torch.float32)
    rl, rcache = jax.jit(lambda p, b, c: RT.prefill(p, rc, b, c))(
        rp, {"tokens": toks[:, :P]}, rcache)
    tl, tcache = TT.prefill(tp, pc, {"tokens": _t(toks[:, :P]).long()},
                            tcache)
    assert _maxdiff(tl, rl) <= 1e-5
    for a, b in zip(jax.tree.leaves(rcache), cache_leaves(tcache)):
        assert _maxdiff(b, a) <= 1e-5
    step = jax.jit(lambda p, t, c, pos: RT.decode(p, rc, t, c, pos))
    ptrs = [x.data_ptr() for x in cache_leaves(tcache)]
    for i in range(STEPS):
        t = toks[:, P + i:P + i + 1]
        rl, rcache = step(rp, t, rcache, jnp.int32(P + i))
        tl, tcache = TT.decode(tp, pc, _t(t).long(), tcache, P + i)
        assert _maxdiff(tl, rl) <= 1e-5, i
    for a, b in zip(jax.tree.leaves(rcache), cache_leaves(tcache)):
        assert _maxdiff(b, a) <= 1e-5
    # written in place
    assert [x.data_ptr() for x in cache_leaves(tcache)] == ptrs


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_with_per_row_positions(arch):
    """Two rows prefilled with 8 and 16 tokens (each alone, as the
    Scheduler does), then 5 batched decodes at positions (8 + i, 16 + i):
    each row's logits those of the row decoded alone at batch 1."""
    rc, pc, rp, tp = _model(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, rc.vocab, n) for n in (8, 16)]
    nxt = rng.integers(0, rc.vocab, (2, 5))
    batched = TT.init_cache(pc, 2, 32, torch.float32)
    lones = []
    for r, pr in enumerate(prompts):
        lane = {k: ({kk: vv[:, r:r + 1] for kk, vv in v.items()})
                for k, v in batched.items()}
        TT.prefill(tp, pc, {"tokens": _t(pr[None]).long()}, lane)
        lone = TT.init_cache(pc, 1, 32, torch.float32)
        TT.prefill(tp, pc, {"tokens": _t(pr[None]).long()}, lone)
        lones.append(lone)
    pos = torch.tensor([8, 16])
    for i in range(5):
        lg, _ = TT.decode(tp, pc, _t(nxt[:, i:i + 1]).long(), batched,
                          pos + i)
        for r in range(2):
            want, _ = TT.decode(tp, pc, _t(nxt[r:r + 1, i:i + 1]).long(),
                                lones[r], int(pos[r]) + i)
            assert _maxdiff(lg[r:r + 1], want) <= 1e-5, (i, r)


# --------------------------------------------------------------------- #
# the scheduler and the CLI
# --------------------------------------------------------------------- #

def _prompts(vocab, seed, n, chunk=8, base_gen=3):
    """Prompts of 8, 16, 24, 8, ... tokens (multiples of the smoke
    chunk) and budgets of 3, 4, 5, ..."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, chunk * (1 + i % 3)).tolist(),
             base_gen + i) for i in range(n)]


def _serve(model, pkg, mix, dtype, kv_quant=None, max_seq=64, page=8):
    rc, pc, rp, tp = model
    kw = {"kv_quant": kv_quant, "kv_page": page} if kv_quant else {}
    if pkg == "ref":
        jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
        sch = RefScheduler(RefServer(rc, batch=3, max_seq=max_seq,
                                     cache_dtype=jd), rp, **kw)
        reqs = [RefRequest(rid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(mix)]
    else:
        td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
        sch = Scheduler(Server(pc, batch=3, max_seq=max_seq,
                               cache_dtype=td, device="cpu"), tp, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(mix)]
    sch.run(reqs)
    return [r.output for r in reqs], dict(sch.stats), sch.cache


@pytest.mark.parametrize("kv_quant", [None, "qint8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_matches_reference(arch, dtype, kv_quant):
    """Five staggered requests over 3 slots (slot reuse), f32 and bf16
    caches (zamba2's shared KV in the cache dtype, the SSM states f32),
    with and without the paged qint8 KV cache at pages of 8: tokens and
    every stat equal the reference's Scheduler's."""
    mix = _prompts(512, 7, 5)
    (rt, rs, _), (tt, ts, _) = (_serve(_model(arch), pkg, mix, dtype,
                                       kv_quant) for pkg in ("ref", "port"))
    assert tt == rt and ts == rs
    if kv_quant:
        assert ts["pages_quantized"] > 0


def test_quant_page_takes_in_the_ssm_state_when_max_seq_is_its_heads():
    """The reference's quirk, kept: ``quant_page`` picks every float leaf
    with ``shape[2] == max_seq``; at max_seq 16 = ssm_heads (head dim 16,
    chunk 4) that is the SSM's h (L, B, H, P, N) too, quantized a page
    of 4 heads at a time. Tokens, stats and the final h equal the
    reference's, and h differs from the run without qint8."""
    model = _model("mamba2-2.7b", ssm_head_dim=16, ssm_chunk=4)
    pc = model[1]
    assert pc.ssm_heads == 16
    mix = [(np.random.default_rng(i).integers(0, 512, 4 * (1 + i % 2)
                                              ).tolist(), 4 + i)
           for i in range(4)]
    (rt, rs, rc), (tt, ts, tc) = (_serve(model, pkg, mix, "f32", "qint8",
                                         max_seq=16, page=4)
                                  for pkg in ("ref", "port"))
    assert tt == rt and ts == rs and ts["pages_quantized"] > 0
    assert _maxdiff(tc["ssm"]["h"], rc["ssm"]["h"]) <= 1e-5
    _, _, plain = _serve(model, "port", mix, "f32", None, max_seq=16)
    assert not torch.equal(tc["ssm"]["h"], plain["ssm"]["h"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_off_the_chunk_is_refused_at_submit(arch):
    """A prompt of 12 tokens (smoke chunk 8): the port refuses it at
    ``submit`` naming the chunk; the reference's Scheduler fails at its
    prefill's assertion."""
    rc, pc, rp, tp = _model(arch)
    sch = Scheduler(Server(pc, batch=2, max_seq=64, device="cpu"), tp)
    with pytest.raises(ValueError, match=r"prompt length 12 is not a "
                       r"multiple of .*'s ssm_chunk \(8\)"):
        sch.submit(Request(rid=0, prompt=[1] * 12, max_new_tokens=2))
    assert not sch.queue
    ref = RefScheduler(RefServer(rc, batch=2, max_seq=64), rp)
    with pytest.raises(AssertionError):
        ref.run([RefRequest(rid=0, prompt=[1] * 12, max_new_tokens=2)])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_ssm_configs_with_weight_swaps(arch, capsys):
    """``launch.serve --arch <name> --smoke --prompt-len 16`` with qint8
    KV pages and a qint8 weight refresh every 4 ticks; ``--layers``
    cuts the depth."""
    TLAUNCH.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--gen", "5",
                  "--prompt-len", "16", "--kv-quant", "qint8",
                  "--kv-page", "8", "--publish-every", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert all("5 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("# 3 requests over 2 slots: 15 tokens in ")
    swaps = int(lines[-1].split(" weight swap")[0].rsplit(" ", 1)[1])
    assert swaps >= 1
    run = TLAUNCH.build(TLAUNCH.parse_args(
        ["--arch", arch, "--layers", "2", "--smoke", "--device", "cpu",
         "--prompt-len", "8"]))
    assert run.cfg.n_layers == 2
    with pytest.raises(ValueError, match="ssm_chunk"):
        TLAUNCH.build(TLAUNCH.parse_args(
            ["--arch", arch, "--smoke", "--device", "cpu"]))
