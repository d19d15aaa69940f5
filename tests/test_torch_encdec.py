"""The port's encoder-decoder (whisper-large-v3: the encoder and
cross-attention) against the reference live, in one process: the config,
template and comm layouts at SMOKE and FULL (FULL as metadata only),
cross-attention through ``gqa_forward``'s ``kv_override``, ``encode``,
``forward`` and ``lm_loss`` gradients (the cross ``bk``/``bv`` exactly
zero), remat, ``prefill`` (from ``frames`` or from ``enc_out``) then
``decode`` with ``enc_out`` against the reference and against the full
forward, ``Server.decode_fn`` at batch 4 against each row alone, the
Scheduler's refusal, and ``--layers`` cutting both stacks. Params from
the reference's init through ``repro_torch.interop``, inputs from numpy
seeds; the checks shared with the vlm live in ``tests/test_torch_vlm.py``.

Tolerances, with their reasons (those of ``tests/test_torch_vlm.py``):
* configs, templates, layouts, ``comm_accounting``, the frame pre-check,
  the refusal's text: equal;
* cross-attention and ``encode``: 1e-6 and 1e-5 (f32 matmuls and the
  layernorm's reductions in another order; measured <= 1.2e-7 and
  <= 4.8e-7);
* ``forward`` logits and the loss: 1e-5; each gradient leaf within 1e-5
  of its own largest magnitude plus 1e-10 (the encoder's unrotated key
  bias has a gradient that is zero in exact arithmetic, noise near 1e-12
  in both packages); the cross ``bk`` and ``bv``: exactly 0.0 in both,
  as the reference computes the cross keys and values without a bias;
* remat on against off, in the port: bit for bit;
* prefill and decode logits and caches: 1e-5, against the reference and
  against the port's full forward; the Server's batch of 4 against each
  row alone: 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import transformer as RT
from repro.serve import Scheduler as RefScheduler
from repro.serve import Server as RefServer

from repro_torch.configs.base import get as port_get
from repro_torch.core.leafwise import flatten_tree
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT
from repro_torch.models.config import cut_layers
from repro_torch.models.layers import param_shapes
from repro_torch.serve import Scheduler, Server

from test_torch_vlm import (batches, check_accounting, check_config,
                            check_forward_and_grads, check_layouts,
                            check_precheck, check_template, grads, maxdiff,
                            model)

torch.set_num_threads(1)

ARCH = "whisper-large-v3"


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_matches_reference(which):
    check_config(ARCH, which)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_template_matches_reference(which):
    port = check_template(ARCH, which, 1_646_100_480, 47)
    shapes = {"/".join(p): tuple(pd.shape) for p, pd in port}
    if which == "full":
        assert shapes["pos_embed"] == (32768, 1280)
        assert shapes["encoder/pos_embed"] == (1500, 1280)
        assert shapes["embed"] == (51968, 1280)
        assert shapes["cross/attn/bk"] == (32, 1280)
        cut = TT.model_template(cut_layers(port_get(ARCH).config, 8))
        assert sum(int(np.prod(s)) for s in flatten_tree(
            param_shapes(cut))[1]) == 544_204_800


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_layouts_match_reference(which, n):
    views = check_layouts(ARCH, which, n)
    if which == "full" and n == 2:
        # the always-zero cross biases are DP leaves like any other
        assert views["cross/attn/bv"] == (2, 16, 1280)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_comm_accounting_matches_reference(which):
    check_accounting(ARCH, which)


@pytest.mark.parametrize("n", [2, 4])
def test_frame_precheck_passes_on_every_full_unit(n):
    check_precheck(ARCH, n)


# --------------------------------------------------------------------- #
# cross-attention, the encoder, forward and gradients
# --------------------------------------------------------------------- #

def test_cross_attention_matches_reference():
    """``kv_override``: only ``bq`` added, nothing rotated (the query
    positions change nothing), every query sees every key."""
    rc, pc, rp, tp = model(ARCH)
    rng = np.random.default_rng(1)
    B, S, Se = 2, 5, 16
    x = rng.standard_normal((B, S, rc.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, Se, rc.n_kv, rc.hd)).astype(np.float32)
            for _ in range(2))
    p_ref = jax.tree.map(lambda a: a[0], rp["cross"]["attn"])
    p_port = {key: a[0] for key, a in tp["cross"]["attn"].items()}
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want, _ = RA.gqa_forward(p_ref, rc, jnp.asarray(x), jnp.asarray(pos),
                             kind="bidir",
                             kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, none = TATT.gqa_forward(
        p_port, pc, torch.from_numpy(x), torch.from_numpy(pos),
        kind="bidir", kv_override=(torch.from_numpy(k),
                                   torch.from_numpy(v)))
    assert none is None and maxdiff(got, want) <= 1e-6
    moved, _ = TATT.gqa_forward(
        p_port, pc, torch.from_numpy(x), torch.from_numpy(pos + 7),
        kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    assert torch.equal(moved, got)


def test_encode_matches_reference():
    rc, pc, rp, tp = model(ARCH)
    rb, tb = batches(rc, seed=2)
    want = jax.jit(lambda p, f: RT.encode(p, rc, f))(rp, rb["frames"])
    got = TT.encode(tp, pc, tb["frames"])
    assert got.shape == (2, rc.enc_frames, rc.d_model)
    assert maxdiff(got, want) <= 1e-5


def test_forward_and_grads_match_reference():
    g = check_forward_and_grads(ARCH, {})
    for leaf in ("cross/attn/bk", "cross/attn/bv"):
        port, ref = g[leaf]
        assert float(np.abs(ref).max()) == 0.0, leaf
        assert float(port.abs().max()) == 0.0, leaf
    assert float(g["cross/attn/bq"][0].abs().max()) > 0.0
    assert float(g["encoder/pos_embed"][0].abs().max()) > 0.0


def test_remat_is_bit_for_bit(monkeypatch):
    """``cfg.remat``: each encoder and decoder layer checkpointed, loss and
    gradients bit for bit the run without it."""
    _, pc, _, tp = model(ARCH)
    _, tb = batches(pc, seed=3)
    calls = []
    real = TT.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TT, "checkpoint", counted)
    _, l0, g0 = grads(tp, dataclasses.replace(pc, remat=False), tb)
    assert not calls
    _, l1, g1 = grads(tp, dataclasses.replace(pc, remat=True), tb)
    assert len(calls) == pc.n_layers + pc.enc_layers
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("given", ["frames", "enc_out"])
def test_prefill_then_decode_match_reference_and_forward(given):
    """Prefill 7 tokens (from the batch's ``frames``, or its ``enc_out``),
    then 4 decodes with ``enc_out``: logits and caches against the
    reference's jitted ``prefill``/``decode``, each decode's logits
    against the port's full forward over the 11 tokens."""
    rc, pc, rp, tp = model(ARCH)
    B, P, STEPS, S = 2, 7, 4, 32
    rb, tb = batches(rc, seed=4, b=B, s=P + STEPS)
    r_enc = RT.encode(rp, rc, rb["frames"])
    t_enc = TT.encode(tp, pc, tb["frames"])
    pre_r = {"tokens": rb["tokens"][:, :P], given: (
        rb["frames"] if given == "frames" else r_enc)}
    pre_t = {"tokens": tb["tokens"][:, :P], given: (
        tb["frames"] if given == "frames" else t_enc)}
    rcache = RT.init_cache(rc, B, S, jnp.float32)
    tcache = TT.init_cache(pc, B, S, torch.float32)
    assert set(tcache) == {"k", "v"} and tcache["k"].shape[0] == pc.n_layers
    rl, rcache = jax.jit(lambda p, b, c: RT.prefill(p, rc, b, c))(
        rp, pre_r, rcache)
    tl, tcache = TT.prefill(tp, pc, pre_t, tcache)
    assert maxdiff(tl, rl) <= 1e-5
    full, _ = TT.forward(tp, pc, tb)
    assert maxdiff(tl[:, 0], full[:, P - 1]) <= 1e-5
    step = jax.jit(lambda p, t, c, pos, e: RT.decode(p, rc, t, c, pos,
                                                     enc_out=e))
    for i in range(STEPS):
        t = tb["tokens"][:, P + i:P + i + 1]
        rl, rcache = step(rp, jnp.asarray(t.numpy().astype(np.int32)),
                          rcache, jnp.int32(P + i), r_enc)
        tl, tcache = TT.decode(tp, pc, t, tcache, P + i, enc_out=t_enc)
        assert maxdiff(tl, rl) <= 1e-5, i
        assert maxdiff(tl[:, 0], full[:, P + i]) <= 1e-5, i
    for k in ("k", "v"):
        assert maxdiff(tcache[k], rcache[k]) <= 1e-5


def test_server_decodes_rows_as_alone():
    """``Server.prefill_fn`` from frames and ``decode_fn(..., enc_out=)``
    at batch 4, 4 greedy steps: every row's logits within 1e-5 of the
    same row served alone at batch 1, and the same greedy tokens."""
    _, pc, _, tp = model(ARCH)
    _, tb = batches(pc, seed=5, b=4, s=4)

    def serve(rows):
        srv = Server(pc, batch=len(rows), max_seq=32,
                     cache_dtype=torch.float32, device="cpu")
        prefill, decode = srv.prefill_fn(), srv.decode_fn()
        cache = TT.init_cache(pc, len(rows), 32, torch.float32)
        frames = tb["frames"][rows]
        enc = TT.encode(tp, pc, frames)
        logits, cache = prefill(tp, {"tokens": tb["tokens"][rows],
                                     "frames": frames}, cache)
        out = [logits]
        for i in range(4):
            tok = logits[:, -1, :pc.vocab].argmax(-1)[:, None]
            logits, cache = decode(tp, cache, tok, 4 + i, enc_out=enc)
            out.append(logits)
        return torch.cat(out, dim=1)

    both = serve(list(range(4)))
    for r in range(4):
        alone = serve([r])
        assert maxdiff(both[r:r + 1], alone) <= 1e-5, r
        assert torch.equal(both[r, :, :pc.vocab].argmax(-1),
                           alone[0, :, :pc.vocab].argmax(-1))


def test_scheduler_refuses_encoder_decoder():
    """As the reference's Scheduler: a ValueError naming the encoder, word
    for word."""
    rc, pc, rp, tp = model(ARCH)
    with pytest.raises(ValueError) as want:
        RefScheduler(RefServer(rc, batch=2, max_seq=32), rp)
    with pytest.raises(ValueError) as got:
        Scheduler(Server(pc, batch=2, max_seq=32, device="cpu"), tp)
    assert str(got.value) == str(want.value)
    assert "encoder-decoder" in str(got.value)


def test_layers_cuts_both_stacks(capsys):
    """``--layers N`` on a config with an encoder: N encoder and N
    decoder layers, said in the run header; the serve CLI cuts the same
    way (and its Scheduler refuses the config)."""
    args = TLAUNCH.parse_args(["--arch", ARCH, "--layers", "8",
                               "--device", "cpu"])
    full = port_get(ARCH).config
    tr_cfg = cut_layers(full, args.layers)
    assert (tr_cfg.n_layers, tr_cfg.enc_layers) == (8, 8)
    assert dataclasses.replace(tr_cfg, n_layers=32, enc_layers=32) == full
    TLAUNCH.main(["--arch", ARCH, "--smoke", "--layers", "1", "--steps",
                  "1", "--batch", "2", "--seq", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=whisper-smoke layers=1+1(encoder) " in out
    assert "DONE: 1 steps" in out
    with pytest.raises(ValueError, match="encoder-decoder"):
        TSERVE.main(["--arch", ARCH, "--smoke", "--layers", "1",
                     "--device", "cpu"])
