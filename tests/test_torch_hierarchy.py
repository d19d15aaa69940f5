"""The port's two-level (intra-pod x inter-pod) exchange against the
reference, live in one process on the same numpy inputs.

The reference runs its workers under a nested ``jax.vmap`` (outer axis
"pod", inner axis "data"), as ``tests/test_hierarchical.py`` does, on its
jnp path and on its Pallas path (interpret mode); the port stacks the n
workers on dim 0 and splits ``SimComm(n)`` into its outer and inner comm.

Tolerances, with their reasons:
* layouts, slice row counts, slice true counts, byte counts per level,
  packed bytes, the split comm's collectives: exact (static metadata,
  sign bits, data movement);
* worker-side scales of a slice: 1e-6 relative (an f32 L1 sum in another
  order than XLA's); EF errors bit for bit wherever the scale they were
  taken against is bit for bit the reference's, else 1e-5 relative /
  1e-6 absolute (``zw -/+ scale`` inherits the scale's few ulp);
* EF errors of the exchange over two rounds: the flat path's bar, 1e-5
  relative / 1e-6 absolute. Round two starts both packages from the
  reference's round-one EF state, so that a few-ulp EF difference cannot
  flip the sign bit of a near-zero element (see
  ``test_torch_compressor.py``); the port's own round-one state is held
  to the same bar. Its outputs: bit for bit, except under row scales on
  the folded flatten leaf, whose server scales are per element: there
  the intra-pod all_gather rounds to bf16 two f32 values within the flat
  bar to neighbouring bf16 values where a rounding boundary lies between
  them, so 1 bf16 ulp (2^-8 to 2^-7 of the value) or the flat bar's 1e-6
  absolute, at least 99% bit for bit;
* ``Hierarchy(inner=1)`` against the port's flat path: bit for bit;
* the identity codec: bit for bit the bf16-wire mean (the intra-pod
  phases round to bf16, the pod means of 2 or 4 values are exact in f32),
  and within 2^-8 of max |z| of the exact mean (an input and the output
  each round to bf16 once);
* the full-precision round: bit for bit, as the flat round (bf16 on the
  wire; an f32 sum of 2 to 4 bf16 values is exact in any order unless
  they span more than 2^14 in magnitude, and each mean rounds to bf16
  again);
* gpt2-smoke trainers, 8 steps at a peak lr of 3e-4 from the port's draw
  and batches: step losses within 1e-4 (``tests/test_torch_dist.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import codecs as RCD
from repro.core import compressor as RC
from repro.core import onebit_allreduce as RAR
from repro.core import schedules as RS
from repro.core.comm import Comm as RefComm
from repro.core.comm import Hierarchy as RefHierarchy
from repro.train import Trainer as RefTrainer

from repro_torch.core import codecs as TCD
from repro_torch.core import compressor as TC
from repro_torch.core import onebit_allreduce as TAR
from repro_torch.core.comm import Hierarchy, NullComm, SimComm
from repro_torch.core.compressed import comm_accounting
from repro_torch.data import synthetic as TD
from repro_torch.launch import train as TLAUNCH

# one intra-op thread: the inputs are small, and the suite runs several
# pytest-xdist workers per machine
torch.set_num_threads(1)

# (shape, tensor-parallel spec entries): flatten padded / exact / folded
# wider than FRAME_MAX_COLS; structured padded / 4-D; a leaf whose last
# slice is all pad at n=8, n_inner=4 (768 of 1024 padded elements)
CASES = [((37,), None), ((64,), None), ((100003,), None),
         ((13, 40), (None, "model")), ((6, 4, 24), (None, None, "model")),
         ((768,), None)]
IDS = ["flat37", "flat64", "fold100003", "rows13x40", "rows6x4x24",
       "flat768"]
MODES = ["tensor", "chunk", "row"]
TOPOLOGIES = [(4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4)]


def _layouts(shape, spec, n, ni):
    return (RC.make_layout(shape, None if spec is None else P(*spec), n,
                           n_inner=ni),
            TC.make_layout(shape, spec, n, n_inner=ni))


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(lo, seed, lead, shape=None, scale=1.0):
    """Seeded f32 normal stack of shape ``lead + shape`` (default: the
    layout's view); callers zero the padded positions."""
    rng = np.random.default_rng(seed)
    shape = lo.view_shape if shape is None else shape
    return (rng.standard_normal(lead + shape) * scale).astype(np.float32)


def _run_ref_hier(views, ef, lo, cfg):
    """The reference's Algorithm 2 over n nested-vmapped workers (pods
    outer, workers inner); inputs and outputs carry a flat leading n."""
    n, ni = views.shape[0], cfg.hierarchy.inner
    comm = RefComm(("pod", "data"))
    fold = lambda a: a.reshape((n // ni, ni) + a.shape[1:])
    unfold = lambda a: a.reshape((n,) + a.shape[2:])
    f = jax.jit(jax.vmap(jax.vmap(
        lambda v, e: RAR.onebit_allreduce_view(comm, v, e, lo, cfg),
        axis_name="data"), axis_name="pod"))
    out = f(fold(jnp.asarray(views)), jax.tree.map(fold, ef))
    return jax.tree.map(unfold, out)


# --- static counts and bytes ----------------------------------------------

@pytest.mark.parametrize("n,ni", TOPOLOGIES)
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_slice_counts_and_level_bytes_match_reference(shape, spec, n, ni):
    lo_r, lo_t = _layouts(shape, spec, n, ni)
    assert dataclasses.astuple(lo_t) == dataclasses.astuple(lo_r)
    assert lo_t.ef_worker_shape == lo_r.ef_worker_shape
    np.testing.assert_array_equal(TC.slice_row_counts(lo_t),
                                  RC.slice_row_counts(lo_r))
    for got, want in zip(TC.slice_true_counts(lo_t),
                         RC.slice_true_counts(lo_r)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for itemsize in (2, 4):
        assert (TC.fullprec_bytes_levels(lo_t, itemsize)
                == RC.fullprec_bytes_levels(lo_r, itemsize))
        for codec in ("sign1bit", "identity"):
            for mode in MODES:
                got = TC.compressed_bytes_levels(lo_t, mode, itemsize, codec)
                assert got == RC.compressed_bytes_levels(lo_r, mode,
                                                         itemsize, codec)
                assert all(type(v) is int for v in got.values())
                assert (TC.compressed_bytes(lo_t, mode, itemsize, codec)
                        == RC.compressed_bytes(lo_r, mode, itemsize, codec))
    if (shape, n, ni) == ((768,), 8, 4):
        # the last slice (chunks 6 and 7) holds only padding
        totals, _ = TC.slice_true_counts(lo_t)
        assert totals.tolist() == [256.0, 256.0, 256.0, 0.0]
        assert not TC.slice_row_counts(lo_t)[3].any()


def test_layout_refuses_a_hierarchy_that_does_not_divide():
    with pytest.raises(ValueError):
        TC.make_layout((64,), None, 4, n_inner=3)
    with pytest.raises(ValueError):
        Hierarchy(0)


def _accounting(n, ni):
    from repro_torch.configs.base import get
    from repro_torch.core.api import OptimizerConfig, build_optimizer
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tmpl = T.model_template(get("gpt2").config)
    opt = build_optimizer(
        OptimizerConfig(hierarchy=Hierarchy(ni) if ni else None),
        L.param_shapes(tmpl), specs=L.param_specs(tmpl),
        dp_mask=L.dp_mask(tmpl), n_workers=n)
    return comm_accounting(opt)


def test_gpt2_full_accounting_per_level():
    """gpt2 FULL, tensor scales, per sync and worker: 26.63 MiB of 1-bit
    flat at 4 workers; 8.88 MiB across and 284.09 MiB of bf16 inside the
    pods at 2 x 2; 4.44 and 426.2 at 2 x 4; 4 collectives per leaf."""
    mib = lambda x: round(x / 2 ** 20, 2)
    flat, h22, h24 = _accounting(4, 0), _accounting(4, 2), _accounting(8, 4)
    assert mib(flat["compressed_bytes_per_sync"]) == 26.63
    assert flat["compressed_bytes_per_sync_inner"] == 0
    assert flat["collectives_per_sync"] == 38 and flat["n_inner"] == 1
    assert (mib(h22["compressed_bytes_per_sync_outer"]),
            mib(h22["compressed_bytes_per_sync_inner"])) == (8.88, 284.09)
    assert (mib(h24["compressed_bytes_per_sync_outer"]),
            mib(h24["compressed_bytes_per_sync_inner"])) == (4.44, 426.2)
    assert h22["collectives_per_sync"] == 76
    assert (h22["n_outer"], h22["n_inner"]) == (2, 2)
    assert h22["fullprec_bytes_per_round"] == (
        h22["fullprec_bytes_per_round_inner"]
        + h22["fullprec_bytes_per_round_outer"])
    # pods of one are the flat accounting
    assert _accounting(4, 1) == flat


# --- the split comm -------------------------------------------------------

@pytest.mark.parametrize("n,ni", TOPOLOGIES)
def test_sim_split_matches_numpy_model(n, ni):
    """Outer-major grouping, w = k * ni + j: the inner comm of w is its
    pod {k * ni + i}, the outer comm the workers {i * ni + j}."""
    no = n // ni
    outer, inner = SimComm(n).split(ni)
    groups = {"outer": [[i * ni + w % ni for i in range(no)]
                        for w in range(n)],
              "inner": [[w // ni * ni + i for i in range(ni)]
                        for w in range(n)]}
    rng = np.random.default_rng(n + ni)
    for name, comm in (("outer", outer), ("inner", inner)):
        g = groups[name]
        size = len(g[0])
        assert comm.size() == size
        np.testing.assert_array_equal(
            comm.index(), [g[w].index(w) for w in range(n)])
        x = rng.standard_normal((n, size, 3, 8)).astype(np.float32)
        want = np.stack([np.stack([x[g[w][i], g[w].index(w)]
                                   for i in range(size)])
                         for w in range(n)])
        np.testing.assert_array_equal(comm.all_to_all(_t(x)).numpy(), want)
        want = np.stack([np.concatenate([x[v] for v in g[w]])
                         for w in range(n)])
        np.testing.assert_array_equal(comm.all_gather(_t(x)).numpy(), want)
        want = np.stack([sum(x[v] for v in g[w]) for w in range(n)])
        np.testing.assert_allclose(comm.psum(_t(x)).numpy(), want,
                                   rtol=1e-6)
        np.testing.assert_allclose(comm.pmean(_t(x)).numpy(), want / size,
                                   rtol=1e-6)
        with pytest.raises(ValueError):
            comm.all_to_all(_t(x)[:, :1].expand(n, size + 1, 3, 8))
    with pytest.raises(ValueError):
        SimComm(n).split(3)
    assert [type(c) for c in NullComm().split(2)] == [NullComm, NullComm]


# --- the worker side: slice frames ----------------------------------------

@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_slice_encode_matches_reference(shape, spec, mode, ref_pallas):
    """Worker-side encode of the inner slices, n=8 in pods of 4: every
    stacked worker owns another slice (the last one holds the pad, all
    of it for flat768), through the port's kernel dispatch (plain kernel
    versions on the CPU) and its whole-slice compressor, against the
    reference's codec on its jnp path or its Pallas path."""
    n, ni = 8, 4
    lo_r, lo_t = _layouts(shape, spec, n, ni)
    m_r = RC.pad_mask(lo_r)
    m_slices = (None if m_r is None else
                np.asarray(m_r).reshape((ni, lo_r.n_outer)
                                        + np.asarray(m_r).shape[1:]))
    z = _normal(lo_r, 3, (n,), lo_r.slice_shape)
    e = _normal(lo_r, 4, (n,), lo_r.slice_shape, 0.3)
    j = np.arange(n) % ni
    if m_slices is not None:
        z, e = z * m_slices[j], e * m_slices[j]
    codec = RCD.make_codec("sign1bit")
    want_p, want_e = jax.jit(jax.vmap(lambda a, b, jj, mm: codec.encode_worker(
        a, b, lo_r, mode, mm, inner_index=jj, use_pallas=ref_pallas)))(
            jnp.asarray(z), jnp.asarray(e), jnp.asarray(j),
            jnp.asarray(np.ones_like(z) if m_slices is None
                        else m_slices[j] * np.ones_like(z)))
    got_p, got_e = TCD.make_codec("sign1bit").encode_worker(
        _t(z), _t(e), lo_t, mode, inner_index=j)
    np.testing.assert_array_equal(got_p["packed"].numpy(),
                                  np.asarray(want_p["packed"]))
    s_got, s_want = got_p["scales"].numpy(), np.asarray(want_p["scales"])
    assert s_got.shape == s_want.shape
    np.testing.assert_allclose(s_got, s_want, rtol=1e-6)
    # the residual against a bitwise-equal scale is bitwise equal
    same = np.broadcast_to(s_got == s_want, z.shape)
    e_got, e_want = got_e.numpy(), np.asarray(want_e)
    assert same.any()
    np.testing.assert_array_equal(e_got[same], e_want[same])
    np.testing.assert_allclose(e_got, e_want, rtol=1e-5, atol=1e-6)
    # the whole-slice formulation agrees with the kernel path
    mask_t = None if m_slices is None else _t(m_slices[j])
    p2, s2, e2 = TC.ef_compress_slice(_t(z) + _t(e), lo_t, mode, mask_t, j)
    np.testing.assert_array_equal(p2.numpy(), got_p["packed"].numpy())
    np.testing.assert_allclose(s2.expand_as(got_p["scales"]).numpy(),
                               s_got, rtol=1e-6)
    np.testing.assert_allclose(e2.numpy(), e_got, rtol=1e-5, atol=1e-6)


# --- the whole exchange ---------------------------------------------------

def _hier_rounds(shape, spec, n, ni, mode, ref_pallas, codec="sign1bit"):
    """Two rounds of both packages from random worker and server EF state;
    returns [(port out, port EF, ref out, ref EF)] per round."""
    lo_r, lo_t = _layouts(shape, spec, n, ni)
    m_r = RC.pad_mask(lo_r)
    m = 1.0 if m_r is None else np.asarray(m_r)
    ms = (1.0 if m_r is None else
          m.reshape((ni, lo_r.n_outer) + m.shape[1:])[np.arange(n) % ni])
    j, k = np.arange(n) % ni, np.arange(n) // ni
    serve = (1.0 if m_r is None else m[j * lo_r.n_outer + k])
    ef = RAR.EFState(
        jnp.asarray(_normal(lo_r, 5, (n,), lo_r.ef_worker_shape, 0.3) * ms),
        jnp.asarray(_normal(lo_r, 6, (n,), lo_r.chunk_shape, 0.1) * serve))
    cfg_r = RAR.OneBitConfig(scale_mode=mode, use_pallas=ref_pallas,
                             codec=codec, hierarchy=RefHierarchy(inner=ni))
    cfg_t = TAR.OneBitConfig(scale_mode=mode, codec=codec,
                             hierarchy=Hierarchy(ni))
    rounds = []
    for r in range(2):
        z = _normal(lo_r, 10 + r, (n,)) * m
        out_r, ef_r = _run_ref_hier(z, ef, lo_r, cfg_r)
        out_t, ef_t = TAR.onebit_allreduce_view(
            SimComm(n), _t(z), TAR.EFState(*(_t(a) for a in ef)), lo_t,
            cfg_t)
        rounds.append((out_t, ef_t, out_r, ef_r))
        ef = ef_r
    return rounds


@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec", [CASES[2], CASES[3], CASES[4]],
                         ids=["fold100003", "rows13x40", "rows6x4x24"])
def test_hier_onebit_allreduce_matches_reference(shape, spec, mode,
                                                 ref_pallas):
    """n=4 in pods of 2 (n=8 in pods of 4 for the folded flatten leaf,
    whose padding lies in the last slice): the mean estimate and both new
    EF errors over two rounds; every worker holds the same estimate."""
    n, ni = (8, 4) if shape == (100003,) else (4, 2)
    for out_t, ef_t, out_r, ef_r in _hier_rounds(shape, spec, n, ni, mode,
                                                 ref_pallas):
        if mode == "row" and shape == (100003,):
            # row scales on the folded flatten leaf: its worker scales are
            # summed in another order than XLA's (EF errors a few ulp off
            # on 25-54% of elements), and the per-element server scales
            # carry that into the bf16 all_gather (measured: 0.016-0.018%
            # of outputs in round 1, none in round 2)
            np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r),
                                       rtol=2 ** -7, atol=1e-6)
            assert (out_t.numpy() == np.asarray(out_r)).mean() >= 0.99
        else:
            np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_r))
        for got, want in zip(ef_t, ef_r):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        assert (out_t == out_t[:1]).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_hier_inner_one_is_flat_bitwise(shape, spec, mode):
    """Pods of one worker: the two-level path is the flat path bit for
    bit (outputs and both EF errors, two rounds carrying the state)."""
    lo = TC.make_layout(shape, spec, 4, n_inner=1)
    m = TC.pad_mask(lo)
    m = 1.0 if m is None else m
    flat = TAR.OneBitConfig(scale_mode=mode)
    hier = TAR.OneBitConfig(scale_mode=mode, hierarchy=Hierarchy(1))
    efs = [TAR.init_ef_state(lo, 4)] * 2
    for r in range(2):
        z = _t(_normal(lo, 20 + r, (4,))) * m
        (o1, e1), (o2, e2) = (
            TAR.onebit_allreduce_view(SimComm(4), z, ef, lo, cfg)
            for ef, cfg in zip(efs, (flat, hier)))
        assert torch.equal(o1, o2)
        assert all(torch.equal(a, b) for a, b in zip(e1, e2))
        efs = [e1, e2]


@pytest.mark.parametrize("n,ni", [(4, 2), (8, 4), (8, 2)])
@pytest.mark.parametrize("shape,spec", [CASES[0], CASES[3], CASES[4]],
                         ids=["flat37", "rows13x40", "rows6x4x24"])
def test_hier_identity_codec_is_bf16_wire_mean(shape, spec, n, ni):
    """The exact codec: bf16 of the f32 mean over pods of the f32 pod
    means of the bf16 views, bit for bit, and the reference's result."""
    rounds = _hier_rounds(shape, spec, n, ni, "tensor", False, "identity")
    lo = TC.make_layout(shape, spec, n, n_inner=ni)
    no = n // ni
    z = _normal(lo, 10, (n,)) * (1.0 if TC.pad_mask(lo) is None
                                 else TC.pad_mask(lo).numpy())
    zb = _t(z).to(torch.bfloat16).to(torch.float32).reshape(
        (no, ni) + lo.view_shape)
    want = zb.mean(1).mean(0).to(torch.bfloat16).to(torch.float32)
    out_t, ef_t, out_r, _ = rounds[0]
    for w in range(n):
        assert torch.equal(out_t[w], want)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_r))
    # each input and the output round to bf16 once: within 2^-9 of
    # max |z| each, whatever the cancellation in the mean
    bound = 2 ** -8 * float(np.abs(z).max())
    assert float((out_t[0] - _t(z).mean(0)).abs().max()) <= bound
    # the identity codec leaves the EF state as it was
    assert ef_t[0].shape == (n,) + lo.ef_worker_shape


@pytest.mark.parametrize("n,ni", [(4, 2), (8, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("shape,spec", [CASES[0], CASES[3], CASES[4]],
                         ids=["flat37", "rows13x40", "rows6x4x24"])
def test_hier_fullprec_matches_reference(shape, spec, n, ni):
    lo_r, lo_t = _layouts(shape, spec, n, ni)
    z = _normal(lo_r, 30, (n,))
    comm = RefComm(("pod", "data"))
    h = RefHierarchy(inner=ni)
    fold = lambda a: a.reshape((n // ni, ni) + a.shape[1:])
    want = jax.jit(jax.vmap(jax.vmap(lambda a: RAR.fullprec_allreduce_view(
        comm, a, hierarchy=h, layout=lo_r), axis_name="data"),
        axis_name="pod"))(fold(jnp.asarray(z))).reshape(z.shape)
    got = TAR.fullprec_allreduce_view(SimComm(n), _t(z), torch.bfloat16,
                                      Hierarchy(ni), lo_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == got[:1]).all()


# --- gpt2-smoke trainers --------------------------------------------------

ARGV = ["--arch", "gpt2", "--smoke", "--steps", "8", "--batch", "8",
        "--seq", "32", "--sync-warmup", "2", "--double-every", "2",
        "--kappa", "1", "--lr", "3e-4", "--log-every", "8", "--device",
        "cpu"]


def _ref_losses(argv, params_stacked):
    """The reference's sim Trainer with the same hierarchy, from the
    port's draw on the port's batches: the per-step mean loss."""
    a = TLAUNCH.parse_args(argv)
    cfg = RefOptimizerConfig(
        name=a.optimizer,
        lr=RS.LinearWarmupExpDecay(peak_lr=a.lr, warmup_steps=a.lr_warmup,
                                   decay=0.99,
                                   decay_period=max(a.steps // 20, 1)),
        var_policy=RS.AdaptiveFreezePolicy(kappa=a.kappa),
        sync_policy=RS.LrProportionalSyncPolicy(
            warmup_steps=a.sync_warmup, double_every=a.double_every,
            max_interval=a.max_interval),
        scale_mode=a.scale_mode, hierarchy=RefHierarchy(inner=a.hierarchy))
    rt = RefTrainer(ref_get("gpt2").smoke, cfg, n_workers=a.workers)
    rp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params_stacked)
    rs = jax.vmap(lambda i: rt.opt.init(
        jax.tree.map(lambda x: x[i], rp)))(jnp.arange(a.workers))
    step = rt.sim_step_fn()
    data = TD.SyntheticLM(TD.DataConfig(vocab=512, seq_len=a.seq,
                                        global_batch=a.batch, seed=a.seed))
    losses = []
    for t in range(a.steps):
        b = {k: jnp.asarray(v.numpy().astype(np.int32))
             for k, v in data.batch(t).items()}
        rp, rs, rm = step(rp, rs, b)
        losses.append(float(np.mean(np.asarray(rm["loss"]))))
    return np.array(losses)


@pytest.mark.parametrize("n,ni", [(4, 2), (8, 4)])
def test_gpt2_smoke_trainer_matches_reference(n, ni, capsys):
    argv = ARGV + ["--mode", "sim", "--workers", str(n), "--hierarchy",
                   str(ni)]
    args = TLAUNCH.parse_args(argv)
    tr = TLAUNCH.make_trainer(args)
    assert tr.opt.hierarchy == Hierarchy(ni)
    assert all(lo.n_inner == ni for lo in tr.opt.layouts)
    params = tr.init(args.seed)[0]
    port = TLAUNCH.train(args, tr)
    out = capsys.readouterr().out
    assert f"hierarchy: {n // ni} pods x {ni} workers/pod" in out
    got = np.array([np.mean(rec["losses"]) for rec in port["records"]])
    assert [rec["sync"] for rec in port["records"]] == [
        1, 1, 1, 1, 1, 0, 1, 0]
    want = _ref_losses(argv, params)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    st = port["state"]
    assert st.err_w[0].shape == (n,) + tr.opt.layouts[0].ef_worker_shape


def test_cli_checks_the_hierarchy(monkeypatch):
    from repro_torch.launch import mesh
    monkeypatch.setattr(mesh, "spawn", lambda *a, **k: pytest.fail(
        "spawned ranks with a hierarchy that does not divide them"))
    with pytest.raises(ValueError, match="must divide"):
        TLAUNCH.main(ARGV + ["--mode", "dist", "--workers", "4",
                             "--hierarchy", "3"])
    with pytest.raises(ValueError, match="must divide"):
        TLAUNCH.make_trainer(TLAUNCH.parse_args(
            ARGV + ["--mode", "sim", "--workers", "4", "--hierarchy", "3"]))
    # one worker has no pods: single mode normalizes the hierarchy away
    tr = TLAUNCH.make_trainer(TLAUNCH.parse_args(
        ARGV + ["--mode", "single", "--hierarchy", "2"]))
    assert tr.hierarchy is None and tr.opt.layouts[0].n_inner == 1
