"""The port's elastic data parallelism (``repro_torch.elastic``: reshard,
reshard_trainer, reshard_report, restore_resharded, FleetSim, and the
CLI's ``--resize``) against the reference's ``repro.elastic``, live.

* The chunk remap: the port's ``_remap_fn`` equals the reference's on the
  same views with garbage in the pads (hypothesis over sizes and widths,
  plus structured and two-level layouts), and keeps the properties of
  ``tests/test_elastic.py``: the natural leaf reads back bitwise, pads
  land zero, n -> m -> n is the identity on clean views.
* The origin maps: ``worker_origin``, ``_entity_origin`` and the row
  maps give the reference's values, and its error texts word for word.
* Whole trees: the five ``BENCH_elastic.json`` geometries plus 4 -> 3
  (survivors 0, 1, 3) and 4 -> 4 with a joiner (the fold over equal
  layouts), resharded by both packages from the same trained gpt2-smoke
  state (the port's 7 steps, the last a local one, carried into the reference through
  ``interop.state_to_reference``): params and every state leaf bit for
  bit, for ``zero_one_adam`` in the four variants of the reference's
  test (flat, flat bucketed, 2 pods x 2, 2 pods x 2 bucketed) and for
  ``zero_one_lamb`` (its trust slot), ``one_bit_adam`` and ``adam``
  flat. The fold is the reference's eager f32 arithmetic (three
  roundings; 4 -> 3 has alpha = 0.75, where a fused multiply-add would
  differ). m = n is bitwise the identity in the port alone too.
* ``reshard_report``: the file's geometry fields, and the reference's
  report at gpt2 FULL's layouts (static).
* Mass conservation of the worker EF, joiners' ``u`` zero and params
  cloned, as the reference's test checks them.
* ``restore_resharded`` across packages both ways (a reference file into
  a port trainer of another width, a port file into the reference's),
  with the missing-width and dtype errors of both packages equal.
* ``FleetSim``: the schedule errors; 12 steps of kill / shrink / rejoin
  (resizes at 4 and 8) against the reference's FleetSim from the
  reference's init and batches, under the slice bars of
  ``test_torch_slice.py`` (losses within 1e-4, params 99% within 1e-4
  and all within 0.05), the reports equal but ``reshard_ms``.
* The CLI: ``--resize``'s parse and mode errors as the reference's, and
  the ``meta`` a resized run saves.
"""
import dataclasses
import importlib
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro.checkpointing import io as ref_io
from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import compressor as RC
from repro.core import schedules as RS
from repro.core.comm import Hierarchy as RefHierarchy
from repro.core.compressed import CompressedDPState as RefState
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.elastic import FleetSim as RefFleetSim
from repro.elastic import ResizeEvent as RefResizeEvent
from repro.elastic import reshard_report as ref_report
from repro.elastic import reshard_trainer as ref_reshard_trainer
from repro.elastic import restore_resharded as ref_restore_resharded
from repro.launch import train as RLAUNCH
from repro.train import Trainer as RefTrainer

from repro_torch import elastic as E
from repro_torch import interop
from repro_torch.checkpointing import io as port_io
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import compressor as TC
from repro_torch.core import schedules as TS
from repro_torch.core.comm import Hierarchy, SimComm
from repro_torch.core.leafwise import flatten_tree
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.elastic import simulate as TSIM
from repro_torch.launch import train as TLAUNCH
from repro_torch.train import step as TSTEP

# the packages re-export the ``reshard`` function under the submodule's
# name; the private helpers come through importlib
RR = importlib.import_module("repro.elastic.reshard")
PR = importlib.import_module("repro_torch.elastic.reshard")

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_CFG, PORT_CFG = ref_get("gpt2").smoke, port_get("gpt2").smoke
SEQ, BATCH, STEPS = 16, 8, 7

VARIANTS = {
    "flat": {},
    "flat_bucketed": dict(bucket_mb=0.25),
    "hier": dict(inner=2),
    "hier_bucketed": dict(inner=2, bucket_mb=0.25),
}


def _cfgs(variant="flat", name="zero_one_adam", lr=1e-3):
    """The reference test's OPT_BASE with ``variant``, in both packages."""
    kw = dict(VARIANTS[variant])
    inner = kw.pop("inner", None)
    ref = RefOptimizerConfig(
        name=name, lr=RS.ConstantLr(lr),
        var_policy=RS.AdaptiveFreezePolicy(kappa=2),
        sync_policy=RS.LrProportionalSyncPolicy(
            warmup_steps=2, double_every=3, max_interval=2),
        onebit_warmup=2,
        hierarchy=RefHierarchy(inner=inner) if inner else None, **kw)
    port = TA.OptimizerConfig(
        name=name, lr=TS.ConstantLr(lr),
        var_policy=TS.AdaptiveFreezePolicy(kappa=2),
        sync_policy=TS.LrProportionalSyncPolicy(
            warmup_steps=2, double_every=3, max_interval=2),
        onebit_warmup=2,
        hierarchy=Hierarchy(inner) if inner else None, **kw)
    return ref, port


def _port_trainer(cfg, n, arch_cfg=PORT_CFG):
    return TSTEP.Trainer(arch_cfg, cfg, comm=SimComm(n), device="cpu")


# --------------------------------------------------------------------- #
# the chunk remap
# --------------------------------------------------------------------- #

def _check_remap(shape, ref_spec, port_spec, n, m, seed, n_inner=1,
                 m_inner=1):
    """Both packages' remap of one dirty view (pads hold 1e9 garbage),
    and the reference test's properties on the port's."""
    lo_n = TC.make_layout(shape, port_spec, n, n_inner=n_inner)
    lo_m = TC.make_layout(shape, port_spec, m, n_inner=m_inner)
    rlo_n = RC.make_layout(shape, ref_spec, n, n_inner=n_inner)
    rlo_m = RC.make_layout(shape, ref_spec, m, n_inner=m_inner)
    size = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    x = (rng.permutation(size) + 1.0).astype(np.float32).reshape(shape)
    v = TC.to_view(torch.from_numpy(x), lo_n)
    mask = TC.pad_mask(lo_n)
    clean = v if mask is None else v * mask
    dirty = v if mask is None else clean + 1e9 * (1 - mask)

    fwd = PR._remap_fn(lo_n, lo_m)
    got = fwd(dirty)
    want = RR._remap_fn(rlo_n, rlo_m)(jnp.asarray(dirty.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if lo_n == lo_m:
        assert got is dirty       # the identity short-circuit
        return
    np.testing.assert_array_equal(TC.from_view(got, lo_m).numpy(), x)
    mask_m = TC.pad_mask(lo_m)
    if mask_m is not None:
        assert (got * (1 - mask_m) == 0).all()
    assert TC.true_counts(lo_n)[0] == TC.true_counts(lo_m)[0] == size
    back = PR._remap_fn(lo_m, lo_n)(fwd(clean))
    assert torch.equal(back, clean)
    # stacked: every row of a leading worker dim remapped alike
    stacked = torch.stack([dirty, 2 * dirty])
    np.testing.assert_array_equal(fwd(stacked)[1].numpy(),
                                  (2 * got).numpy())


@settings(max_examples=40, deadline=None)
@given(size=st.integers(1, 700), n=st.sampled_from([1, 2, 3, 4, 8]),
       m=st.sampled_from([1, 2, 3, 4, 8]), seed=st.integers(0, 2**31 - 1))
def test_remap_matches_reference(size, n, m, seed):
    _check_remap((size,), None, None, n, m, seed)


@pytest.mark.parametrize("shape,spec,n,m,ni,mi", [
    ((13, 40), "model", 4, 2, 1, 1),      # structured, padded rows
    ((6, 4, 24), "model", 2, 4, 1, 1),
    ((37,), None, 4, 4, 2, 2),            # hier identity
    ((200,), None, 4, 2, 2, 2),           # hier shrink
    ((200,), None, 4, 2, 2, 1),           # hier -> flat
    ((13, 40), "model", 4, 3, 2, 1),      # structured, 4 -> 3
])
def test_remap_structured_and_hierarchical(shape, spec, n, m, ni, mi):
    ref_spec = port_spec = None
    if spec:
        entries = (None,) * (len(shape) - 1) + ("model",)
        ref_spec, port_spec = P(*entries), entries
    _check_remap(shape, ref_spec, port_spec, n, m, 7, ni, mi)


# --------------------------------------------------------------------- #
# origin maps
# --------------------------------------------------------------------- #

ORIGINS = [(2, 4, None), (4, 2, None), (4, 2, (0, 2)), (4, 4, (3, 1)),
           (4, 3, (0, 1, 3)), (8, 4, (7, 5, 1)), (1, 4, None)]


@pytest.mark.parametrize("n,m,survivors", ORIGINS)
def test_origin_maps_match_reference(n, m, survivors):
    got = E.worker_origin(n, m, survivors)
    assert got == RR.worker_origin(n, m, survivors)
    for ni_s in (1, 2, 4):
        for ni_d in (1, 2, 4):
            if n % ni_s or m % ni_d:
                continue
            try:
                want = RR._entity_origin(got, n, m, ni_s, ni_d)
            except ValueError as err:
                with pytest.raises(ValueError) as perr:
                    PR._entity_origin(got, n, m, ni_s, ni_d)
                assert str(perr.value) == str(err)
            else:
                assert PR._entity_origin(got, n, m, ni_s, ni_d) == want
    for w in (1, 2, 4, 8):
        for inner in (1, 2, 4):
            if w % inner:
                continue
            np.testing.assert_array_equal(PR._owner_of_rows(w, inner),
                                          RR._owner_of_rows(w, inner))
            np.testing.assert_array_equal(PR._rows_of_workers(w, inner),
                                          RR._rows_of_workers(w, inner))
            rows = PR._rows_of_workers(w, inner)
            np.testing.assert_array_equal(
                PR._owner_of_rows(w, inner)[rows], np.arange(w))


@pytest.mark.parametrize("args", [
    (4, 4, (0, 0)), (4, 4, (5,)), (4, 2, (0, 1, 2)),   # worker_origin
    ("entity", (0, 2), 4, 2, 2, 2),                      # not pod-aligned
    ("entity", (0, 1), 4, 2, 2, 1),                      # pod carried twice
])
def test_origin_errors_are_the_references(args):
    if args[0] == "entity":
        fns = (RR._entity_origin, PR._entity_origin)
        args = args[1:]
    else:
        fns = (RR.worker_origin, PR.worker_origin)
    with pytest.raises(ValueError) as want:
        fns[0](*args)
    with pytest.raises(ValueError) as got:
        fns[1](*args)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# whole trees against the reference
# --------------------------------------------------------------------- #

_TRAINED = {}


def _trained(variant="flat", name="zero_one_adam"):
    """One trained (port trainer, params, state) of 4 workers per
    (variant, optimizer), cached: STEPS steps of gpt2-smoke on the port's
    stream (tests never modify it; every transform returns new
    tensors)."""
    key = (variant, name)
    if key not in _TRAINED:
        tr = _port_trainer(_cfgs(variant, name)[1], 4)
        params, state = tr.init(5)
        data = SyntheticLM(DataConfig(vocab=PORT_CFG.vocab, seq_len=SEQ,
                                      global_batch=BATCH, seed=5))
        for t in range(STEPS):
            params, state, _ = tr.step(params, state, data.batch(t))
        _TRAINED[key] = (tr, params, state)
    return _TRAINED[key]


def _jnp(x):
    if x is None:
        return None
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x))


def _to_reference(params, state):
    """The port's (params, state) as the reference's stacked trees."""
    s = interop.state_to_reference(state)
    lst = lambda xs: [_jnp(x) for x in xs]
    return (jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
            RefState(step=_jnp(s.step), gamma_acc=_jnp(s.gamma_acc),
                     sync_pstate=tuple(_jnp(v) for v in s.sync_pstate),
                     var_pstate=tuple(_jnp(v) for v in s.var_pstate),
                     slots={k: lst(v) for k, v in s.slots.items()},
                     u=lst(s.u), err_w=lst(s.err_w), err_s=lst(s.err_s),
                     anchor=lst(s.anchor)))


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.dtype, a.shape, a.tobytes()


def _assert_bitwise_reference(ref_params, ref_state, params, state):
    """Every leaf of the port's (params, state) in the reference's tree
    layout has the reference's path, dtype, shape and bytes."""
    want = jax.tree_util.tree_flatten_with_path(
        {"params": ref_params, "state": ref_state})[0]
    paths, leaves, _ = port_io.flatten(
        {"params": params, "state": interop.state_to_reference(state)})
    assert paths == [jax.tree_util.keystr(k) for k, _ in want]
    for path, (_, a), b in zip(paths, want, leaves):
        assert _bits(a) == _bits(b), path


def _assert_port_bitwise(t0, t1):
    for a, b in zip(port_io.flatten(t0)[1], port_io.flatten(t1)[1]):
        assert _bits(a) == _bits(b)


# (n_from, n_to, survivors) per geometry and topology: the BENCH_elastic
# scenarios, 4 -> 3 (alpha 0.75: an FMA would round otherwise), and 4 -> 4
# with a joiner (a fold over equal layouts, pads and all)
FLAT_GEOMS = {"4to4_identity": (4, 4, None), "4to2_kill1": (4, 2, (0, 2)),
              "2to4_grow": (2, 4, None), "4to3_kill2": (4, 3, (0, 1, 3)),
              "4to4_kill2_rejoin": (4, 4, (0, 1, 3))}
HIER_GEOMS = {"4to4_identity": (4, 4, None), "4to2_podkill": (4, 2, (0, 1)),
              "2to4_grow": (2, 4, None)}
RESHARD_CASES = [
    ("zero_one_adam", v, g) for v in VARIANTS
    for g in (HIER_GEOMS if v.startswith("hier") else FLAT_GEOMS)] + [
    (name, "flat", g) for name in ("zero_one_lamb", "one_bit_adam", "adam")
    for g in FLAT_GEOMS]


def _source(variant, name, n):
    """The trained state at width ``n``: 4 as trained; 2 through the
    port's reshard from 4 (kill survivors of the variant's topology)."""
    tr, params, state = _trained(variant, name)
    if n == 4:
        return tr, params, state
    mid = _port_trainer(tr.opt_cfg, n)
    survivors = (0, 1) if variant.startswith("hier") else (0, 2)
    return (mid,) + E.reshard_trainer(tr, mid, params, state,
                                      survivors=survivors)


@pytest.mark.parametrize("name,variant,geom", RESHARD_CASES,
                         ids=[f"{a}-{b}-{c}" for a, b, c in RESHARD_CASES])
def test_reshard_matches_reference(name, variant, geom):
    n, m, survivors = (HIER_GEOMS if variant.startswith("hier")
                       else FLAT_GEOMS)[geom]
    src, params, state = _source(variant, name, n)
    before = port_io.flatten(interop.state_to_reference(state))[1]
    before = [_bits(x) for x in before]
    ref_cfg, port_cfg = _cfgs(variant, name)
    dst = _port_trainer(port_cfg, m)
    rsrc = RefTrainer(REF_CFG, ref_cfg, n_workers=n)
    rdst = RefTrainer(REF_CFG, ref_cfg, n_workers=m)
    rp, rs = _to_reference(params, state)
    want = ref_reshard_trainer(rsrc, rdst, rp, rs, survivors=survivors)
    got = E.reshard_trainer(src, dst, params, state, survivors=survivors)
    _assert_bitwise_reference(*want, *got)
    assert E.reshard_report(src.opt, dst.opt, survivors=survivors) == (
        ref_report(rsrc.opt, rdst.opt, survivors=survivors))
    # the input is not modified
    assert before == [_bits(x) for x in port_io.flatten(
        interop.state_to_reference(state))[1]]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reshard_at_same_width_is_the_identity(variant):
    """m = n: params, every state tensor and the host scalars bit for bit,
    in new tensors."""
    tr, params, state = _trained(variant)
    dst = _port_trainer(tr.opt_cfg, 4)
    p2, s2 = E.reshard_trainer(tr, dst, params, state)
    _assert_port_bitwise(params, p2)
    _assert_port_bitwise(interop.state_to_reference(state),
                         interop.state_to_reference(s2))
    for a, b in zip(flatten_tree(params)[1], flatten_tree(p2)[1]):
        assert a.data_ptr() != b.data_ptr() and b.is_contiguous()


def test_reshard_fold_keeps_the_sign_of_zero_as_the_reference():
    """The dead mass is a python ``sum`` from 0 in both packages, so -0
    residuals fold to +0 alike (4 -> 4 keeps the layouts, pads and all)."""
    tr, params, state = _trained()
    err_w = [torch.where(e == 0, torch.tensor(-0.0), e) for e in state.err_w]
    err_w[0] = -torch.zeros_like(err_w[0])
    state = dataclasses.replace(state, err_w=err_w)
    dst = _port_trainer(tr.opt_cfg, 4)
    rsrc = RefTrainer(REF_CFG, _cfgs()[0], n_workers=4)
    want = ref_reshard_trainer(rsrc, rsrc, *_to_reference(params, state),
                               survivors=(0, 1, 3))
    got = E.reshard_trainer(tr, dst, params, state, survivors=(0, 1, 3))
    _assert_bitwise_reference(*want, *got)
    assert not torch.signbit(got[1].err_w[0]).any()


def test_reshard_validation_errors():
    tr, params, state = _trained()
    flat_b = _port_trainer(_cfgs("flat_bucketed")[1], 2)
    with pytest.raises(ValueError, match="bucketing must match"):
        E.reshard(state, tr.opt, flat_b.opt)
    with pytest.raises(ValueError, match="different parameter trees"):
        E.reshard(state, tr.opt, _port_trainer(
            tr.opt_cfg, 2, port_get("bert-base").smoke).opt)
    with pytest.raises(TypeError) as got:
        E.reshard(state, object(), tr.opt)
    with pytest.raises(TypeError) as want:
        RR.reshard(None, object(), None)
    assert str(got.value) == str(want.value).replace(
        "repro.core", "repro_torch.core")
    with pytest.raises(TypeError, match="CompressedDPState"):
        E.reshard({}, tr.opt, tr.opt)
    narrow = _port_trainer(tr.opt_cfg, 2)
    with pytest.raises(ValueError, match="leading dim 2 .*shape \\(4, "):
        E.reshard(state, narrow.opt, tr.opt)


def test_resize_opt_rebinds_the_plan():
    tr, _, _ = _trained("hier_bucketed")
    for m in (2, 4, 8):
        opt = E.resize_opt(tr.opt, m)
        want = _port_trainer(tr.opt_cfg, m).opt
        assert opt.n == m and opt.layouts == want.layouts
        assert opt.bucket_plan == want.bucket_plan
        assert opt.hierarchy == want.hierarchy


# --------------------------------------------------------------------- #
# reshard_report
# --------------------------------------------------------------------- #

def _bench_rows():
    with open(ROOT / "BENCH_elastic.json") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if r["bench"] == "elastic_reshard"]


BENCH = {r["scenario"]: r for r in _bench_rows()}
_NOT_GEOMETRY = ("bench", "scenario", "arch", "inner", "bucket_mb",
                 "survivors", "reshard_ms")


@pytest.mark.parametrize("scenario", list(BENCH))
def test_report_equals_bench_geometry(scenario):
    row = BENCH[scenario]
    cfg = TA.OptimizerConfig(
        hierarchy=Hierarchy(row["inner"]) if row["inner"] else None,
        bucket_mb=row["bucket_mb"])
    src = _port_trainer(cfg, row["n_from"])
    dst = _port_trainer(cfg, row["n_to"])
    rep = E.reshard_report(src.opt, dst.opt, survivors=row["survivors"])
    assert {k: rep[k] for k in rep} == {
        k: v for k, v in row.items() if k not in _NOT_GEOMETRY}
    assert isinstance(rep["ef_fold"], bool)


@pytest.mark.parametrize("inner,bucket_mb,n,m,survivors", [
    (None, None, 4, 2, (0, 2)), (None, None, 2, 4, None),
    (2, None, 4, 2, (0, 1)), (None, 25.0, 4, 2, (0, 2)),
    (None, 25.0, 4, 3, (0, 1, 3)), (2, 25.0, 4, 4, None)])
def test_report_at_gpt2_full_layouts(inner, bucket_mb, n, m, survivors):
    """Static geometry at gpt2 FULL (no tensor touched): the reference's
    report, and 16 exchange units at every width under 25 MiB buckets."""
    kw = dict(hierarchy=Hierarchy(inner) if inner else None,
              bucket_mb=bucket_mb)
    rkw = dict(hierarchy=RefHierarchy(inner=inner) if inner else None,
               bucket_mb=bucket_mb)
    full, rfull = port_get("gpt2").config, ref_get("gpt2").config
    pt = [_port_trainer(TA.OptimizerConfig(**kw), w, full) for w in (n, m)]
    rt = [RefTrainer(rfull, RefOptimizerConfig(**rkw), n_workers=w)
          for w in (n, m)]
    rep = E.reshard_report(pt[0].opt, pt[1].opt, survivors=survivors)
    want = ref_report(rt[0].opt, rt[1].opt, survivors=survivors)
    assert rep == want
    assert [type(v) for v in rep.values()] == [type(v) for v in want.values()]
    if bucket_mb:
        assert rep["exchange_units"] == 16
        for w in (2, 4) if inner else (2, 3, 4):
            assert len(E.resize_opt(pt[0].opt, w).units) == 16


# --------------------------------------------------------------------- #
# conservation, joiners
# --------------------------------------------------------------------- #

def _ef_mass(err_w, n):
    return [float(e.double().sum()) / n for e in err_w if e is not None]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_shrink_conserves_ef_mass(variant):
    """4 -> 2 with dead entities: (1/m_e) sum(err_w') == (1/n_e) sum(err_w)
    per unit, with some residual nonzero; err_s's true elements move
    positionally."""
    tr, params, state = _trained(variant)
    survivors = (0, 1) if variant.startswith("hier") else (0, 2)
    dst = _port_trainer(tr.opt_cfg, 2)
    _, s2 = E.reshard_trainer(tr, dst, params, state, survivors=survivors)
    rep = E.reshard_report(tr.opt, dst.opt, survivors=survivors)
    np.testing.assert_allclose(
        _ef_mass(s2.err_w, rep["entities_to"]),
        _ef_mass(state.err_w, rep["entities_from"]), rtol=1e-5, atol=1e-7)
    assert any(float(e.abs().sum()) > 0 for e in state.err_w)
    units = [u.layout for u in tr.opt.units]
    for k, (es, es2) in enumerate(zip(state.err_s, s2.err_s)):
        lo_s = units[k]
        lo_d = [u.layout for u in dst.opt.units][k]
        nat = [TC.from_view(PR._take(e, PR._owner_of_rows(lo.n, lo.n_inner)),
                            lo) for e, lo in ((es, lo_s), (es2, lo_d))]
        assert torch.equal(*nat)


def test_grow_zeroes_joiner_u_and_clones_params():
    tr, params, state = _source("flat", "zero_one_adam", 2)
    dst = _port_trainer(tr.opt_cfg, 4)
    p4, s4 = E.reshard_trainer(tr, dst, params, state)
    for x in flatten_tree(p4)[1]:
        assert torch.equal(x[2], x[0]) and torch.equal(x[3], x[0])
    for x in s4.slots["m"]:
        assert torch.equal(x[2], x[0])
    assert all((u[2:] == 0).all() for u in s4.u)
    assert any((u[:2] != 0).any() for u in s4.u)
    np.testing.assert_allclose(_ef_mass(s4.err_w, 4),
                               _ef_mass(state.err_w, 2), rtol=1e-5,
                               atol=1e-7)
    assert s4.step == state.step and s4.sync_pstate == state.sync_pstate
    rep = E.reshard_report(tr.opt, dst.opt)
    assert rep["joiner_workers"] == 2 and rep["ef_fold"] is True


def test_hier_pod_kill_and_rejoin_trains():
    """Kill a whole pod (4 -> 2, inner=2) and rejoin it (2 -> 4): the
    surviving pod's params come back bitwise, and the state trains."""
    tr, params, state = _trained("hier")
    mid = _port_trainer(tr.opt_cfg, 2)
    back = _port_trainer(tr.opt_cfg, 4)
    p4, s4 = E.reshard_trainer(mid, back, *E.reshard_trainer(
        tr, mid, params, state, survivors=(0, 1)))
    for a, b in zip(flatten_tree(params)[1], flatten_tree(p4)[1]):
        assert torch.equal(a[:2], b[:2])
    data = SyntheticLM(DataConfig(vocab=PORT_CFG.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=11))
    _, _, met = back.step(p4, s4, data.batch(0))
    assert np.isfinite(float(met["loss"]))


# --------------------------------------------------------------------- #
# restore_resharded across packages
# --------------------------------------------------------------------- #

META = {"arch": "gpt2-smoke", "n_workers": 4}


def _files(tmp_path):
    """The trained flat state as a reference file and as a port file."""
    tr, params, state = _trained()
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "p.npz")
    rp, rs = _to_reference(params, state)
    ref_io.save(ref_path, {"params": rp, "state": rs}, step=STEPS,
                meta=META)
    tr.save(port_path, params, state, step=STEPS, meta=META)
    return ref_path, port_path


@pytest.mark.parametrize("m,survivors", [(2, (0, 2)), (4, None),
                                         (3, (0, 1, 3))])
def test_restore_resharded_across_packages(m, survivors, tmp_path):
    """Each package's file into each package's trainer of width m: the
    port's restore is bit for bit the reference's."""
    ref_cfg, port_cfg = _cfgs()
    for path in _files(tmp_path):
        p, s, step, meta = E.restore_resharded(
            path, _port_trainer(port_cfg, m), survivors=survivors)
        rp, rs, rstep, rmeta = ref_restore_resharded(
            path, RefTrainer(REF_CFG, ref_cfg, n_workers=m),
            survivors=survivors)
        assert (step, meta) == (rstep, rmeta) == (STEPS, META)
        _assert_bitwise_reference(rp, rs, p, s)


def test_restore_resharded_errors_are_the_references(tmp_path):
    tr, params, state = _trained()
    ref_cfg, port_cfg = _cfgs()
    trainers = (RefTrainer(REF_CFG, ref_cfg, n_workers=2),
                _port_trainer(port_cfg, 2))
    fns = (ref_restore_resharded, E.restore_resharded)
    bare = str(tmp_path / "bare.npz")
    tr.save(bare, params, state, step=STEPS)
    wide = str(tmp_path / "f64.npz")
    tree = tr.checkpoint_tree(dict(params), state)   # the cache's stays
    tree["params"]["embed"] = tree["params"]["embed"].numpy().astype(
        np.float64)
    port_io.save(wide, tree, step=STEPS, meta=META)
    for path, fragment in ((bare, "meta['n_workers']"),
                           (wide, "dtype float64 != expected float32")):
        errs = []
        for fn, t in zip(fns, trainers):
            with pytest.raises(ValueError) as err:
                fn(path, t)
            errs.append(str(err.value))
        assert errs[1] == errs[0] and fragment in errs[0]
    p, s, _, _ = E.restore_resharded(bare, trainers[1], src_workers=4)
    assert s.slots["m"][0].shape[0] == 2


def test_width_mismatch_restore_points_at_the_ports_elastic(tmp_path):
    _, port_path = _files(tmp_path)
    with pytest.raises(ValueError,
                       match=r"n=4.*m=2.*repro_torch\.elastic"):
        _port_trainer(_cfgs()[1], 2).restore(port_path)


# --------------------------------------------------------------------- #
# FleetSim
# --------------------------------------------------------------------- #

def test_fleet_sim_schedule_errors_are_the_references():
    ref_cfg, port_cfg = _cfgs()
    fleets = (RefFleetSim(REF_CFG, ref_cfg, 4),
              E.FleetSim(PORT_CFG, port_cfg, 4, device="cpu"))
    for kw in (dict(events=[(9, 2)]),
               dict(events=[(1, 2), (1, 4)]),
               dict(global_batch=8, events=[(1, 3)])):
        errs = []
        for fleet, ev in zip(fleets, (RefResizeEvent, E.ResizeEvent)):
            with pytest.raises(ValueError) as err:
                fleet.run(4, **{**kw, "events": [ev(*e)
                                                 for e in kw["events"]]})
            errs.append(str(err.value))
        assert errs[1] == errs[0]


def test_fleet_sim_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.FleetSim(PORT_CFG, _cfgs()[1], 4)


class _RefStream:
    """The reference's batches as the port's tensors (the two packages
    draw from different generators; the parity run feeds one stream)."""

    def __init__(self, cfg, device=None):
        self.data = RefSyntheticLM(RefDataConfig(
            vocab=cfg.vocab, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, seed=cfg.seed))

    def batch(self, t):
        return {k: torch.from_numpy(np.array(v)).long()
                for k, v in self.data.batch(t).items()}


def test_fleet_kill_shrink_rejoin_matches_reference(monkeypatch):
    """12 steps, kill workers 1 and 3 at step 4 (4 -> 2, survivors 0 and
    2), rejoin at step 8 (2 -> 4), from the reference's init and batches:
    losses within 1e-4 at every step, params 99% within 1e-4 and all
    within 0.05, the resize reports the reference's.

    At lr 1e-4 (measured on the CPU: at most 2.7e-5 apart, the port's
    own gap from params one ulp up). At the reference test's lr 1e-3 this
    12-step run is chaotic in the last bit with or without resizes:
    the port against itself one ulp up drifts 1.8e-2 in loss by step 12,
    against the reference 2.3e-2 (sign flips of near-zero ``u + err``);
    the reshards themselves are bit for bit (above)."""
    ref_cfg, port_cfg = _cfgs(lr=1e-4)
    events = [(4, 2, (0, 2)), (8, 4)]
    ref = RefFleetSim(REF_CFG, ref_cfg, 4, seed=3).run(
        12, global_batch=BATCH, seq=SEQ,
        events=[RefResizeEvent(*e) for e in events])
    rp0, _ = RefTrainer(REF_CFG, ref_cfg, n_workers=4).sim_init(
        jax.random.PRNGKey(3))
    start = interop.params_from_reference(jax.device_get(rp0))

    def init(self, seed):
        params = jax.tree.map(torch.clone, start)
        return params, self.opt.init(params)

    monkeypatch.setattr(TSTEP.Trainer, "init", init)
    monkeypatch.setattr(TSIM, "SyntheticLM", _RefStream)
    got = E.FleetSim(PORT_CFG, port_cfg, 4, seed=3, device="cpu").run(
        12, global_batch=BATCH, seq=SEQ,
        events=[E.ResizeEvent(*e) for e in events])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=1e-4)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "reshard_ms"}
                        for r in rs]
    assert strip(got["resizes"]) == strip(ref["resizes"])
    assert all(r["reshard_ms"] > 0 for r in got["resizes"])
    assert [r["workers"] for r in got["records"]] == [4] * 4 + [2] * 4 + [
        4] * 4
    assert got["trainer"].n_workers == 4
    diff = np.concatenate([
        np.abs(np.asarray(a) - b.numpy()).ravel()
        for a, b in zip(jax.tree.leaves(ref["params"]),
                        flatten_tree(got["params"])[1])])
    assert diff.size == 4 * 346_880
    assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 0.05
    gap = E.parity_gap(got["losses"], ref["losses"], tail=4)
    assert abs(gap) < 1e-4


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #

ARGV = ["--arch", "gpt2", "--smoke", "--mode", "sim", "--workers", "4",
        "--batch", "8", "--seq", "16", "--sync-warmup", "2",
        "--double-every", "2", "--kappa", "1", "--log-every", "1",
        "--device", "cpu"]


def test_cli_resize_errors_are_the_references(monkeypatch):
    for spec in ("3x2", "3:", "a:b:c"):
        with pytest.raises(SystemExit) as want:
            RLAUNCH._parse_resizes([spec])
        with pytest.raises(SystemExit) as got:
            TLAUNCH.main(ARGV + ["--steps", "4", "--resize", spec])
        assert got.value.code == want.value.code
    argv = ["--arch", "gpt2", "--smoke", "--steps", "2", "--resize", "1:2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(SystemExit) as want:
        RLAUNCH.main()
    with pytest.raises(SystemExit) as got:
        TLAUNCH.main(argv + ["--device", "cpu"])
    assert got.value.code == want.value.code
    assert "--mode sim" in got.value.code


def test_cli_resize_saves_the_final_width(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    TLAUNCH.main(ARGV + ["--steps", "6", "--resize", "3:2", "--resize",
                         "5:4", "--save", path])
    out = capsys.readouterr().out
    assert "resize @ step 3: 4 -> 2 workers (2 EF entities carried, 2 " \
           "folded, fold=True)" in out
    assert "resize @ step 5: 2 -> 4 workers" in out
    assert f"saved checkpoint to {path} (width 4)" in out
    widths = [int(line.split("workers=")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert widths == [4, 4, 4, 2, 2, 4]
    manifest = port_io.read_manifest(path)
    assert manifest["step"] == 6 and manifest["meta"] == {
        "arch": "gpt2-smoke", "n_workers": 4,
        "resizes": [{"step": 3, "n_from": 4, "n_to": 2},
                    {"step": 5, "n_from": 2, "n_to": 4}]}
    args = TLAUNCH.parse_args(ARGV + ["--steps", "6"])
    narrow = TSTEP.Trainer(PORT_CFG, TLAUNCH.build_opt_cfg(args),
                           comm=SimComm(2), device="cpu")
    _, s, step, meta = E.restore_resharded(path, narrow, survivors=(3, 1))
    assert step == 6 and s.slots["m"][0].shape[0] == 2


def test_cli_identity_resize_is_the_plain_run():
    """``--resize 3:4`` at 4 workers: the losses and params of the run
    without it, bit for bit (chip_smoke.py phase 4n(i) at gpt2 FULL)."""
    args = TLAUNCH.parse_args(ARGV + ["--steps", "6"])
    plain = TLAUNCH.train(args, TLAUNCH.make_trainer(args))
    el = TLAUNCH._run_elastic(TLAUNCH.parse_args(
        ARGV + ["--steps", "6", "--resize", "3:4"]))
    assert [r["losses"] for r in el["records"]] == [
        r["losses"] for r in plain["records"]]
    _assert_port_bitwise(plain["params"], el["params"])
    assert [r["sync"] for r in el["records"]] == [
        r["sync"] for r in plain["records"]]
