"""The port's dense error-feedback codecs (topk, qint8, qint4), the codec
registry and its overrides, against the reference, live in one process.

Tolerances, with their reasons:
* every codec's elementwise outputs are bit for bit the reference's as
  XLA compiles them (jax 0.9.0, CPU, under jit, as the trainers run it):
  the payload codes and scales, the decoded values, the EF residuals,
  worker and server side, flat and two-level; so is the whole exchange
  (its mean estimate and both new EF errors). XLA turns qint's divide by
  the constant qmax into a multiply by its f32 reciprocal, contracts the
  residual ``z - q*s`` into one FMA, and fuses the server's decode into
  its mean over the senders (one FMA per sender); the port writes those
  forms out. topk's payload lists its indices in ``jax.lax.top_k``'s
  order (descending magnitude, equal ones lowest index first), so it is
  bit for bit too, ties at the k-th magnitude included;
* ``_hash_dither``: bit for bit over a sweep of f32 bit patterns, the
  uint32 wraparound included;
* ``comm_accounting`` and ``wire_bytes``: equal;
* the gpt2-smoke trainers: topk at the slice's bars (step losses within
  1e-4, params 99% within 1e-4, all within 0.05). qint8 and qint4 dither
  from a hash of each value's bits, so a trajectory is chaotic in the
  last bit of its inputs: the reference itself, started from params one
  ulp away, moves by 2.3e-3 (qint8) and 8.0e-2 (qint4) in loss within 8
  steps. Their trainer test measures that spread live and holds the
  port's loss and param gaps to three times it (the forward and
  backward passes of the two packages differ by ~5e-7 on the logits).
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get as ref_get
from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import build_optimizer as ref_build
from repro.core import codecs as RCD
from repro.core import compressor as RC
from repro.core import onebit_allreduce as RAR
from repro.core import schedules as RS
from repro.core.api import comm_accounting as ref_accounting
from repro.core.comm import Comm as RefComm
from repro.core.comm import Hierarchy as RefHierarchy
from repro.core.comm import sim_comm
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.train import Trainer as RefTrainer

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.core import api as TA
from repro_torch.core import codecs as TCD
from repro_torch.core import compressed as TC_DP
from repro_torch.core import compressor as TC
from repro_torch.core import onebit_allreduce as TAR
from repro_torch.core import schedules as TS
from repro_torch.core.comm import Hierarchy, SimComm
from repro_torch.core.compressed import comm_accounting
from repro_torch.core.leafwise import flatten_tree
from repro_torch.launch import train as TLAUNCH
from repro_torch.train import step as TSTEP

# one intra-op thread: the inputs are small, and the suite runs several
# pytest-xdist workers per machine
torch.set_num_threads(1)

N = 4
DENSE = {"topk": 0.1, "qint8": None, "qint4": None}   # codec -> codec_arg
# (shape, tensor-parallel spec entries): flatten padded, flatten exact,
# rows padded, 3-D rows
CASES = [((37,), None), ((1000,), None), ((13, 40), (None, "model")),
         ((6, 4, 24), (None, None, "model"))]
IDS = ["flat37", "flat1000", "rows13x40", "rows6x4x24"]


def _layouts(shape, spec, n=N, ni=1):
    return (RC.make_layout(shape, None if spec is None else P(*spec), n,
                           n_inner=ni),
            TC.make_layout(shape, spec, n, n_inner=ni))


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mask(lo_r):
    m = RC.pad_mask(lo_r)
    return 1.0 if m is None else np.asarray(m)


def _codecs(name):
    return RCD.make_codec(name, DENSE[name]), TCD.make_codec(name,
                                                              DENSE[name])


def _no_tie_at_k(z, lo, codec):
    """No two magnitudes equal at the k-th largest of any chunk, except
    zeros (padding, whose choice moves no value): what is selected is
    unique."""
    zf = np.abs(np.asarray(z)).reshape(-1, int(np.prod(lo.chunk_shape)))
    k = codec.k_for(lo)
    srt = -np.sort(-zf, axis=1)
    if k < zf.shape[1]:
        assert ((srt[:, k - 1] > srt[:, k]) | (srt[:, k - 1] == 0)).all()


# --- registry, dither -----------------------------------------------------

def test_codec_names_and_args_equal_reference():
    assert TCD.CODEC_NAMES == RCD.CODEC_NAMES
    assert TCD.CODEC_ARGS == RCD.CODEC_ARGS
    for name in TCD.CODEC_NAMES:
        assert TCD.make_codec(name).name == RCD.make_codec(name).name
    assert TCD.make_codec("topk").density == 0.01
    assert TCD.make_codec("topk", 0.25).density == 0.25
    assert TCD.make_codec(TCD.TopKCodec(), 0.5).density == 0.5
    q = TCD.make_codec("qint4")
    assert TCD.make_codec(q) is q and q.qmax == 7
    assert TCD.make_codec("qint8").qmax == 127


@pytest.mark.parametrize("spec,arg", [
    ("top_k", None), ("qint8", 3), ("sign1bit", 0.5), ("identity", 1.0),
    (7, None), ("topk", 1.5), ("topk", 0.0), ("topk", -0.1)],
    ids=["unknown", "qint8-arg", "sign1bit-arg", "identity-arg",
         "not-a-name", "density>1", "density0", "density<0"])
def test_make_codec_errors_equal_reference(spec, arg):
    with pytest.raises(ValueError) as ref:
        RCD.make_codec(spec, arg)
    with pytest.raises(ValueError) as port:
        TCD.make_codec(spec, arg)
    assert str(port.value) == str(ref.value)


def test_make_codec_instance_arg_errors_equal_reference():
    with pytest.raises(ValueError) as ref:
        RCD.make_codec(RCD.Sign1BitCodec(), 0.5)
    with pytest.raises(ValueError) as port:
        TCD.make_codec(TCD.Sign1BitCodec(), 0.5)
    assert str(port.value) == str(ref.value)
    for bits in (3, 16):
        with pytest.raises(ValueError) as ref:
            RCD.QIntCodec(bits=bits)
        with pytest.raises(ValueError) as port:
            TCD.QIntCodec(bits=bits)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("codec", [None, "sign1bit", "topk", "qint8",
                                   "identity", "sign1bit-instance",
                                   "topk-instance"])
@pytest.mark.parametrize("quantize", [True, False])
def test_resolve_with_quantize_matches_reference(codec, quantize):
    def mk(mod):
        if codec == "sign1bit-instance":
            return mod.Sign1BitCodec()
        if codec == "topk-instance":
            return mod.TopKCodec(0.2)
        return codec

    got = TCD.resolve_with_quantize(mk(TCD), quantize)
    want = RCD.resolve_with_quantize(mk(RCD), quantize)
    assert getattr(got, "name", got) == getattr(want, "name", want)
    assert isinstance(got, str) == isinstance(want, str)


def test_hash_dither_bitwise():
    """The uint32 hash over a sweep of bit patterns: every pattern whose
    product with 2654435761 overflows int64 (>= 0xCF1BBCE7: negative f32
    of magnitude >= ~2**31), +-0, subnormals, +-inf, NaNs, the extremes
    of each exponent range, and 2**20 random patterns."""
    special = np.array([0, 0x80000000, 1, 0x807FFFFF, 0x80000001,
                        0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0x7F800000,
                        0xFF800000, 0x7FC00000, 0xFFC00000, 0x3F800000,
                        0xBF800000, 0xCF1BBCE6, 0xCF1BBCE7, 0xCF1BBCE8,
                        0xDEADBEEF, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        special, np.arange(0xCF1BBCE7, 0xCF1BBCE7 + 4096, dtype=np.uint32),
        np.arange(0xFFFFF000, 0xFFFFFFFF, dtype=np.uint32),
        rng.integers(0, 2 ** 32, 2 ** 20, dtype=np.uint64).astype(
            np.uint32)])
    x = bits.view(np.float32)
    want = np.asarray(jax.jit(RCD._hash_dither)(jnp.asarray(x)))
    got = TCD._hash_dither(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == 0.0 and got.max() < 1.0 and got.min() >= 0.0


# --- encode / decode / wire bytes ------------------------------------------

@pytest.mark.parametrize("name", list(DENSE))
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_dense_codec_worker_and_server_match_reference(name, shape, spec):
    """The worker pass over stacked views (z + err, padded positions
    masked), the decode of its payload, the server pass over the chunk
    each worker serves, and wire_bytes: bit for bit, under jit."""
    lo_r, lo_t = _layouts(shape, spec)
    rc, tc = _codecs(name)
    m = _mask(lo_r)
    z = _normal(1, (N,) + lo_r.view_shape) * m
    e = _normal(2, (N,) + lo_r.view_shape, 0.3) * m
    m_r = RC.pad_mask(lo_r)
    if name == "topk":
        _no_tie_at_k(z + e, lo_r, rc)
    rp, re = jax.jit(jax.vmap(lambda a, b: rc.encode_worker(
        a, b, lo_r, "tensor", m_r)))(jnp.asarray(z), jnp.asarray(e))
    tp, te = tc.encode_worker(_t(z), _t(e), lo_t, "tensor")
    assert sorted(tp) == sorted(rp)
    for k in tp:
        assert tp[k].shape == rp[k].shape
        assert str(tp[k].dtype).split(".")[-1] == str(rp[k].dtype)
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    rd = jax.jit(jax.vmap(lambda p: rc.decode(p, lo_r)))(rp)
    np.testing.assert_array_equal(tc.decode(tp, lo_t).numpy(),
                                  np.asarray(rd))
    for k in tp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(rp[k]))

    # server side: worker w serves chunk w
    avg = _normal(3, (N,) + lo_r.chunk_shape) * m   # chunk w: mask m[w]
    es = _normal(4, (N,) + lo_r.chunk_shape, 0.1) * m
    rps, res = jax.jit(jax.vmap(lambda a, b, w: rc.encode_server(
        a, b, lo_r, "tensor", None if m_r is None else m_r[w][None], w)))(
            jnp.asarray(avg), jnp.asarray(es), jnp.arange(N))
    tps, tes = tc.encode_server(_t(avg), _t(es), lo_t, "tensor",
                                np.arange(N))
    np.testing.assert_array_equal(tes.numpy(), np.asarray(res))
    for k in tps:
        np.testing.assert_array_equal(tps[k].numpy(), np.asarray(rps[k]))
    rds = jax.jit(jax.vmap(lambda p: rc.decode(p, lo_r)))(rps)
    np.testing.assert_array_equal(tc.decode(tps, lo_t).numpy(),
                                  np.asarray(rds))
    for mode in ("tensor", "chunk", "row"):
        assert tc.wire_bytes(lo_t, mode) == rc.wire_bytes(lo_r, mode)


@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_topk_ties_select_as_reference(shape, spec):
    """Values on a coarse grid, so that many magnitudes tie at the k-th
    largest of a chunk (as after the two-level exchange's bf16 phases):
    the port selects what ``jax.lax.top_k`` selects (equal values lowest
    index first), in its order, so the payload, the decoded buffer and
    the residual are bit for bit the reference's."""
    lo_r, lo_t = _layouts(shape, spec)
    rc, tc = _codecs("topk")
    m = _mask(lo_r)
    z = np.round(_normal(7, (N,) + lo_r.view_shape) * 2) / 2 * m
    e = np.zeros_like(z)
    rp, re = jax.jit(jax.vmap(lambda a, b: rc.encode_worker(
        a, b, lo_r, "tensor", RC.pad_mask(lo_r))))(jnp.asarray(z),
                                                   jnp.asarray(e))
    tp, te = tc.encode_worker(_t(z), _t(e), lo_t, "tensor")
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    np.testing.assert_array_equal(
        tc.decode(tp, lo_t).numpy(),
        np.asarray(jax.vmap(lambda p: rc.decode(p, lo_r))(rp)))
    for k in tp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(rp[k]))


def _run_ref_exchange(z, ef, lo, cfg, ni):
    """The reference's Algorithm 2 over N vmapped workers (pods of ``ni``
    under a nested vmap when ``ni`` > 1), jitted."""
    if ni == 1:
        f = jax.jit(jax.vmap(lambda v, e: RAR.onebit_allreduce_view(
            sim_comm("w"), v, e, lo, cfg), axis_name="w"))
        return f(jnp.asarray(z), ef)
    comm = RefComm(("pod", "data"))
    fold = lambda a: a.reshape((N // ni, ni) + a.shape[1:])   # noqa: E731
    unfold = lambda a: a.reshape((N,) + a.shape[2:])          # noqa: E731
    f = jax.jit(jax.vmap(jax.vmap(
        lambda v, e: RAR.onebit_allreduce_view(comm, v, e, lo, cfg),
        axis_name="data"), axis_name="pod"))
    return jax.tree.map(unfold, f(fold(jnp.asarray(z)),
                                  jax.tree.map(fold, ef)))


@pytest.mark.parametrize("ni", [1, 2], ids=["flat", "2x2"])
@pytest.mark.parametrize("name", list(DENSE))
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_dense_codec_exchange_matches_reference(name, shape, spec, ni):
    """Algorithm 2 over each dense codec, flat and at 2 pods x 2, two
    rounds from random EF state carried through: the mean estimate and
    both new EF errors bit for bit; every worker holds the same
    estimate."""
    lo_r, lo_t = _layouts(shape, spec, N, ni)
    m = _mask(lo_r)
    j, k = np.arange(N) % ni, np.arange(N) // ni
    no = lo_r.n_outer
    ms = m if np.ndim(m) == 0 else m.reshape((ni, no) + m.shape[1:])[j]
    serve = m if np.ndim(m) == 0 else m[j * no + k]
    ef = RAR.EFState(
        jnp.asarray(_normal(5, (N,) + lo_r.ef_worker_shape, 0.3) * ms),
        jnp.asarray(_normal(6, (N,) + lo_r.chunk_shape, 0.1) * serve))
    hier_r = RefHierarchy(inner=ni) if ni > 1 else None
    cfg_r = RAR.OneBitConfig(codec=RCD.make_codec(name, DENSE[name]),
                             hierarchy=hier_r)
    cfg_t = TAR.OneBitConfig(codec=name, codec_arg=DENSE[name],
                             hierarchy=Hierarchy(ni) if ni > 1 else None)
    for r in range(2):
        z = _normal(10 + r, (N,) + lo_r.view_shape) * m
        out_r, ef_r = _run_ref_exchange(z, ef, lo_r, cfg_r, ni)
        out_t, ef_t = TAR.onebit_allreduce_view(
            SimComm(N), _t(z), TAR.EFState(*(_t(a) for a in ef)), lo_t,
            cfg_t)
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_r))
        for got, want in zip(ef_t, ef_r):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (out_t == out_t[:1]).all()
        ef = ef_r


# --- optimizer-level: overrides, accounting ---------------------------------

SHAPES = {"w": (6, 16), "b": (5,), "s": (13, 40)}


def _ref_params():
    return {k: jnp.zeros(s) for k, s in SHAPES.items()}


def test_codec_name_and_arg_validated_as_reference():
    for kw in ({"codec": "top_k"}, {"codec": "qint8", "codec_arg": 3}):
        with pytest.raises(ValueError) as ref:
            RefOptimizerConfig(name="zero_one_adam", **kw)
        with pytest.raises(ValueError) as port:
            TA.OptimizerConfig(name="zero_one_adam", **kw)
        assert str(port.value) == str(ref.value)


def test_quantize_false_deprecation_shim():
    with pytest.warns(DeprecationWarning, match="identity") as rec:
        opt = TA.build_optimizer(
            TA.OptimizerConfig(name="zero_one_adam", quantize=False),
            SHAPES, n_workers=N)
    assert opt.codec.name == "identity"
    with pytest.warns(DeprecationWarning) as ref_rec:
        ref_build(RefOptimizerConfig(name="zero_one_adam", quantize=False),
                  _ref_params(), n_workers=N)
    assert ([str(w.message) for w in rec]
            == [str(w.message) for w in ref_rec])
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        opt = TA.build_optimizer(TA.OptimizerConfig(name="zero_one_adam"),
                                 SHAPES, n_workers=N)   # default: silent
    assert opt.codec.name == "sign1bit"


def test_explicit_codec_wins_over_deprecated_quantize_false():
    """quantize=False rewrites only the default codec; an explicit codec,
    and any build_optimizer override, wins (as the reference's)."""
    cases = [
        (dict(quantize=False), dict(codec="qint8"), "qint8"),
        (dict(quantize=False, codec="topk", codec_arg=0.1), {}, "topk"),
        (dict(quantize=False), dict(codec="sign1bit"), "sign1bit"),
        (dict(quantize=False, codec="sign1bit-instance"), {}, "identity")]
    for fields, over, want in cases:
        fields = dict(fields)
        inst = fields.get("codec") == "sign1bit-instance"
        for mod, cfg_cls, build, params in (
                (TCD, TA.OptimizerConfig, TA.build_optimizer, SHAPES),
                (RCD, RefOptimizerConfig, ref_build, _ref_params())):
            if inst:
                fields["codec"] = mod.Sign1BitCodec()
            with pytest.warns(DeprecationWarning):
                opt = build(cfg_cls(name="zero_one_adam", **fields), params,
                            n_workers=N, **over)
            assert opt.codec.name == want, (fields, over)
            if want == "topk":
                assert opt.codec.density == 0.1


def test_codec_arg_only_override_reparameterizes():
    """A codec_arg alone re-parameterizes the configured codec; the same
    codec name keeps the stored arg; another codec resets it; an
    instance plus an arg is re-made with the arg (reference
    tests/test_codecs.py)."""
    cfg = TA.OptimizerConfig(name="zero_one_adam", codec="topk",
                             codec_arg=0.5)
    b = TA.build_optimizer
    assert b(cfg, SHAPES, n_workers=N, codec_arg=0.25).codec.density == 0.25
    assert b(cfg, SHAPES, n_workers=N, codec="topk").codec.density == 0.5
    assert b(cfg, SHAPES, n_workers=N, codec="qint4").codec.name == "qint4"
    tr = TC_DP.compressed_dp(TA.adam_base(), codec="topk", codec_arg=0.2)
    assert b(tr, SHAPES, n_workers=N, codec_arg=0.4).codec.density == 0.4
    assert b(tr, SHAPES, n_workers=N, codec="topk").codec.density == 0.2
    tr = TC_DP.compressed_dp(TA.adam_base(), codec=TCD.TopKCodec(),
                             codec_arg=0.5)
    assert b(tr, SHAPES, n_workers=N).codec.density == 0.5
    opt = b(TA.OptimizerConfig(name="zero_one_adam"), SHAPES, n_workers=N,
            codec="topk", codec_arg=0.05)
    assert opt.codec.name == "topk" and opt.codec.density == 0.05
    opt = b(TC_DP.compressed_dp(TA.adam_base(), codec="qint4"), SHAPES,
            n_workers=N)
    assert comm_accounting(opt)["codec"] == "qint4"


ACCT_SHAPES = {"w": (6, 16), "b": (5,), "deep": {"k": (3, 8, 8)},
               "s": (13, 40), "t": (6, 4, 24)}
ACCT_REF_SPECS = {"w": None, "b": None, "deep": {"k": None},
                  "s": P(None, "model"), "t": P(None, None, "model")}
ACCT_PORT_SPECS = {"w": None, "b": None, "deep": {"k": None},
                   "s": (None, "model"), "t": (None, None, "model")}


@pytest.mark.parametrize("topology", ["flat", "2x2", "bucketed"])
@pytest.mark.parametrize("codec", list(TCD.CODEC_NAMES))
def test_comm_accounting_per_codec_equals_reference(codec, topology):
    arg = 0.05 if codec == "topk" else None
    kw = {"flat": ({}, {}),
          "2x2": (dict(hierarchy=Hierarchy(2)),
                  dict(hierarchy=RefHierarchy(inner=2))),
          "bucketed": (dict(bucket_mb=0.001), dict(bucket_mb=0.001))}[
              topology]
    for name in ("zero_one_adam", "one_bit_lamb"):
        port = TA.build_optimizer(
            TA.OptimizerConfig(name=name, codec=codec, codec_arg=arg,
                               **kw[0]),
            ACCT_SHAPES, specs=ACCT_PORT_SPECS, n_workers=N)
        ref = ref_build(
            RefOptimizerConfig(name=name, codec=codec, codec_arg=arg,
                               **kw[1]),
            jax.tree.map(jnp.zeros, ACCT_SHAPES,
                         is_leaf=lambda x: isinstance(x, tuple)),
            specs=ACCT_REF_SPECS, n_workers=N)
        assert comm_accounting(port) == ref_accounting(ref), (name, codec)


# --- trainers, CLI ----------------------------------------------------------

def _port_batch(b):
    return {k: torch.from_numpy(np.array(v)) if k == "loss_mask"
            else torch.from_numpy(np.array(v)).long() for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _ref_trainer(codec):
    """The reference's gpt2-smoke sim trainer over ``codec`` and its
    jitted step, made once per codec: the run from the reference's draw
    and the run from params one ulp up share the step's compilation."""
    arg = 0.05 if codec == "topk" else None
    ref_cfg = RefOptimizerConfig(
        lr=RS.ConstantLr(1e-3), var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2), name="zero_one_adam",
        codec=codec, codec_arg=arg)
    rt = RefTrainer(ref_get("gpt2").smoke, ref_cfg, n_workers=N)
    return rt, rt.sim_step_fn()


def _smoke_run(codec, nudge=False, port=False):
    """8 steps of the gpt2-smoke zero_one_adam trainer over ``codec``
    (syncs at 0-4 and 6) from the reference's draw (each param one ulp
    up with ``nudge``), on the reference's batches: the per-step losses
    and the final params (numpy), of the reference, or with ``port`` of
    the port's trainer."""
    arg = 0.05 if codec == "topk" else None
    kw = dict(name="zero_one_adam", codec=codec, codec_arg=arg)
    rt, step = _ref_trainer(codec)
    rp, rs = rt.sim_init(jax.random.PRNGKey(0))
    if nudge:
        rp = jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf), rp)
    data = RefSyntheticLM(RefDataConfig(vocab=512, seq_len=32,
                                        global_batch=8, seed=0))
    losses = []
    if port:
        pt = TSTEP.Trainer(port_get("gpt2").smoke, TA.OptimizerConfig(
            lr=TS.ConstantLr(1e-3),
            var_policy=TS.AdaptiveFreezePolicy(kappa=1),
            sync_policy=TS.LrProportionalSyncPolicy(2, 2), **kw),
            comm=SimComm(N), device="cpu")
        tp = interop.params_from_reference(jax.device_get(rp))
        ts = interop.state_from_reference(jax.device_get(rs), pt.opt)
        for t in range(8):
            tp, ts, tm = pt.step(tp, ts, _port_batch(data.batch(t)))
            losses.append(float(tm["loss"]))
        return np.array(losses), [a.numpy() for a in flatten_tree(tp)[1]]
    for t in range(8):
        rp, rs, rm = step(rp, rs, data.batch(t))
        losses.append(float(rm["loss"][0]))
    return np.array(losses), [np.asarray(a) for a in jax.tree.leaves(rp)]


@pytest.mark.parametrize("codec", ["topk", "qint8", "qint4"])
def test_gpt2_smoke_trainer_per_codec_matches_reference(codec):
    """The gpt2-smoke trainer over each dense codec (topk at density
    0.05) against the reference's sim trainer, from its draw on its
    batches. topk at the slice's bars (measured worst loss gap 4.8e-7,
    all params within 6.9e-5). qint8/qint4: the loss gap and the largest
    param gap each at most three times the reference's own to its run
    from params one ulp up (measured here: loss gaps 1.19e-3 / 8.98e-2
    against the reference's own 2.33e-3 / 8.01e-2; param gaps 4.6e-3 /
    7.1e-2 against 4.7e-3 / 7.0e-2)."""
    ref_l, ref_p = _smoke_run(codec)
    got_l, got_p = _smoke_run(codec, port=True)
    assert np.isfinite(got_l).all()
    gap = np.abs(got_l - ref_l).max()
    diff = np.concatenate([np.abs(a - b).ravel()
                           for a, b in zip(got_p, ref_p)])
    assert diff.size == N * 346_880
    if codec == "topk":
        assert gap < 1e-4
        assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 0.05
        return
    own_l, own_p = _smoke_run(codec, nudge=True)
    own = np.abs(own_l - ref_l).max()
    pown = max(np.abs(a - b).max() for a, b in zip(own_p, ref_p))
    print(codec, "port gap", gap, "reference's own spread", own,
          "max param gap", diff.max(), "against", pown)
    assert 0 < own and gap <= 3 * own
    assert diff.max() <= 3 * pown


@pytest.mark.parametrize("mode", ["sim", "single"])
@pytest.mark.parametrize("extra", [["--codec", "topk", "--codec-arg",
                                    "0.05"], ["--codec", "qint8"],
                                   ["--codec", "qint4"]],
                         ids=["topk", "qint8", "qint4"])
def test_cli_runs_codecs_on_cpu(capsys, extra, mode):
    TLAUNCH.main(["--arch", "gpt2", "--smoke", "--mode", mode, "--steps",
                  "3", "--batch", "4", "--seq", "16", "--sync-warmup", "1",
                  "--double-every", "1", "--kappa", "1", "--log-every", "1",
                  "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert f"codec={extra[1]}" in out and "DONE: 3 steps" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_cli_codec_arg_reaches_the_codec():
    args = TLAUNCH.parse_args(["--arch", "gpt2", "--codec", "topk",
                               "--codec-arg", "0.25"])
    assert TLAUNCH.build_opt_cfg(args).codec_arg == 0.25
    opt = TA.build_optimizer(TLAUNCH.build_opt_cfg(args), SHAPES,
                             n_workers=N)
    assert opt.codec.density == 0.25
    with pytest.raises(ValueError, match="takes no codec_arg"):
        TLAUNCH.build_opt_cfg(TLAUNCH.parse_args(
            ["--arch", "gpt2", "--codec", "qint8", "--codec-arg", "2"]))
