"""The port's optimizer-state registry (``ComposedOptimizer.state_kinds``)
and the state's dtypes against the reference, live in one process.

``state_kinds()`` is held tag for tag to the reference's
``ComposedOptimizer.state_kinds`` over every registry name, per leaf and
bucketed, with and without the anchor, and with a leaf outside data
parallelism (an expert-parallel leaf: natural-shape slots, no ``u``, EF
state or anchor): the same ``None`` placements, the same ``(tag,
leaf)`` everywhere. Each tag also names the shape the port's ``init``
gives that leaf. At ``state_dtype`` f32 and bf16 every state leaf's dtype
equals the reference's (``jax.eval_shape`` of its ``init``): the views,
``u`` and the EF state in the state dtype, the scalar slots (LAMB's
trust) f32, the anchor in the parameters' dtype. Exact equality
throughout: these are structure, not arithmetic.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import OptimizerConfig as RefOptimizerConfig
from repro.core import build_optimizer as ref_build
from repro.core import schedules as RS

from repro_torch.core import api as TA
from repro_torch.core import compressed as TC
from repro_torch.core import schedules as TS

torch.set_num_threads(1)

N = 4
SHAPES = {"w": (6, 16), "b": (5,), "deep": {"k": (3, 8, 8)},
          "s": (13, 40), "t": (6, 4, 24)}
REF_SPECS = {"w": None, "b": None, "deep": {"k": None},
             "s": P(None, "model"), "t": P(None, None, "model")}
PORT_SPECS = {"w": None, "b": None, "deep": {"k": None},
              "s": (None, "model"), "t": (None, None, "model")}
# "deep/k" outside data parallelism, as an expert leaf
DP_MASK = {"w": True, "b": True, "deep": {"k": False}, "s": True,
           "t": True}
CASES = [(name, bucket, anchor)
         for name in TA.REGISTRY_NAMES
         for bucket in (None, 0.001)
         for anchor in (True, False)
         if not (name == "zero_one_lamb" and not anchor)]


def _map(f, t):
    return {k: _map(f, v) if isinstance(v, dict) else f(v)
            for k, v in t.items()}


def _opts(name, bucket, anchor, dp_mask=None, sd="f32", param_dtype="f32"):
    jsd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[sd]
    tsd = {"f32": torch.float32, "bf16": torch.bfloat16}[sd]
    kw = dict(name=name, onebit_warmup=2, store_anchor=anchor,
              bucket_mb=bucket)
    ref_cfg = RefOptimizerConfig(
        lr=RS.ConstantLr(1e-2), var_policy=RS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=RS.LrProportionalSyncPolicy(2, 2), state_dtype=jsd, **kw)
    port_cfg = TA.OptimizerConfig(
        lr=TS.ConstantLr(1e-2), var_policy=TS.AdaptiveFreezePolicy(kappa=1),
        sync_policy=TS.LrProportionalSyncPolicy(2, 2), state_dtype=tsd,
        **kw)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[param_dtype]
    ref = ref_build(ref_cfg, _map(lambda s: jnp.zeros(s, jdt), SHAPES),
                    specs=REF_SPECS, dp_mask=dp_mask, n_workers=N)
    port = TA.build_optimizer(port_cfg, SHAPES, specs=PORT_SPECS,
                              dp_mask=dp_mask, n_workers=N)
    return ref, port


def _kind(k):
    return None if k is None else (k.tag, k.leaf)


FIELDS = ("u", "err_w", "err_s", "anchor")


@pytest.mark.parametrize("dp_mask", [None, DP_MASK], ids=["all_dp", "ep"])
@pytest.mark.parametrize("name,bucket,anchor", CASES)
def test_state_kinds_equal_reference(name, bucket, anchor, dp_mask):
    ref, port = _opts(name, bucket, anchor, dp_mask)
    rk, pk = ref.state_kinds(), port.state_kinds()
    for f in ("step", "gamma_acc"):
        assert _kind(getattr(pk, f)) == _kind(getattr(rk, f)) == (
            "scalar", None)
    for f in ("sync_pstate", "var_pstate"):
        assert [_kind(k) for k in getattr(pk, f)] == [
            _kind(k) for k in getattr(rk, f)]
    assert sorted(pk.slots) == sorted(rk.slots)
    for s in rk.slots:
        assert [_kind(k) for k in pk.slots[s]] == [
            _kind(k) for k in rk.slots[s]], s
    for f in FIELDS:
        assert [_kind(k) for k in getattr(pk, f)] == [
            _kind(k) for k in getattr(rk, f)], f
    assert all(isinstance(k, TC.StateKind) for f in FIELDS
               for k in getattr(pk, f) if k is not None)
    assert TC.StateKind("bucket_chunk", 0).bucketed
    assert not TC.StateKind("chunk", 0).bucketed


def _want_shape(port, kind, x_shape):
    """The shape (without the stack) a state leaf of ``kind`` has."""
    tag, i = kind
    if tag == "leaf_scalar":
        return ()
    if tag in ("bucket_view", "bucket_chunk"):
        lo = port.bucket_plan.buckets[i].layout
        return lo.view_shape if tag == "bucket_view" else lo.chunk_shape
    lo = port.layouts[i]
    if tag == "view":
        return lo.view_shape if port.dp[i] else tuple(x_shape[i][1:])
    if tag == "chunk":
        return lo.chunk_shape
    assert tag == "natural"
    return tuple(x_shape[i][1:])


@pytest.mark.parametrize("dp_mask", [None, DP_MASK], ids=["all_dp", "ep"])
@pytest.mark.parametrize("name,bucket,anchor", [
    ("zero_one_adam", None, True), ("zero_one_adam", 0.001, False),
    ("zero_one_lamb", 0.001, True), ("one_bit_lamb", None, True),
    ("momentum_sgd", 0.001, True)])
def test_state_kinds_name_the_shapes_of_init(name, bucket, anchor, dp_mask):
    """Each tag gives the shape ``init`` gives its leaf, and ``None``
    stands exactly where ``init`` holds ``None``."""
    _, port = _opts(name, bucket, anchor, dp_mask)
    x = _map(lambda s: torch.zeros((N,) + s), SHAPES)
    st, kinds = port.init(x), port.state_kinds()
    xs = [tuple(t.shape) for t in port.plan.flat(x)]
    pairs = [(a, k) for f in FIELDS
             for a, k in zip(getattr(st, f), getattr(kinds, f))]
    pairs += [(a, k) for s in st.slots
              for a, k in zip(st.slots[s], kinds.slots[s])]
    for a, k in pairs:
        assert (a is None) == (k is None)
        if a is not None:
            assert tuple(a.shape) == (N,) + tuple(
                _want_shape(port, _kind(k), xs)), (_kind(k), a.shape)


def _dtype_name(x):
    return None if x is None else str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sd", ["f32", "bf16"])
@pytest.mark.parametrize("name,bucket,anchor", [
    ("zero_one_adam", None, True), ("zero_one_adam", 0.001, False),
    ("zero_one_lamb", None, True), ("zero_one_sgd", 0.001, True),
    ("one_bit_adam", None, True), ("adam", 0.001, True)])
def test_state_dtypes_equal_reference(name, bucket, anchor, sd,
                                      param_dtype):
    """Every state leaf's dtype is the reference's ``init``'s, at either
    state dtype and parameter dtype (an expert leaf included)."""
    ref, port = _opts(name, bucket, anchor, DP_MASK, sd, param_dtype)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[param_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[param_dtype]
    rs = jax.eval_shape(lambda: ref.init(_map(lambda s: jnp.zeros(s, jdt),
                                              SHAPES)))
    ps = port.init(_map(lambda s: torch.zeros((N,) + s, dtype=tdt), SHAPES))
    for f in FIELDS:
        assert [_dtype_name(a) for a in getattr(ps, f)] == [
            _dtype_name(a) for a in getattr(rs, f)], f
    for s in rs.slots:
        assert [_dtype_name(a) for a in ps.slots[s]] == [
            _dtype_name(a) for a in rs.slots[s]], s
    want = {"f32": "float32", "bf16": "bfloat16"}[sd]
    assert {_dtype_name(a) for a in ps.slots["m"]} == {want}
    if "trust" in ps.slots:
        assert {_dtype_name(a) for a in ps.slots["trust"]} - {None} == {
            "float32"}


def test_unsupported_state_dtype_raises():
    with pytest.raises(ValueError, match="state_dtype"):
        TA.build_optimizer(TA.OptimizerConfig(state_dtype=torch.float16),
                           SHAPES, n_workers=N)
