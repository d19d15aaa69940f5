"""The port's weight publishing (``repro_torch.serve.publish``) against
the reference's, live in one process: the cases of
``tests/test_publish.py`` run on the port, each held to the reference on
the same inputs, plus payload parity, the ``BENCH_serve.json`` byte
counts, and updates carried across the two packages in both directions.

Tolerances, with their reasons:
* manifests, payload shapes and dtypes, byte counts: equal;
* identity, topk, qint8 and qint4 payloads, anchors and applied params:
  bit for bit the reference's (the qint codecs' XLA forms are the ones
  ``tests/test_torch_codecs.py`` pins; topk payloads list indices in
  ``jax.lax.top_k``'s order);
* sign1bit: the packed bytes are bit for bit; each chunk scale is an
  L1 mean whose sum XLA and torch take in different orders, measured 2-4
  ulp apart at gpt2-smoke (held to 8 ulp), so an anchor, advanced by
  ``±scale`` at each delta, is held after ``t`` deltas to ``t`` times
  (8 ulp of the largest scale plus 2 ulp of its own value: the add's
  rounding, where the sum may cross into the next binade), measured at
  most 3 ulp of the anchor after 2 deltas;
* the delta error bounds of the reference's own test (qint8 2e-3, qint4
  2e-2), and no growth from the first delta to the last.

Inputs are numpy draws from fixed seeds; the gpt2-smoke params come from
the reference's init through ``repro_torch.interop``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import transformer as RT
from repro.models.layers import abstract_params as ref_abstract_params
from repro.models.layers import init_params as ref_init
from repro.serve import publish as RP

from repro_torch import interop
from repro_torch.configs.base import get as port_get
from repro_torch.serve import (Publisher, PublishConfig, Subscriber,
                               load_update, save_update)
from repro_torch.serve.publish import _PER_LEAF_MB

# one intra-op thread: the inputs are small, and the suite runs several
# pytest-xdist workers per machine
torch.set_num_threads(1)

CODECS = ("sign1bit", "topk", "qint8", "qint4", "identity")
SIGN_SCALE_ULPS = 8


def small_tree(seed=0):
    """The reference test's tree shapes, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((64, 16)).astype(np.float32),
            "w": rng.standard_normal((37, 8)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def perturb(tree, seed, scale=1e-3):
    rng = np.random.default_rng(1000 + seed)

    def f(node):
        if isinstance(node, dict):
            return {k: f(node[k]) for k in sorted(node)}
        noise = rng.standard_normal(node.shape).astype(np.float32)
        return (node + np.float32(scale) * noise).astype(np.float32)
    return f(tree)


def port(tree):
    return interop.params_from_reference(tree)


def ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy() if isinstance(t, torch.Tensor)
                     else t, tree))]


def assert_bitwise(got, want):
    for a, b in zip(leaves_np(got), leaves_np(want)):
        np.testing.assert_array_equal(a, b)


def max_err(got, want):
    return max(float(np.abs(a - b).max())
               for a, b in zip(leaves_np(got), leaves_np(want)))


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def gpt2_smoke_params():
    cfg = ref_get("gpt2").smoke
    return jax.device_get(ref_init(RT.model_template(cfg),
                                   jax.random.PRNGKey(0)))


def assert_payloads_match(ru, tu, codec):
    """The port's update against the reference's, under the bars of the
    module docstring."""
    assert tu.manifest == ru.manifest
    assert len(tu.payloads) == len(ru.payloads)
    for a, b in zip(ru.payloads, tu.payloads):
        assert sorted(a) == sorted(b)
        for k in a:
            assert (b[k].shape, b[k].dtype) == (a[k].shape, a[k].dtype), k
            if codec == "sign1bit" and k == "scales":
                assert ulps(b[k], a[k]) <= SIGN_SCALE_ULPS
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def assert_sign_close(got, want, scales, n_deltas):
    """The sign1bit bar of the module docstring, leaf by leaf."""
    bar = SIGN_SCALE_ULPS * np.spacing(np.float32(max(scales)))
    for a, b in zip(leaves_np(got), leaves_np(want)):
        assert (np.abs(a - b)
                <= n_deltas * (bar + 2 * np.spacing(np.abs(b)))).all()


def assert_anchors_match(rpub, tpub, codec, scales=None, n_deltas=0):
    if codec == "sign1bit" and n_deltas:
        assert_sign_close(tpub._anchor, rpub._anchor, scales, n_deltas)
        return
    for a, b in zip(rpub._anchor, tpub._anchor):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# --------------------------------------------------------------------- #
# payload parity with the reference Publisher
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("tree", ["small", "gpt2_smoke"])
@pytest.mark.parametrize("bucket_mb", [None, 1.0],
                         ids=["flat_per_leaf", "bucketed"])
@pytest.mark.parametrize("codec", CODECS)
def test_payloads_match_reference(codec, bucket_mb, tree):
    """A snapshot and two deltas (identity: three snapshots): manifests,
    payloads and both sides' anchors against the reference's, and the
    port's subscriber against the reference's subscriber."""
    p = small_tree() if tree == "small" else gpt2_smoke_params()
    kw = dict(codec=codec, bucket_mb=bucket_mb, snapshot_every=100,
              n_chunks=4 if tree == "small" else 16)
    rpub, rsub = (RP.Publisher(ref(p), RP.PublishConfig(**kw)),
                  RP.Subscriber(ref(p), RP.PublishConfig(**kw)))
    tpub, tsub = (Publisher(port(p), PublishConfig(**kw)),
                  Subscriber(port(p), PublishConfig(**kw)))
    kinds, scales = [], []
    for t in range(3):
        ru = rpub.publish(ref(p), step=t)
        tu = tpub.publish(port(p), step=t)
        kinds.append(tu.kind)
        assert_payloads_match(ru, tu, codec)
        scales += [float(np.abs(x["scales"]).max()) for x in ru.payloads
                   if "scales" in x]
        assert_anchors_match(rpub, tpub, codec, scales, t)
        want, got = rsub.apply(ru), tsub.apply(tu)
        if codec == "sign1bit" and t:
            assert_sign_close(got, want, scales, t)
        else:
            assert_bitwise(got, want)
        p = perturb(p, t)
    assert kinds == (["snapshot"] * 3 if codec == "identity"
                     else ["snapshot", "delta", "delta"])


def gpt2_smoke_abstract():
    """gpt2-smoke's parameter tree on the ``meta`` device (no
    parameters materialized)."""
    from repro_torch.serve import Server
    return Server(port_get("gpt2").smoke, max_seq=64,
                  device="cpu").abstract_params(
        torch.float32)


@pytest.mark.parametrize("codec,delta_bytes", [("qint8", 348224),
                                               ("qint4", 174144),
                                               ("identity", 1392640)])
def test_bench_serve_byte_counts(codec, delta_bytes):
    """``BENCH_serve.json``'s gpt2-smoke accounting, exactly: one bucket
    at the default 4 MiB and 16 chunks."""
    wire = Publisher(gpt2_smoke_abstract(), PublishConfig(codec=codec),
                     device="cpu").wire
    assert len(wire.bp.buckets) == 1
    assert wire.full_f32_bytes() == 1387520
    assert wire.wire_bytes("snapshot") == 1392640
    assert wire.wire_bytes("delta") == delta_bytes


def test_qint8_delta_at_most_third_of_full_f32():
    """The reference's acceptance bound, on the port's abstract tree; the
    manifest equals the reference's for its abstract tree."""
    wire = Publisher(gpt2_smoke_abstract(), PublishConfig(codec="qint8"),
                     device="cpu").wire
    assert wire.wire_bytes("delta") * 3 <= wire.full_f32_bytes()
    rab = ref_abstract_params(RT.model_template(ref_get("gpt2").smoke),
                              jnp.float32)
    rwire = RP.Publisher(rab, RP.PublishConfig(codec="qint8")).wire
    assert wire.manifest_base() == rwire.manifest_base()


# --------------------------------------------------------------------- #
# the reference's publish tests, on the port
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("bucket_mb", [None, 1.0],
                         ids=["flat_per_leaf", "bucketed"])
def test_identity_roundtrip_bitwise(bucket_mb):
    p = small_tree()
    pc = PublishConfig(codec="identity", bucket_mb=bucket_mb, n_chunks=4)
    pub, sub = Publisher(port(p), pc), Subscriber(port(p), pc)
    for seed in range(3):
        got = sub.apply(pub.publish(port(p), step=seed))
        assert_bitwise(got, p)
        p = perturb(p, seed)


def test_identity_roundtrip_bitwise_real_model():
    params = port(gpt2_smoke_params())
    pc = PublishConfig(codec="identity", bucket_mb=4.0)
    pub, sub = Publisher(params, pc), Subscriber(params, pc)
    got = sub.apply(pub.publish(params, step=0))
    assert_bitwise(got, params)
    assert jax.tree.structure(got) == jax.tree.structure(params)


@pytest.mark.parametrize("codec,bound", [("qint8", 2e-3), ("qint4", 2e-2)])
@pytest.mark.parametrize("bucket_mb", [None, 1.0],
                         ids=["flat_per_leaf", "bucketed"])
def test_delta_error_bounded_nonaccumulating(codec, bound, bucket_mb):
    """The reference's 12 cycles with snapshots every 5th, on the port;
    each applied tree bit for bit the reference subscriber's."""
    p = small_tree()
    kw = dict(codec=codec, bucket_mb=bucket_mb, n_chunks=4,
              snapshot_every=5)
    pub, sub = (Publisher(port(p), PublishConfig(**kw)),
                Subscriber(port(p), PublishConfig(**kw)))
    rpub, rsub = (RP.Publisher(ref(p), RP.PublishConfig(**kw)),
                  RP.Subscriber(ref(p), RP.PublishConfig(**kw)))
    errs, kinds = [], []
    for t in range(12):
        u = pub.publish(port(p), step=t)
        got = sub.apply(u)
        assert_bitwise(got, rsub.apply(rpub.publish(ref(p), step=t)))
        errs.append(max_err(got, p))
        kinds.append(u.kind)
        p = perturb(p, t)
    assert kinds[0] == "snapshot" and "delta" in kinds
    assert kinds[5] == "snapshot" and kinds[10] == "snapshot"
    for e, k in zip(errs, kinds):
        if k == "snapshot":
            assert e == 0.0
        else:
            assert e < bound
    deltas = [e for e, k in zip(errs, kinds) if k == "delta"]
    assert deltas[-1] < 3 * max(deltas[0], 1e-6)


def test_publisher_subscriber_anchor_lockstep():
    """After many deltas both sides hold the same anchors, bit for bit,
    and the same as the reference's publisher."""
    p = small_tree()
    kw = dict(codec="qint8", bucket_mb=None, n_chunks=4, snapshot_every=100)
    pub, sub = (Publisher(port(p), PublishConfig(**kw)),
                Subscriber(port(p), PublishConfig(**kw)))
    rpub = RP.Publisher(ref(p), RP.PublishConfig(**kw))
    for t in range(6):
        sub.apply(pub.publish(port(p), step=t))
        rpub.publish(ref(p), step=t)
        p = perturb(p, t)
    for a, b, r in zip(pub._anchor, sub._anchor, rpub._anchor):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


# --------------------------------------------------------------------- #
# manifest validation: the reference's error texts, field by field
# --------------------------------------------------------------------- #

def _other(case):
    p = small_tree()
    o = dict(p)
    if case == "tree":
        o["extra"] = np.zeros((3, 3), np.float32)
    if case == "shape":
        o["w"] = np.zeros((37, 9), np.float32)
    return p, o


@pytest.mark.parametrize("case,pub_kw,sub_kw,match", [
    ("codec", dict(codec="qint8"), dict(codec="qint4"), "'codec'"),
    ("n_chunks", dict(n_chunks=4), dict(n_chunks=8), "'n_chunks'"),
    ("tree", {}, {}, "leaf_paths"),
    ("shape", dict(bucket_mb=None), dict(bucket_mb=None),
     r"leaf_shapes.*'w'"),
])
def test_manifest_mismatch_names_field(case, pub_kw, sub_kw, match):
    """Each mismatch raises in both packages with the same text."""
    p, o = _other(case)
    texts = []
    for pkg, conv in ((RP, ref), (None, port)):
        P_, S_, C_ = ((RP.Publisher, RP.Subscriber, RP.PublishConfig)
                      if pkg else (Publisher, Subscriber, PublishConfig))
        pub, sub = P_(conv(p), C_(**pub_kw)), S_(conv(o), C_(**sub_kw))
        with pytest.raises(ValueError, match=match) as e:
            sub.apply(pub.publish(conv(p)))
        texts.append(str(e.value))
    assert texts[1] == texts[0]


def _out_of_order(pkg):
    P_, S_, C_, conv = pkg
    p = small_tree()
    pc = C_(codec="qint8", snapshot_every=100)
    pub, sub = P_(conv(p), pc), S_(conv(p), pc)
    sub.apply(pub.publish(conv(p), step=0))
    pub.publish(conv(perturb(p, 1)), step=1)          # dropped
    return sub, pub.publish(conv(perturb(p, 2)), step=2)


def _before_snapshot(pkg):
    P_, S_, C_, conv = pkg
    p = small_tree()
    pc = C_(codec="qint8", snapshot_every=100)
    pub = P_(conv(p), pc)
    pub.publish(conv(p), step=0)                      # not sent
    return S_(conv(p), pc), pub.publish(conv(perturb(p, 1)), step=1)


def _truncated(pkg):
    P_, S_, C_, conv = pkg
    p = small_tree()
    pc = C_(codec="qint8")
    pub, sub = P_(conv(p), pc), S_(conv(p), pc)
    u = pub.publish(conv(p))
    u.payloads[0] = {k: v[:-1] for k, v in u.payloads[0].items()}
    return sub, u


@pytest.mark.parametrize("make,match", [
    (_out_of_order, "'anchor_seq'"), (_before_snapshot, "anchor"),
    (_truncated, "'payload_bytes'")],
    ids=["out_of_order_delta", "delta_before_snapshot", "truncated"])
def test_bad_update_rejected(make, match):
    texts = []
    for pkg in ((RP.Publisher, RP.Subscriber, RP.PublishConfig, ref),
                (Publisher, Subscriber, PublishConfig, port)):
        sub, u = make(pkg)
        with pytest.raises(ValueError, match=match) as e:
            sub.apply(u)
        texts.append(str(e.value))
    assert texts[1] == texts[0]


# --------------------------------------------------------------------- #
# wire accounting, config checks, file transport
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("codec", CODECS)
def test_payload_bytes_match_codec_accounting(codec):
    p = small_tree()
    pc = PublishConfig(codec=codec, bucket_mb=1.0, n_chunks=4,
                       snapshot_every=100)
    rpc = RP.PublishConfig(codec=codec, bucket_mb=1.0, n_chunks=4,
                           snapshot_every=100)
    pub, rpub = Publisher(port(p), pc), RP.Publisher(ref(p), rpc)
    for t in range(2):          # one snapshot, one delta
        u = pub.publish(port(perturb(p, t)), step=t)
        assert u.nbytes() == u.manifest["payload_bytes"]
        assert u.manifest["payload_bytes"] == rpub.wire.wire_bytes(u.kind)
    assert pub.wire.full_f32_bytes() == rpub.wire.full_f32_bytes()


@pytest.mark.parametrize("kw", [dict(codec="nope"), dict(n_chunks=0),
                                dict(bucket_mb=-1.0),
                                dict(snapshot_every=0),
                                dict(scale_mode="rows"),
                                dict(codec="qint8", codec_arg=0.5)])
def test_publish_config_validation(kw):
    with pytest.raises(ValueError) as e:
        PublishConfig(**kw)
    with pytest.raises(ValueError) as r:
        RP.PublishConfig(**kw)
    assert str(e.value) == str(r.value)


def test_publish_constants_match_reference():
    assert RP.PUBLISH_FORMAT_VERSION == 1
    from repro_torch.serve import publish as TPUB
    assert TPUB.PUBLISH_FORMAT_VERSION == RP.PUBLISH_FORMAT_VERSION
    assert _PER_LEAF_MB == RP._PER_LEAF_MB
    assert TPUB._LAYOUT_FIELDS == RP._LAYOUT_FIELDS


def test_save_load_roundtrip(tmp_path):
    p = small_tree()
    pc = PublishConfig(codec="qint8", snapshot_every=100)
    pub, sub = Publisher(port(p), pc), Subscriber(port(p), pc)
    sub.apply(pub.publish(port(p), step=0))
    p1 = perturb(p, 1)
    u = pub.publish(port(p1), step=1)
    path = str(tmp_path / "update.npz")
    save_update(path, u)
    u2 = load_update(path)
    assert u2.manifest == u.manifest
    got = sub.apply(u2)
    assert max_err(got, p1) < 2e-3


@pytest.mark.parametrize("codec", ["sign1bit", "qint8", "topk"])
def test_updates_cross_packages(codec, tmp_path):
    """A reference update stream applied by the port's Subscriber, and a
    port stream saved with ``save_update`` and applied by the reference's
    ``load_update`` + ``Subscriber.apply``: each bit for bit the sending
    package's own subscriber."""
    p = gpt2_smoke_params()
    kw = dict(codec=codec, snapshot_every=100)
    rpub, rsub = (RP.Publisher(ref(p), RP.PublishConfig(**kw)),
                  RP.Subscriber(ref(p), RP.PublishConfig(**kw)))
    tpub, tsub = (Publisher(port(p), PublishConfig(**kw)),
                  Subscriber(port(p), PublishConfig(**kw)))
    to_port = Subscriber(port(p), PublishConfig(**kw))
    to_ref = RP.Subscriber(ref(p), RP.PublishConfig(**kw))
    for t in range(3):
        ru = rpub.publish(ref(p), step=t)
        RP.save_update(str(tmp_path / f"r{t}.npz"), ru)
        assert_bitwise(to_port.apply(load_update(str(tmp_path / f"r{t}.npz"))),
                       rsub.apply(ru))
        tu = tpub.publish(port(p), step=t)
        save_update(str(tmp_path / f"t{t}.npz"), tu)
        assert_bitwise(to_ref.apply(RP.load_update(str(tmp_path / f"t{t}.npz"))),
                       tsub.apply(tu))
        p = perturb(p, t)
