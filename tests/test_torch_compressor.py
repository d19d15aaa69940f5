"""Port compressor, codec, dispatch and flat Algorithm-2 exchange vs the
reference, live in one process on the same numpy inputs.

Tolerances:
* layouts, frame row counts, true counts, pad masks, views, packed bytes
  and wire-byte accounting: exact (static metadata and sign bits);
* scales: 1e-6 relative — an f32 L1 sum over the view, a chunk or a row
  taken in another order than XLA's (a few ulp);
* EF errors and exchange outputs: 1e-5 relative / 1e-6 absolute — each is
  ``zw -/+ scale`` or a mean of +-scales, so it inherits the scales' few
  ulp (the reference's own Pallas-vs-jnp parity tests use the same bar).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get as ref_get
from repro.core import codecs as RCD
from repro.core import compressor as RC
from repro.core import leafwise as RLW
from repro.core import onebit_allreduce as RAR
from repro.core.comm import sim_comm
from repro.kernels import dispatch as RK
from repro.models import layers as RL
from repro.models import transformer as RT

import torch

from repro_torch.configs.base import get as port_get
from repro_torch.core import codecs as TCD
from repro_torch.core import compressor as TC
from repro_torch.core import leafwise as TLW
from repro_torch.core import onebit_allreduce as TAR
from repro_torch.core.comm import SimComm
from repro_torch.kernels import dispatch as K
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

# The suite runs under pytest-xdist with several workers per machine;
# torch's default of one intra-op thread per core in each of them would
# oversubscribe the cores. These inputs are small: one thread suffices.
torch.set_num_threads(1)

N = 4
# (shape, tensor-parallel spec entries): flatten padded / exact / scalar /
# folded wider than FRAME_MAX_COLS; structured padded / exact / 4-D; a
# 3-D view whose split axis is not a multiple of n (two whole pad rows)
CASES = [((37,), None), ((64,), None), ((), None), ((100003,), None),
         ((13, 40), (None, "model")), ((16, 40), (None, "model")),
         ((6, 4, 24), (None, None, "model")), ((10, 24), (None, "model"))]
IDS = ["flat37", "flat64", "scalar", "fold100003", "rows13x40",
       "rows16x40", "rows6x4x24", "rows10x24"]
MODES = ["tensor", "chunk", "row"]


def _layouts(shape, spec):
    return (RC.make_layout(shape, None if spec is None else P(*spec), N),
            TC.make_layout(shape, spec, N))


def _masked_pair(lo_ref, seed, lead=(N,)):
    """Random (z, err) stacks in view shape, zero at padded positions."""
    rng = np.random.default_rng(seed)
    shape = lead + lo_ref.view_shape
    z = rng.standard_normal(shape).astype(np.float32)
    e = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    m = RC.pad_mask(lo_ref)
    if m is not None:
        z, e = z * np.asarray(m), e * np.asarray(m)
    return z, e


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_plan(cfg):
    tmpl = RT.model_template(cfg)
    return RLW.make_plan(RL.abstract_params(tmpl), RL.param_specs(tmpl),
                         None, N)


def _port_plan(cfg):
    tmpl = TT.model_template(cfg)
    return TLW.make_plan(TL.param_shapes(tmpl), TL.param_specs(tmpl),
                         TL.dp_mask(tmpl), N)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_gpt2_layouts_match_reference_field_for_field(which):
    rcfg = getattr(ref_get("gpt2"), "smoke" if which == "smoke" else
                   "config")
    tcfg = getattr(port_get("gpt2"), "smoke" if which == "smoke" else
                   "config")
    ref, port = _ref_plan(rcfg), _port_plan(tcfg)
    assert len(port.layouts) == len(ref.layouts) == 19
    for lr, lt in zip(ref.layouts, port.layouts):
        assert dataclasses.astuple(lt) == dataclasses.astuple(lr)
        assert TC.view_rows_cols(lt) == RC.view_rows_cols(lr)
        np.testing.assert_array_equal(TC.view_row_counts(lt),
                                      RC.view_row_counts(lr))
    true = sum(int(np.prod(lo.shape)) for lo in port.layouts)
    frames = sum(int(np.prod(TC.view_rows_cols(lo))) for lo in port.layouts)
    if which == "smoke":
        assert true == 346_880
    else:
        assert true == 148_944_384 and frames == 148_944_896
        by_shape = {lo.shape: (lo.view_shape, TC.view_rows_cols(lo))
                    for lo in port.layouts}
        assert by_shape[(50432, 768)] == ((4, 192, 50432), (768, 50432))
        assert by_shape[(32768, 768)][1] == (3072, 8192)
        assert by_shape[(12, 768, 3072)][1] == (9216, 3072)
        assert by_shape[(12, 768, 768)][1] == (9216, 768)


@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_views_and_counts_match_reference(shape, spec):
    lo_r, lo_t = _layouts(shape, spec)
    assert dataclasses.astuple(lo_t) == dataclasses.astuple(lo_r)
    rng = np.random.default_rng(len(shape) + int(np.prod(shape or (1,))))
    x = rng.standard_normal((N,) + shape).astype(np.float32)
    v_ref = jax.vmap(lambda a: RC.to_view(a, lo_r))(jnp.asarray(x))
    v = TC.to_view(_t(x), lo_t)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(TC.from_view(v, lo_t).numpy(), x)
    np.testing.assert_array_equal(TC.chunk_row_counts(lo_t),
                                  RC.chunk_row_counts(lo_r))
    tot_t, per_t = TC.true_counts(lo_t)
    tot_r, per_r = RC.true_counts(lo_r)
    assert tot_t == tot_r
    np.testing.assert_array_equal(per_t, per_r)
    m_r, m_t = RC.pad_mask(lo_r), TC.pad_mask(lo_t)
    assert (m_r is None) == (m_t is None)
    if m_t is not None:
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_r))
    assert TC.compressed_bytes(lo_t, "tensor") == RC.compressed_bytes(
        lo_r, "tensor")


def test_pack_signs_bitwise():
    """Bit for bit on normal values and signed zeros. (A negative
    *subnormal* differs: XLA on the CPU flushes it to -0, which packs as
    1; PyTorch and the CUDA kernel keep it negative, which packs as 0.)"""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3, 5, 64)).astype(np.float32)
    v[0, 0, :3] = [0.0, -0.0, -1e-30]
    p_ref = np.asarray(RC.pack_signs(jnp.asarray(v)))
    p = TC.pack_signs(_t(v))
    np.testing.assert_array_equal(p.numpy(), p_ref)
    assert p_ref[0, 0, 0] >> 5 == 0b110      # +0, -0 -> 1; tiny negative 0
    np.testing.assert_array_equal(
        TC.unpack_signs(p, 64).numpy(),
        np.asarray(RC.unpack_signs(jnp.asarray(p_ref), 64)))


def _check_compress(got, want):
    (p, s, e), (p_r, s_r, e_r) = got, want
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_r))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_ef_compress_matches_reference(shape, spec):
    """Whole-view compressor and the kernel-frame dispatch path (plain
    kernel versions on CPU) against the reference's compressor."""
    lo_r, lo_t = _layouts(shape, spec)
    z, e = _masked_pair(lo_r, seed=len(IDS[CASES.index((shape, spec))]))
    m_r = RC.pad_mask(lo_r)
    want = jax.vmap(lambda a: RC.ef_compress(a, lo_r, "tensor", m_r))(
        jnp.asarray(z + e))
    m_t = TC.pad_mask(lo_t)
    _check_compress(TC.ef_compress(_t(z) + _t(e), lo_t, "tensor", m_t),
                    want)
    _check_compress(K.ef_compress_view(_t(z), _t(e), lo_t, "tensor"), want)
    p, s, _ = want
    v_ref = jax.vmap(lambda a, b: RC.decompress(a, b, lo_r.pack_count))(
        p, s)
    np.testing.assert_array_equal(
        K.decompress_view(_t(np.asarray(p)), _t(np.asarray(s)),
                          lo_t).numpy(), np.asarray(v_ref))


@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_server_compress_matches_reference(shape, spec):
    """Every worker serves its own chunk; the last one holds the pad."""
    lo_r, lo_t = _layouts(shape, spec)
    rng = np.random.default_rng(3)
    y = rng.standard_normal((N,) + lo_r.chunk_shape).astype(np.float32)
    e = (rng.standard_normal(y.shape) * 0.3).astype(np.float32)
    m_r = RC.pad_mask(lo_r)
    if m_r is not None:
        y, e = y * np.asarray(m_r), e * np.asarray(m_r)
    want = jax.vmap(lambda a, w: RCD._server_compress(
        a[None], lo_r, "tensor", None if m_r is None else m_r[w][None]))(
            jnp.asarray(y + e), jnp.arange(N))
    m_t = TC.pad_mask(lo_t)
    s_mask = None if m_t is None else m_t[:, None]
    _check_compress(TCD._server_compress((_t(y) + _t(e))[:, None], lo_t,
                                         "tensor", s_mask), want)
    _check_compress(K.server_compress_view(_t(y)[:, None], _t(e)[:, None],
                                           lo_t, "tensor", np.arange(N)),
                    want)


@pytest.mark.parametrize("codec", ["sign1bit", "identity"])
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_onebit_allreduce_matches_reference(shape, spec, codec):
    """Flat Algorithm 2, n=4, tensor scales, from random non-zero worker
    and server EF state: the mean estimate and both new EF errors (the
    identity codec leaves them untouched).

    One round only: z + err_w is computed identically on both sides, so
    no worker sign bit can differ. Chained rounds inherit few-ulp EF
    differences, and a near-zero z + err then flips its bit (measured
    here: 1 element of 401,408 in a second round); the trajectory tests
    carry that case with their own tolerances."""
    lo_r, lo_t = _layouts(shape, spec)
    z, ew = _masked_pair(lo_r, seed=11)
    es, _ = _masked_pair(lo_r, seed=12)
    es = es[np.arange(N), np.arange(N)] * 0.3      # chunk w of worker w
    cfg_r = RAR.OneBitConfig(scale_mode="tensor", codec=codec)
    comm = sim_comm("w")
    out_r, ef_r = jax.vmap(lambda a, b, c: RAR.onebit_allreduce_view(
        comm, a, RAR.EFState(b, c), lo_r, cfg_r), axis_name="w")(
            jnp.asarray(z), jnp.asarray(ew), jnp.asarray(es))
    out_t, ef_t = TAR.onebit_allreduce_view(
        SimComm(N), _t(z), TAR.EFState(_t(ew), _t(es)), lo_t,
        TAR.OneBitConfig(codec=codec))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r),
                               rtol=1e-5, atol=1e-6)
    for got, want in zip(ef_t, ef_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # every worker holds the same estimate
    assert (out_t == out_t[:1]).all()


def _combine_per_row(rowsum, shape, mode, rest_factor, denoms, stack):
    """The reference dispatch's combine of the row sums of ``stack``
    stacked frames into scales (``_combine_scales``,
    ``_row_group_scales``), written in torch."""
    ndim = len(shape)
    if mode == "tensor":
        s = rowsum.view(stack, -1).sum(1) / denoms[0]
        return s.view((stack,) + (1,) * ndim)
    if mode == "chunk":
        s = rowsum.view(stack, shape[0], -1).sum(-1) / denoms[1]
        return s.view((stack, shape[0]) + (1,) * (ndim - 1))
    group = int(np.prod(shape[2:-1])) if ndim > 3 else 1
    rest = max(int(np.prod(shape[2:])) * rest_factor, 1)
    s = (rowsum.view(stack * shape[0], shape[1], group).sum(-1)
         / torch.tensor(float(rest)))
    return s.view((stack,) + tuple(shape[:2]) + (1,) * (ndim - 2))


def _per_row_two_pass(z2, e2, cnts, scales, lead, layout):
    """Pass 2 against the scales spread onto every frame row."""
    from repro_torch.kernels import onebit
    srow = K._scales_to_rows(scales, lead, z2.shape[0], layout)
    return onebit.ef_quantize_plain(z2, e2, srow, cnts)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_scale_groups_bitwise_the_per_row_combine(shape, spec, mode):
    """The two-pass compress through pass 1's scale groups (group rows and
    per-group denominators) and pass 2's one scale per group gives bit for
    bit the packed bytes, scales and EF errors of the combine in torch and
    per-row scales: worker side on the view and on the inner slices of 2
    pods x 2 (stacked workers owning different slices), server side on
    the chunk each worker serves."""
    from repro_torch.kernels import onebit
    for ni in (1, 2):
        lo = TC.make_layout(shape, spec, N, n_inner=ni)
        rows, cols = TC.view_rows_cols(lo)
        ndim, no = len(lo.view_shape), lo.n_outer
        m = TC.pad_mask(lo)
        m = torch.broadcast_to(torch.ones(()) if m is None else m,
                               lo.view_shape)
        rng = np.random.default_rng(7 * ni)
        z, e = (_t(rng.standard_normal((N,) + lo.view_shape).astype(
            np.float32)) * m * sc for sc in (1.0, 0.3))
        j = np.arange(N) % ni
        if ni == 1:
            idx, bshape, zz, ee = None, lo.view_shape, z, e
        else:
            idx, bshape = tuple(int(a) for a in j), lo.slice_shape
            zz, ee = (a.reshape((N, ni, no) + lo.chunk_shape)[
                torch.arange(N), torch.as_tensor(j)] for a in (z, e))
        R = N * rows // ni
        eff = "chunk" if (mode == "row" and ndim == 2) else mode
        got = K.ef_compress_view(zz, ee, lo, mode, idx)
        if not (eff == "row" and ndim == 3):       # else the single pass
            z2, e2 = zz.reshape(R, cols), ee.reshape(R, cols)
            cnts, *denoms = K._worker_counts(lo, N, idx, "cpu")
            sc = _combine_per_row(onebit.abs_rowsum_plain(z2, e2, cnts),
                                  bshape, eff, lo.rest_factor, denoms, N)
            p, eo = _per_row_two_pass(z2, e2, cnts, sc, (N,) + bshape[:-1],
                                      lo)
            assert torch.equal(got[1], sc), (ni, "worker scales")
            assert torch.equal(got[0].reshape(p.shape), p), ni
            assert torch.equal(got[2].reshape(R, cols), eo), ni
        if mode == "row" and ndim == 2:
            continue                  # per-element server scales: no kernel
        widx = tuple(int(w) for w in j * no + np.arange(N) // ni)
        ys = (N, 1) + lo.chunk_shape
        cm = m.reshape((N,) + lo.chunk_shape)[list(widx)][:, None]
        avg, es = (_t(rng.standard_normal(ys).astype(np.float32)) * cm * sc
                   for sc in (1.0, 0.1))
        got = K.server_compress_view(avg, es, lo, mode, widx)
        rs_rows = N * (rows // lo.n)
        a2, e2 = avg.reshape(rs_rows, cols), es.reshape(rs_rows, cols)
        cnts, denom = K._server_counts(lo, widx, "cpu")
        rs = onebit.abs_rowsum_plain(a2, e2, cnts)
        if mode == "row":
            sc = _combine_per_row(rs, ys[1:], "row", lo.rest_factor, None, N)
        else:
            sc = (rs.view(N, -1).sum(1) / denom).view((N,) + (1,) * (
                len(ys) - 1))
        p, eo = _per_row_two_pass(a2, e2, cnts, sc, ys[:-1], lo)
        assert torch.equal(got[1], sc), (ni, "server scales")
        assert torch.equal(got[0].reshape(p.shape), p), ni
        assert torch.equal(got[2].reshape(rs_rows, cols), eo), ni


def test_fullprec_allreduce_matches_reference():
    lo_r, lo_t = _layouts((13, 40), (None, "model"))
    z, _ = _masked_pair(lo_r, seed=5)
    comm = sim_comm("w")
    want = jax.vmap(lambda a: RAR.fullprec_allreduce_view(comm, a),
                    axis_name="w")(jnp.asarray(z))
    got = TAR.fullprec_allreduce_view(SimComm(N), _t(z))
    # bf16 wire on both phases: an f32 sum of 4 bf16 values (8 significant
    # bits each, 2 bits of carry) is exact in any order unless they span
    # more than 2^14 in magnitude, and the mean rounds to bf16 again: bit
    # for bit
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unported_modes_raise():
    # all three scale modes and every codec of the reference are ported;
    # a typo is refused
    for mode in ("tensor", "chunk", "row"):
        TAR.OneBitConfig(scale_mode=mode)
    with pytest.raises(ValueError):
        TAR.OneBitConfig(scale_mode="rows")
    for name in ("sign1bit", "topk", "qint8", "qint4", "identity"):
        assert TAR.OneBitConfig(codec=name).codec.name == name
    with pytest.raises(ValueError):
        TCD.make_codec("nope")


# --- bert layouts, chunk and row scales ---------------------------------

@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ["bert-base", "bert-large"])
def test_bert_layouts_match_reference_field_for_field(arch, which):
    attr = "smoke" if which == "smoke" else "config"
    ref = _ref_plan(getattr(ref_get(arch), attr))
    port = _port_plan(getattr(port_get(arch), attr))
    assert len(port.layouts) == len(ref.layouts) == 20
    for lr, lt in zip(ref.layouts, port.layouts):
        assert dataclasses.astuple(lt) == dataclasses.astuple(lr)
        assert TC.view_rows_cols(lt) == RC.view_rows_cols(lr)
        np.testing.assert_array_equal(TC.view_row_counts(lt),
                                      RC.view_row_counts(lr))
    if (arch, which) == ("bert-base", "full"):
        true = sum(int(np.prod(lo.shape)) for lo in port.layouts)
        assert true == 135_378_432
        by_path = {"/".join(p): (lo.view_shape, TC.view_rows_cols(lo))
                   for p, lo in zip(port.paths, port.layouts)}
        assert by_path["embed"] == ((4, 192, 30720), (768, 30720))
        assert by_path["lm_head"] == ((4, 192, 30720), (768, 30720))
        assert by_path["blocks/attn/bq"] == ((4, 3, 768), (12, 768))
        assert by_path["blocks/mlp/b_in"] == ((4, 3, 3072), (12, 3072))
        assert by_path["blocks/attn/wq"] == ((4, 192, 12, 768), (9216, 768))
        assert by_path["blocks/mlp/w_out"] == ((4, 192, 12, 3072),
                                               (9216, 3072))
        assert by_path["pos_embed"] == ((4, 786432), (384, 8192))
        assert by_path["blocks/mlp/b_out"] == ((4, 2304), (4, 2304))
        assert by_path["final_norm/scale"] == ((4, 256), (4, 256))
        ndims = sorted(len(lo.view_shape) for lo in port.layouts)
        assert ndims == [2] * 8 + [3] * 6 + [4] * 6


@pytest.mark.parametrize("mode", ["chunk", "row"])
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_chunk_row_ef_compress_matches_reference(shape, spec, mode):
    """Worker side in chunk and row mode: the whole-view compressor and
    the kernel-frame dispatch (single-pass ef_compress for row scales on
    3-D views, two-pass otherwise; row on a 2-D view falls back to chunk)
    against both the reference's jnp compressor and its kernel dispatch."""
    lo_r, lo_t = _layouts(shape, spec)
    z, e = _masked_pair(lo_r, seed=7 + len(shape))
    m_r, m_t = RC.pad_mask(lo_r), TC.pad_mask(lo_t)
    want = jax.vmap(lambda a: RC.ef_compress(a, lo_r, mode, m_r))(
        jnp.asarray(z + e))
    want_k = jax.vmap(lambda a, b: RK.ef_compress_view(a, b, lo_r, mode))(
        jnp.asarray(z), jnp.asarray(e))
    s_ref = jax.vmap(lambda a: RC._scales(a, lo_r, mode, m_r))(
        jnp.asarray(z + e))
    np.testing.assert_allclose(
        TC._scales(_t(z) + _t(e), lo_t, mode, m_t).numpy(),
        np.asarray(s_ref), rtol=1e-6)
    got_whole = TC.ef_compress(_t(z) + _t(e), lo_t, mode, m_t)
    got_k = K.ef_compress_view(_t(z), _t(e), lo_t, mode)
    for got in (got_whole, got_k):
        _check_compress(got, want)
        _check_compress(got, want_k)
    ndim = len(lo_t.view_shape)
    s = got_k[1]
    if mode == "chunk" or ndim == 2:
        assert s.shape == (N, N) + (1,) * (ndim - 1)
    else:
        assert s.shape == (N,) + lo_t.view_shape[:2] + (1,) * (ndim - 2)
    # decode of the worker payload (scales with a trailing 1: the kernel)
    v_ref = jax.vmap(lambda a, b: RC.decompress(a, b, lo_r.pack_count))(
        want[0], want[1])
    np.testing.assert_array_equal(
        K.decompress_view(_t(np.asarray(want[0])), _t(np.asarray(want[1])),
                          lo_t).numpy(), np.asarray(v_ref))


@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_row_server_compress_matches_reference(shape, spec):
    """Server side in row mode: per element on 2-D views (the plain path
    on both sides), row-group scales through the kernels on 3-D and 4-D
    views, against the reference's jnp path and its dispatch."""
    lo_r, lo_t = _layouts(shape, spec)
    rng = np.random.default_rng(5)
    y = rng.standard_normal((N,) + lo_r.chunk_shape).astype(np.float32)
    e = (rng.standard_normal(y.shape) * 0.3).astype(np.float32)
    m_r = RC.pad_mask(lo_r)
    if m_r is not None:
        y, e = y * np.asarray(m_r), e * np.asarray(m_r)
    want = jax.vmap(lambda a, w: RCD._server_compress(
        a[None], lo_r, "row", None if m_r is None else m_r[w][None]))(
            jnp.asarray(y + e), jnp.arange(N))
    m_t = TC.pad_mask(lo_t)
    s_mask = None if m_t is None else m_t[:, None]
    _check_compress(TCD._server_compress((_t(y) + _t(e))[:, None], lo_t,
                                         "row", s_mask), want)
    codec = TCD.make_codec("sign1bit")
    payload, err_s = codec.encode_server(_t(y), _t(e), lo_t, "row",
                                         np.arange(N))
    _check_compress((payload["packed"], payload["scales"], err_s[:, None]),
                    want)
    if len(lo_t.view_shape) == 2:
        # per-element scales: the server residual is exactly zero
        assert payload["scales"].shape == (N, 1, lo_t.view_shape[1])
        assert (err_s == 0).all()
        with pytest.raises(ValueError):
            K.server_compress_view(_t(y)[:, None], _t(e)[:, None], lo_t,
                                   "row", np.arange(N))
    else:
        want_k = jax.vmap(lambda a, b, w: RK.server_compress_view(
            a[None], b[None], lo_r, "row", w))(
                jnp.asarray(y), jnp.asarray(e), jnp.arange(N))
        _check_compress(K.server_compress_view(
            _t(y)[:, None], _t(e)[:, None], lo_t, "row", np.arange(N)),
            want_k)


@pytest.mark.parametrize("ref_pallas", [False, True],
                         ids=["ref_xla", "ref_pallas"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_onebit_allreduce_scale_modes_match_reference(shape, spec, mode,
                                                      ref_pallas):
    """Flat Algorithm 2, n=4, sign1bit, every scale mode, against the
    reference's jnp path and its kernel path: the mean estimate and both
    new EF errors, one round from random EF state (see
    test_onebit_allreduce_matches_reference for why one round)."""
    lo_r, lo_t = _layouts(shape, spec)
    z, ew = _masked_pair(lo_r, seed=21)
    es, _ = _masked_pair(lo_r, seed=22)
    es = es[np.arange(N), np.arange(N)] * 0.3
    cfg_r = RAR.OneBitConfig(scale_mode=mode, use_pallas=ref_pallas)
    comm = sim_comm("w")
    out_r, ef_r = jax.vmap(lambda a, b, c: RAR.onebit_allreduce_view(
        comm, a, RAR.EFState(b, c), lo_r, cfg_r), axis_name="w")(
            jnp.asarray(z), jnp.asarray(ew), jnp.asarray(es))
    out_t, ef_t = TAR.onebit_allreduce_view(
        SimComm(N), _t(z), TAR.EFState(_t(ew), _t(es)), lo_t,
        TAR.OneBitConfig(scale_mode=mode))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r),
                               rtol=1e-5, atol=1e-6)
    for got, want in zip(ef_t, ef_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    assert (out_t == out_t[:1]).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,spec", CASES, ids=IDS)
def test_wire_bytes_match_reference(shape, spec, mode):
    lo_r, lo_t = _layouts(shape, spec)
    assert (TCD.make_codec("sign1bit").wire_bytes(lo_t, mode)
            == RCD.make_codec("sign1bit").wire_bytes(lo_r, mode))
    assert TC.compressed_bytes(lo_t, mode) == RC.compressed_bytes(lo_r,
                                                                   mode)
