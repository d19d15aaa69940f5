"""Port kernels (plain versions on the CPU) vs the reference Pallas
kernels in interpret mode (``repro.kernels.ops``), on the same numpy
inputs.

Tolerances:
* packed bytes, ``ef_quantize``'s err_out, ``decompress``'s output, the
  fused steps' m' and u' and the SGD step's delta are compared bit for
  bit: each is one add, a compare and one subtract per element, a single
  multiply, or a single-rounding FMA, on both sides;
* ``abs_rowsum`` to 1e-6 relative: an f32 sum of up to 4104 nonnegative
  terms taken in another order (the sum's own rounding, ~log2(n) ulp);
  the scales of ``abs_rowsum_scales`` (a group's row sums over its
  denominator) likewise, against the reference's row sums combined in
  jnp;
* ``ef_compress``'s per-row scales to 2e-6 relative: the same row sum over
  up to 30,720 terms, divided by the row's count; its err_out bit for bit
  on the rows whose scales agree bitwise, and elsewhere within the scale
  gap (err_out = z + err -/+ scale);
* the Adam step's delta to 2 ulp: XLA rewrites (lr*m')/sqrt(v+eps) in a
  way no plain f32 formula reproduces (measured: ~40% of elements 1 ulp
  off, none beyond 2).

The CUDA kernels themselves are checked against these plain versions in
tests/test_torch_gpu.py, on the card.
"""
import fractions

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.configs.base import get as port_get
from repro_torch.core import compressor as TC
from repro_torch.core.comm import Hierarchy
from repro_torch.core.leafwise import make_plan
from repro_torch.kernels import build, dispatch, fused_adam, onebit
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

# The suite runs under pytest-xdist with several workers per machine;
# torch's default of one intra-op thread per core in each of them would
# oversubscribe the cores. These inputs are small: one thread suffices.
torch.set_num_threads(1)

WIDTHS = [8, 256, 4104]
# ef_compress also runs at the widest BERT-Base frame (embed, lm_head)
ONE_PASS_WIDTHS = WIDTHS + [30720]


def _frame(rows, cols, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((rows, cols)).astype(np.float32)
    e = (rng.standard_normal((rows, cols)) * 0.3).astype(np.float32)
    # ragged tails, whole pad rows, full rows, and a one-element row
    cnt = np.array([cols, cols // 2 + 1, 0, 1] * (rows // 4), np.int32)
    return z, e, cnt


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("cols", WIDTHS)
def test_abs_rowsum_matches_reference(cols):
    z, e, cnt = _frame(16, cols, cols)
    want = np.asarray(ops.abs_rowsum(jnp.asarray(z), jnp.asarray(e),
                                     jnp.asarray(cnt), block_rows=8))
    got = onebit.abs_rowsum(_t(z), _t(e), _t(cnt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[cnt == 0] == 0).all()


@pytest.mark.parametrize("cols", WIDTHS)
def test_ef_quantize_matches_reference(cols):
    z, e, cnt = _frame(16, cols, cols + 1)
    z[0, :4] = [0.0, -0.0, 1.0, -1.0]
    e[0, :4] = [0.0, 0.0, -1.0, 1.0]          # zw = 0, -0, 0, 0 -> 1 bits
    s = (np.abs(z + e).sum(1) / np.maximum(cnt, 1)).astype(np.float32)
    p_ref, e_ref = ops.ef_quantize(jnp.asarray(z), jnp.asarray(e),
                                   jnp.asarray(s), jnp.asarray(cnt),
                                   block_rows=8)
    p, eo = onebit.ef_quantize(_t(z), _t(e), _t(s), _t(cnt))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(eo.numpy(), np.asarray(e_ref))
    assert p.numpy()[0, 0] >> 4 == 0b1111     # +0 and -0 pack as 1
    assert (eo.numpy()[cnt == 0] == 0).all()


@pytest.mark.parametrize("group_rows", [1, 4, 16])
@pytest.mark.parametrize("cols", WIDTHS)
def test_two_pass_with_group_scales_matches_reference(cols, group_rows):
    """Pass 1 with its scale groups and pass 2 against compact scales,
    against the reference's abs_rowsum, the combine in jnp (each group's
    row sums over its denominator, as ``_combine_scales``) and
    ef_quantize on the scales repeated over each group's rows."""
    z, e, cnt = _frame(16, cols, cols + 3)
    groups = 16 // group_rows
    denoms = np.maximum(cnt.reshape(groups, group_rows).sum(1), 1).astype(
        np.float32)
    rs_ref = ops.abs_rowsum(jnp.asarray(z), jnp.asarray(e), jnp.asarray(cnt),
                            block_rows=8)
    s_ref = np.asarray(rs_ref.reshape(groups, group_rows).sum(1)
                       / jnp.asarray(denoms))
    rowsum, scales = onebit.abs_rowsum_scales(_t(z), _t(e), _t(cnt),
                                              group_rows, _t(denoms))
    np.testing.assert_allclose(rowsum.numpy(), np.asarray(rs_ref), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(scales.numpy(), s_ref, rtol=1e-6, atol=0)
    assert scales.shape == (groups,)
    p, eo = onebit.ef_quantize(_t(z), _t(e), scales, _t(cnt), group_rows)
    # the reference quantizer given the port's scales, per row
    srow = np.repeat(scales.numpy(), group_rows)
    p_ref, e_ref = ops.ef_quantize(jnp.asarray(z), jnp.asarray(e),
                                   jnp.asarray(srow), jnp.asarray(cnt),
                                   block_rows=8)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(eo.numpy(), np.asarray(e_ref))
    # compact scales are the per-row ones repeated over each group
    p1, e1 = onebit.ef_quantize(_t(z), _t(e), _t(srow), _t(cnt))
    assert torch.equal(p, p1) and torch.equal(eo, e1)


@pytest.mark.parametrize("cols", WIDTHS)
def test_decompress_matches_reference(cols):
    rng = np.random.default_rng(cols)
    packed = rng.integers(0, 256, (16, cols // 8), dtype=np.uint8)
    s = np.abs(rng.standard_normal(16)).astype(np.float32)
    s[3] = 0.0
    want = np.asarray(ops.decompress(jnp.asarray(packed), jnp.asarray(s),
                                     block_rows=8))
    got = onebit.decompress(_t(packed), _t(s)).numpy()
    np.testing.assert_array_equal(got, want)
    msb = (packed[:, 0] >> 7) == 1            # element 0 is the MSB
    assert ((got[:, 0] > 0) == msb)[s > 0].all()


@pytest.mark.parametrize("shape", [(8, 256), (64, 1024), (16, 4104)])
def test_fused_local_step_matches_reference(shape):
    rng = np.random.default_rng(shape[1])
    g, m, u = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    v = (np.abs(rng.standard_normal(shape)) * 1e-3).astype(np.float32)
    lr = np.float32(1e-3)
    block = (8, 8 if shape[1] % 1024 else 1024)
    want = ops.fused_local_step(*map(jnp.asarray, (g, m, u, v)), lr, 0.9,
                                1e-8, block=block)
    got = fused_adam.fused_local_step(*map(_t, (g, m, u, v)), lr, 0.9, 1e-8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert _ulps(got[2].numpy(), want[2]).max() <= 2


@pytest.mark.parametrize("cols", ONE_PASS_WIDTHS)
def test_ef_compress_matches_reference(cols):
    z, e, cnt = _frame(16, cols, cols + 2)
    z[0, :4] = [0.0, -0.0, 1.0, -1.0]
    e[0, :4] = [0.0, 0.0, -1.0, 1.0]          # zw = 0, -0, 0, 0 -> 1 bits
    p_ref, s_ref, e_ref = (np.asarray(a) for a in ops.ef_compress(
        jnp.asarray(z), jnp.asarray(e), jnp.asarray(cnt), block_rows=8))
    p, s, eo = (a.numpy() for a in onebit.ef_compress(_t(z), _t(e),
                                                      _t(cnt)))
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_allclose(s, s_ref, rtol=2e-6, atol=0)
    same = s == s_ref
    np.testing.assert_array_equal(eo[same], e_ref[same])
    gap = float(np.abs(s - s_ref).max())
    np.testing.assert_allclose(eo, e_ref, rtol=0,
                               atol=gap + 4 * np.spacing(np.float32(8)))
    assert (s[cnt == 0] == 0).all() and (eo[cnt == 0] == 0).all()
    assert p[0, 0] >> 4 == 0b1111             # +0 and -0 pack as 1
    # the single pass is the two-pass compress with per-row scales
    s2 = onebit.abs_rowsum(_t(z), _t(e), _t(cnt)) / _t(
        np.maximum(cnt, 1).astype(np.float32))
    p2, e2 = onebit.ef_quantize(_t(z), _t(e), s2, _t(cnt))
    np.testing.assert_array_equal(s, s2.numpy())
    np.testing.assert_array_equal(p, p2.numpy())
    np.testing.assert_array_equal(eo, e2.numpy())


def _block_cols(cols):
    return max(d for d in range(1, min(cols, 1024) + 1) if cols % d == 0)


@pytest.mark.parametrize("shape", [(8, 256), (64, 1024), (16, 4104),
                                   (8, 30720)])
def test_fused_local_step_sgd_matches_reference(shape):
    """m', u' and delta bit for bit: XLA contracts m' = b1*m + (1-b1)*g
    and u' = u + lr*m' into FMAs (u' from m', even though delta = lr*m' is
    written out); the plain version emulates both FMAs."""
    rng = np.random.default_rng(shape[1] + 1)
    g, m, u = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    lr = np.float32(3e-3)
    want = ops.fused_local_step_sgd(*map(jnp.asarray, (g, m, u)), lr, 0.9,
                                    block=(8, _block_cols(shape[1])))
    got = fused_adam.fused_local_step_sgd(*map(_t, (g, m, u)), lr, 0.9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the FMAs matter: single-rounding differs from plain f32 somewhere
    mh32 = np.float32(0.9) * m + np.float32(1 - 0.9) * g
    assert (mh32 != got[0].numpy()).any()
    np.testing.assert_array_equal(got[2].numpy(), got[0].numpy() * lr)


def test_fma_f32_rounds_once():
    """Cases where rounding a*b+c in f64 and then to f32 (two roundings)
    differs from the single rounding of an FMA, and results in f32's
    subnormal range; the exact value comes from rational arithmetic."""
    a = np.array([1 + 2.0 ** -12, 1 + 2.0 ** -12, 3.0, 0.1, 2.0 ** -70,
                  3e-20, 1e-30], np.float32)
    b = np.array([1 + 2.0 ** -12, 1 - 2.0 ** -12, 1 / 3, 0.9, 2.0 ** -70,
                  -7e-20, 1e-9], np.float32)
    c = np.array([2.0 ** -70, -(2.0 ** -70), 1e-30, -0.09, 2.0 ** -149,
                  2e-39, -1e-45], np.float32)
    got = fused_adam.fma_f32(_t(a), _t(b), _t(c)).numpy()
    for i in range(len(a)):
        exact = (fractions.Fraction(float(a[i])) * fractions.Fraction(
            float(b[i])) + fractions.Fraction(float(c[i])))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda x: (abs(fractions.Fraction(float(x))
                                             - exact),
                                         int(np.array(x).view(np.int32))
                                         & 1))
        assert got[i] == best, (i, got[i], best)


def test_sqrt_is_correctly_rounded():
    """``fused_adam.sqrt`` on the CPU is the correctly rounded f32 root
    (numpy's, and the card's ``__fsqrt_rn``) over values like ``v + eps``,
    where the vectorized f32 ``torch.sqrt`` may be 1 ulp off; the root of
    an exact square stays exact."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(1 << 18, np.float32) * 1e-2 + 1e-8,
                        rng.standard_normal(1 << 16).astype(np.float32)
                        ** 2, np.float32([0.0, 1e-45, 4.0, 2.0 ** 100])])
    got = fused_adam.sqrt(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    assert got.dtype == np.float32 and got[-2] == 2.0


def test_wrappers_check_operands_and_count_no_cpu_launch():
    z = torch.zeros(8, 16)
    cnt = torch.full((8,), 16, dtype=torch.int32)
    before = dict(build.launch_counts)
    with pytest.raises(TypeError):
        onebit.abs_rowsum(z.double(), z.double(), cnt)
    with pytest.raises(ValueError):
        onebit.abs_rowsum(z, torch.zeros(8, 8), cnt)
    with pytest.raises(TypeError):
        onebit.ef_quantize(z, z, torch.zeros(8, dtype=torch.float64), cnt)
    with pytest.raises(ValueError):
        onebit.ef_quantize(torch.zeros(8, 12), torch.zeros(8, 12),
                           torch.zeros(8), cnt)
    with pytest.raises(ValueError):             # 8 rows in groups of 3
        onebit.ef_quantize(z, z, torch.zeros(2), cnt, 3)
    with pytest.raises(ValueError):             # 2 groups of 4, 4 scales
        onebit.ef_quantize(z, z, torch.zeros(4), cnt, 4)
    with pytest.raises(ValueError):
        onebit.abs_rowsum_scales(z, z, cnt, 4, torch.ones(4))
    with pytest.raises(TypeError):
        onebit.abs_rowsum_scales(z, z, cnt, 4, torch.ones(2).double())
    with pytest.raises(TypeError):
        onebit.decompress(torch.zeros(8, 2, dtype=torch.int32),
                          torch.zeros(8))
    with pytest.raises(ValueError):
        fused_adam.fused_local_step(z, z, z, torch.zeros(8, 8), 1e-3, 0.9)
    with pytest.raises(ValueError):
        onebit.ef_compress(torch.zeros(8, 12), torch.zeros(8, 12), cnt)
    with pytest.raises(TypeError):
        onebit.ef_compress(z, z, cnt.long())
    with pytest.raises(ValueError):
        fused_adam.fused_local_step_sgd(z, z, torch.zeros(8, 8), 1e-3, 0.9)
    with pytest.raises(ValueError):
        fused_adam.fused_local_step_sgd(z, torch.zeros(16, 8).t(), z, 1e-3,
                                        0.9)
    onebit.abs_rowsum(z, z, cnt)            # CPU: the plain version
    onebit.abs_rowsum_scales(z, z, cnt, 4, torch.ones(2))
    onebit.ef_quantize(z, z, torch.ones(2), cnt, 4)
    onebit.ef_compress(z, z, cnt)
    fused_adam.fused_local_step_sgd(z, z, z, 1e-3, 0.9)
    assert dict(build.launch_counts) == before


@pytest.mark.parametrize("private", [True, False])
def test_launch_stream_with_and_without_the_private_getter(monkeypatch,
                                                           private):
    # launches take the current stream from torch's private raw getter
    # where this torch has it, else from the public Stream object
    class _Stream:
        cuda_stream = 0xBEEF

    asked = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda card: asked.append(("public", card))
                        or _Stream())
    if private:
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda card: asked.append(("raw", card))
                            or 0xCAFE, raising=False)
    else:
        monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream",
                            raising=False)
    assert build.current_raw_stream(3) == (0xCAFE if private else 0xBEEF)
    assert asked == [("raw" if private else "public", 3)]


# --- launch geometry of the redesigned kernels -------------------------

def _full_frames(arch, n_workers=4):
    """Every (rows, cols) kernel frame of ``arch``'s FULL plan: each leaf's
    worker frame (``n_workers`` stacked) and one worker's own rows."""
    tmpl = TT.model_template(port_get(arch).config)
    plan = make_plan(TL.param_shapes(tmpl), TL.param_specs(tmpl),
                     TL.dp_mask(tmpl), n_workers)
    frames = set()
    for lo in plan.layouts:
        rows, cols = TC.view_rows_cols(lo)
        frames |= {(n_workers * rows, cols), (rows, cols)}
    return sorted(frames)


# widths named by the kernels' design: one column group, a ragged packed
# row, the BERT and gpt2 vocabularies (more than one block per row, and
# a slice beyond the shared-memory budget), and more than 65,535 rows
EDGE_FRAMES = [(70000, 8), (64, 24), (48, 776), (64, 3072), (64, 30720),
               (16, 50432), (8, 70000)]
GEOMETRY_CASES = (["gpt2", "bert-base", "bert-large"]
                  + [f"{r}x{c}" for r, c in EDGE_FRAMES])


def _geometry_frames(case):
    if "x" in case:
        return [tuple(int(v) for v in case.split("x"))]
    return _full_frames(case)


@pytest.mark.parametrize("case", GEOMETRY_CASES)
def test_launch_geometry_covers_every_frame(case):
    """ef_compress: slices a multiple of 8 columns that cover each column
    exactly once, 1-8 blocks per row, shared memory within a block's
    227 KB and every slice kept whole up to 8 x EF_KEPT_COLS columns.
    decompress: the multiply-shift gives the row of every packed byte at
    each row boundary and at the top of the 32-bit index range."""
    for rows, cols in _geometry_frames(case):
        cluster, width, kept = onebit.ef_compress_geometry(cols)
        assert 1 <= cluster <= onebit.EF_MAX_CLUSTER, (cols, cluster)
        assert width % 8 == 0 and 0 < width <= cols, (cols, width)
        spans = [np.arange(k * width, min(cols, (k + 1) * width))
                 for k in range(cluster)]
        assert all(len(sp) for sp in spans), (cols, cluster, width)
        np.testing.assert_array_equal(np.concatenate(spans),
                                      np.arange(cols))
        assert kept % 4 == 0 and 4 <= kept <= width
        assert kept * 4 <= 227 * 1024
        assert (kept == width) == (cols <= 8 * onebit.EF_KEPT_COLS)

        cb = cols // 8
        assert rows * cb < onebit.DECOMPRESS_MAX_BYTES
        mul, shift = onebit.divisor(cb)
        assert 0 < mul < 2 ** 32 and 0 <= shift <= 62
        k = np.arange(1, rows + 1, dtype=np.uint64) * np.uint64(cb)
        top = (2 ** 31 - 1) // cb * cb
        b = np.concatenate([k - np.uint64(1), k, np.array(
            [0, top - 1, top, 2 ** 31 - 1], np.uint64)])
        np.testing.assert_array_equal((b * np.uint64(mul)) >> np.uint64(
            shift), b // np.uint64(cb))


def test_launch_geometry_at_the_design_widths():
    """The shapes the kernel notes name: BERT's 30,720-column rows take 4
    blocks of 7,680 columns, gpt2's 50,432 take 7 blocks of 7,208, all
    kept; 70,000 take 8 blocks of 8,752, each re-reading 1,072 columns;
    narrow rows take one block."""
    assert onebit.ef_compress_geometry(30720) == (4, 7680, 7680)
    assert onebit.ef_compress_geometry(50432) == (7, 7208, 7208)
    assert onebit.ef_compress_geometry(70000) == (8, 8752, 7680)
    assert onebit.ef_compress_geometry(3072) == (1, 3072, 3072)
    assert onebit.ef_compress_geometry(768) == (1, 768, 768)
    assert onebit.ef_compress_geometry(8) == (1, 8, 8)
    assert onebit.divisor(1) == (1, 0)
    assert onebit.divisor(2) == (2 ** 31, 32)
    # exhaustive over every byte of small frames
    for cb in (1, 3, 7, 96, 97, 6304):
        mul, shift = onebit.divisor(cb)
        b = np.arange(1 << 16, dtype=np.uint64)
        np.testing.assert_array_equal(
            (b * np.uint64(mul)) >> np.uint64(shift), b // np.uint64(cb))


# --- the redesigned two-pass compress: geometry and scale groups --------

def _two_pass_frames(arch, n_workers=4, inner=2):
    """Every (rows, cols, group_rows) that the two-pass compress of
    ``arch``'s FULL plan gives its kernels, flat and at ``n_workers //
    inner`` pods x ``inner``, worker and server side, every scale mode,
    ``n_workers`` stacked workers and one alone (the dispatch's own scale
    groups)."""
    tmpl = TT.model_template(port_get(arch).config)
    shapes, specs, dp = (TL.param_shapes(tmpl), TL.param_specs(tmpl),
                         TL.dp_mask(tmpl))
    frames = set()
    for hier in (None, Hierarchy(inner)):
        ni = 1 if hier is None else inner
        for lo in make_plan(shapes, specs, dp, n_workers, hier).layouts:
            rows, cols = TC.view_rows_cols(lo)
            ndim = len(lo.view_shape)
            for stack in (n_workers, 1):
                idx = (None if hier is None
                       else tuple(w % ni for w in range(stack)))
                bshape = lo.view_shape if hier is None else lo.slice_shape
                _, *denoms = dispatch._worker_counts(lo, stack, idx, "cpu")
                widx = tuple(range(stack))
                _, sdenom = dispatch._server_counts(lo, widx, "cpu")
                chunk = (stack, 1) + lo.chunk_shape
                for mode in TC.SCALE_MODES:
                    eff = "chunk" if (mode == "row" and ndim == 2) else mode
                    if not (eff == "row" and ndim == 3):   # single pass
                        d, _ = dispatch._scale_groups(
                            bshape, eff, lo.rest_factor, denoms, stack, "cpu")
                        r = stack * rows // ni
                        frames.add((r, cols, r // d.numel()))
                    if mode == "row" and ndim == 2:
                        continue          # per-element scales: no kernel
                    d = (dispatch._scale_groups(chunk[1:], mode,
                                                lo.rest_factor, None, stack,
                                                "cpu")[0]
                         if mode == "row" else sdenom)
                    r = stack * (rows // lo.n)
                    frames.add((r, cols, r // d.numel()))
    return sorted(frames)


def _exact_below_2_31(d, top_rows):
    """The multiply-shift of :func:`onebit.divisor` at every multiple of d
    up to ``top_rows`` rows, either side of it, and at the top of the
    32-bit index range."""
    mul, shift = onebit.divisor(d)
    assert 0 < mul < 2 ** 32 and 0 <= shift <= 62
    k = np.arange(1, top_rows + 1, dtype=np.uint64) * np.uint64(d)
    top = (2 ** 31 - 1) // d * d
    b = np.concatenate([k - np.uint64(1), k, np.array(
        [0, top - 1, top, 2 ** 31 - 1], np.uint64)])
    np.testing.assert_array_equal((b * np.uint64(mul)) >> np.uint64(shift),
                                  b // np.uint64(d))


@pytest.mark.parametrize("arch", ["gpt2", "bert-base"])
def test_two_pass_geometry_and_divisors_at_full_frames(arch):
    """abs_rowsum's warps and slices cover each float4 column of a row
    exactly once, 512-byte slices when a row has several warps, one warp
    up to 8,192 columns, and its blocks cover every row; ef_quantize's row divisor (float4 f -> row) and
    group divisor (row -> scale group) exact at every row and group
    boundary of the frame and up to the top of the index range, which the
    largest frame stays below."""
    frames = _two_pass_frames(arch)
    assert len({c for _, c, _ in frames}) >= 4
    for rows, cols, group_rows in frames:
        warps, slice4 = onebit.abs_rowsum_geometry(cols)
        c4 = -(-cols // 4)
        assert warps in (1, 2, 4, 8)
        assert (warps == 1) == (cols <= onebit.ROWSUM_WARP_COLS), cols
        if warps > 1:
            assert slice4 % 32 == 0
        spans = [np.arange(k * slice4, min(c4, (k + 1) * slice4))
                 for k in range(warps)]
        assert all(len(sp) for sp in spans), (cols, warps, slice4)
        np.testing.assert_array_equal(np.concatenate(spans), np.arange(c4))
        assert rows % group_rows == 0
        # pass 1's blocks: whole groups a block where a group fits in a
        # block's 8 // warps rows, else single rows; the grid stays below
        # 2**31
        per_block = onebit.ROWSUM_BLOCK_WARPS // warps
        rows_a_block = (per_block // group_rows * group_rows
                        if group_rows <= per_block else per_block)
        assert 0 < -(-rows // rows_a_block) < 2 ** 31
        assert rows * cols // 4 < onebit.EF_QUANTIZE_MAX_FLOAT4
        _exact_below_2_31(cols // 4, rows)
        _exact_below_2_31(group_rows, rows // group_rows)
        assert onebit.ef_quantize_divisors(cols, group_rows) == (
            *onebit.divisor(cols // 4), *onebit.divisor(group_rows))


@pytest.mark.parametrize("rows, cols, group_rows, max_n4", [
    (96, 1040, 1, 1 << 31), (96, 1040, 3, 3 * 260 + 1),
    (96, 1040, 8, 5 * 8 * 260), (96, 1040, 1, 24 * 260 + 7),
    (2 * 524_800, 8192, 524_800, 1 << 31), (0, 64, 1, 1 << 31)])
def test_ef_quantize_slabs_cover_the_frame_in_whole_groups(rows, cols,
                                                           group_rows,
                                                           max_n4):
    """ef_quantize's launches: in row order, whole scale groups each,
    every launch under ``max_n4`` float4 (its 32-bit index), each but the
    last as many groups as fit; one launch where the frame fits."""
    slabs = onebit.ef_quantize_slabs(rows, cols, group_rows, max_n4)
    fit = (max_n4 - 1) // (group_rows * (cols // 4))
    start = 0
    for r0, n in slabs:
        assert r0 == start and r0 % group_rows == 0 and n % group_rows == 0
        assert 0 < n * (cols // 4) < max_n4
        start += n
    assert start == rows
    assert len(slabs) == -(-(rows // group_rows) // fit)
    assert all(n == fit * group_rows for _, n in slabs[:-1])
    if rows * (cols // 4) < max_n4:
        assert len(slabs) == (1 if rows else 0)


def test_ef_quantize_slabs_refuse_a_group_past_the_index():
    with pytest.raises(ValueError, match="scale group"):
        onebit.ef_quantize_slabs(16, 1040, 8, 8 * 260)
    with pytest.raises(ValueError, match="scale group"):
        onebit.ef_quantize_slabs(8, 2 ** 30, 8, onebit.EF_QUANTIZE_MAX_FLOAT4)


def test_abs_rowsum_geometry_depends_on_the_width_alone():
    """The geometry takes the row width and nothing else, so a worker's
    frame alone and a stack of them sum each row (and each group) in the
    same order; the widths the kernel notes name."""
    import inspect
    assert list(inspect.signature(onebit.abs_rowsum_geometry).parameters) \
        == ["cols"]
    assert onebit.abs_rowsum_geometry(768) == (1, 192)
    assert onebit.abs_rowsum_geometry(8192) == (1, 2048)
    assert onebit.abs_rowsum_geometry(8200) == (2, 1056)
    assert onebit.abs_rowsum_geometry(30720) == (4, 1920)
    assert onebit.abs_rowsum_geometry(50432) == (8, 1600)
    assert onebit.abs_rowsum_geometry(70000) == (8, 2208)
    assert onebit.abs_rowsum_geometry(6) == (1, 2)
