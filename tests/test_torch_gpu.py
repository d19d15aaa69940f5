"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Skips where there is no CUDA device. Tolerances: packed bytes, err_out,
decompressed values, the fused steps' m' and u' and the SGD step's delta
bit for bit (one add, compare, subtract or multiply per element, or a
single-rounding FMA, on both sides); abs_rowsum and ef_compress's scales
to 1.5e-5 relative (~128 ulp: the same sum in another order, then one
IEEE divide); ef_compress's err_out bit for bit against the plain
quantizer given the kernel's own scales; the Adam step's delta to 2 ulp.
The redesigned decompress and ef_compress are also held at their edge
shapes (more than 65,535 rows, ragged packed rows and slices, unaligned
operands) to the plain versions: decompress bit for bit, ef_compress's
bytes bit for bit, its scales within 64 ulp (as chip_smoke.py) and equal
from one launch to the next. DistComm over a one-rank NCCL communicator
gives bit for bit what NullComm gives.

The redesigned two-pass compress (abs_rowsum with its scale groups,
ef_quantize against one scale per group) is held at its edge shapes
(all-pad groups, groups within one block and over many, 256- and
50,432-column rows, more than 65,535 rows, unaligned operands): row sums
and scales within 64 ulp of the plain versions, bits and err_out bit for
bit given the kernel's scales, the same bits from launch to launch and
for each group computed alone. At every gpt2-FULL frame, flat and at 2
pods x 2, in every scale mode, each worker's compress (worker and server
side) from a stack of four is bit for bit that worker's compress alone:
what makes a rank of the multi-process regime bitwise its simulated
worker.

The frames of the two-level exchange (stacked workers owning different
inner slices, so different row counts, one slice all pad) are held to the
plain versions by the same bars; the whole two-level exchange on the card
to the CPU's within one bf16 ulp or 1e-6 (its output is rounded to bf16,
after scales that may differ by a few ulp), at least 99% bit for bit.

The baselines' plain step (the gradient and mean styles): its
single-rounding multiply-adds on the card bit for bit the exact
emulation; one step of ``adam`` and of ``one_bit_adam`` (1-bit stage) on
gpt2-smoke on the card against the same step on the CPU, no launch of
the fused local step.

Elastic resharding (``repro_torch.elastic``): the five
``BENCH_elastic.json`` geometries and 4 -> 3 on random state (pads
included) at gpt2-FULL layouts, on the card bit for bit on the CPU.

Serving (``repro_torch.serve``): gpt2-smoke prefill and 8 decodes at
per-row positions on the card against the CPU, logits within 1e-4 and
greedy tokens equal; ``quant_page`` on the card bit for bit the CPU's; a
sign1bit delta publish of gpt2-smoke (kernels 2-4, one launch of each a
bucket, and one decompress a bucket on the subscriber) against the CPU's
plain path, packed bytes bit for bit and chunk scales within 64 ulp;
``blockwise_attn`` against ``dot_attn`` on gpt2 FULL's attention shapes
at S = 8192, within 1e-5.

The communication audit (``repro_torch.analysis``): a gpt2-smoke run on a
``RecordingComm`` bit for bit the plain run on the card, and audited
clean; the audit CLI's 12-entry smoke matrix clean on the card.

The local step in place (``fused_local_step_``, ``fused_local_step_sgd_``:
m and u updated through their own pointers, the delta over the
gradient): m' and u' bit for bit the plain version's, the delta to 2 ulp.
Mixture of experts: llama4-smoke in 4 gloo ranks on one card with the
real expert exchange against 4 simulated workers run against the merged
experts, within 1e-5 (losses) and 1e-4 (params).

Early issue (``TrainerConfig.peel_last_microbatch``): gpt2-smoke in a
world of one over NCCL, each unit's exchange issued from the backward
with asynchronous collectives on the side stream, bit for bit the
sequential step (losses, params, state, the recorded collectives), at
micro-batches 1 and 2; a unit's asynchronous collective that raises
fails the step.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get
from repro_torch.core import compressor as C
from repro_torch.core import onebit_allreduce as AR
from repro_torch.core.comm import DistComm, Hierarchy, NullComm, SimComm
from repro_torch.core.leafwise import flatten_tree, make_plan, unflatten_tree
from repro_torch.kernels import build, dispatch, fused_adam, onebit
from repro_torch.launch import mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _frame(rows, cols, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(rows, cols, device=dev, generator=g)
    e = torch.randn(rows, cols, device=dev, generator=g) * 0.3
    # ragged tails, whole pad rows, full rows, and a one-element row
    cnt = torch.tensor([cols, cols // 2 + 1, 0, 1] * (rows // 4),
                       dtype=torch.int32, device=dev)
    return z, e, cnt


def _ulps(a, b):
    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return int((ai - bi).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(64, 4104), (512, 8192), (8, 50432)])
def test_cuda_kernels_match_plain_versions(rows, cols):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    z, e, cnt = _frame(rows, cols, 7, dev)
    rk = onebit.abs_rowsum(z, e, cnt)
    rp = onebit.abs_rowsum_plain(z, e, cnt)
    torch.testing.assert_close(rk, rp, rtol=1.5e-5, atol=0)
    assert (rk[cnt == 0] == 0).all()
    s = (rp / cnt.clamp_min(1)).contiguous()
    pk, ek = onebit.ef_quantize(z, e, s, cnt)
    pp, ep = onebit.ef_quantize_plain(z, e, s, cnt)
    assert torch.equal(pk, pp) and torch.equal(ek, ep)
    assert torch.equal(onebit.decompress(pk, s),
                       onebit.decompress_plain(pk, s))
    v = e.abs() * 1e-3
    lr = np.float32(1e-3)
    fk = fused_adam.fused_local_step(z, e, z * 1e-3, v, lr, 0.9)
    fp = fused_adam.fused_local_step_plain(z, e, z * 1e-3, v, lr, 0.9)
    assert torch.equal(fk[0], fp[0]) and torch.equal(fk[1], fp[1])
    assert _ulps(fk[2], fp[2]) <= 2


@pytest.mark.gpu
def test_cuda_wrappers_refuse_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    z = torch.zeros(8, 16, device=dev)
    cnt = torch.full((8,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        onebit.abs_rowsum(z, torch.zeros(8, 16), cnt)     # err on the CPU
    with pytest.raises(ValueError):
        onebit.abs_rowsum(z.t(), z.t(), cnt[:1].expand(16).contiguous())
    with pytest.raises(TypeError):
        onebit.decompress(torch.zeros(8, 2, device=dev), torch.zeros(
            8, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(64, 8), (3072, 30720), (48, 3072)])
def test_cuda_single_pass_and_sgd_match_plain_versions(rows, cols):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    z, e, cnt = _frame(rows, cols, 11, dev)
    pk, sk, ek = onebit.ef_compress(z, e, cnt)
    pp, sp, ep = onebit.ef_compress_plain(z, e, cnt)
    assert torch.equal(pk, pp)
    torch.testing.assert_close(sk, sp, rtol=1.5e-5, atol=0)
    assert (sk[cnt == 0] == 0).all()
    assert torch.equal(ek, onebit.ef_quantize_plain(z, e, sk, cnt)[1])
    lr = np.float32(3e-3)
    fk = fused_adam.fused_local_step_sgd(z, e, z * 1e-3, lr, 0.9)
    fp = fused_adam.fused_local_step_sgd_plain(z, e, z * 1e-3, lr, 0.9)
    for a, b in zip(fk, fp):
        assert torch.equal(a, b)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _scales(rows, gen, dev):
    s = torch.rand(rows, device=dev, generator=gen)
    s[::5] = 0.0
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(70000, 8), (37, 8), (64, 24),
                                       (48, 776), (16, 50432),
                                       (3072, 50432)])
def test_cuda_decompress_bitwise(rows, cols):
    """Frames over 65,535 rows, packed rows of 1, 3 and 97 bytes (chunks
    that straddle rows, a ragged last chunk) and gpt2's widest frame."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows + cols)
    packed = torch.randint(0, 256, (rows, cols // 8), dtype=torch.uint8,
                           device=dev, generator=gen)
    s = _scales(rows, gen, dev)
    assert torch.equal(onebit.decompress(packed, s),
                       onebit.decompress_plain(packed, s))


@pytest.mark.gpu
@pytest.mark.parametrize("packed_off,out_off", [(1, 0), (0, 1), (3, 2)])
def test_cuda_decompress_unaligned_operands(packed_off, out_off):
    """Packed bytes off a 4-byte boundary (byte loads) and an output off a
    16-byte boundary (scalar stores): the entry point is called on offset
    pointers, which the wrapper's own allocation never gives."""
    dev = _card()
    rows, cols = 48, 776
    cb = cols // 8
    gen = torch.Generator(device=dev).manual_seed(packed_off + 7 * out_off)
    pbuf = torch.randint(0, 256, (rows * cb + 4,), dtype=torch.uint8,
                         device=dev, generator=gen)
    packed = pbuf[packed_off:packed_off + rows * cb].view(rows, cb)
    s = _scales(rows, gen, dev)
    obuf = torch.full((rows * cols + 4,), 7.0, device=dev)
    build.launch("decompress", "decompress", dev, packed.data_ptr(),
                 s.data_ptr(), obuf.data_ptr() + 4 * out_off, rows, cols,
                 *onebit.divisor(cb))
    torch.cuda.synchronize()
    got = obuf[out_off:out_off + rows * cols].view(rows, cols)
    assert torch.equal(got, onebit.decompress_plain(packed, s))
    # nothing written outside the output
    rest = torch.cat([obuf[:out_off], obuf[out_off + rows * cols:]])
    assert (rest == 7.0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,offset", [
    (64, 8, 0), (48, 776, 0), (64, 3072, 0), (64, 30720, 0),
    (16, 50432, 0), (8, 70000, 0), (70000, 8, 0), (48, 776, 1),
    (16, 50432, 1)])
def test_cuda_ef_compress_clusters(rows, cols, offset):
    """One block per row (8, 776, 3072 columns), clusters of 4 and 7
    (30,720 and 50,432), of 8 whose slices exceed the kept columns
    (70,000), more than 65,535 rows, and operands off a 16-byte boundary
    (scalar loads). Counts full, ragged, 0, 1, random, 8 and cols - 8."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cols + offset)
    n = rows * cols
    z = torch.randn(n + offset, device=dev, generator=gen)[offset:]
    e = torch.randn(n + offset, device=dev, generator=gen)[offset:] * 0.3
    z, e = z.view(rows, cols), e.view(rows, cols)
    pattern = torch.tensor([cols, cols // 2 + 1, 0, 1, 0, 0, 8, cols - 8],
                           dtype=torch.int32)
    pattern[4:6] = torch.randint(0, cols + 1, (2,),
                                 generator=torch.Generator().manual_seed(cols))
    cnt = pattern.repeat(rows // 8).to(dev)
    pk, sk, ek = onebit.ef_compress(z, e, cnt)
    pp, sp, _ = onebit.ef_compress_plain(z, e, cnt)
    assert torch.equal(pk, pp)
    assert _ulps(sk, sp) <= 64
    assert (sk[cnt == 0] == 0).all()
    assert torch.equal(ek, onebit.ef_quantize_plain(z, e, sk, cnt)[1])
    again = onebit.ef_compress(z, e, cnt)
    for a, b in zip((pk, sk, ek), again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_nccl_world_of_one_matches_null_comm(tmp_path):
    """DistComm over a real NCCL communicator of one rank: the exchange
    collectives give bit for bit what NullComm gives, for f32, bf16 and
    uint8 payloads, contiguous and strided, and their events are read
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there")
    dev = mesh.init_workers("nccl", "cuda", rank=0, world_size=1,
                            local_rank=0, local_world=1,
                            init_method=mesh.file_rendezvous(tmp_path))
    try:
        comm, ref = DistComm(), NullComm()
        for name, x in mesh.exchange_payloads(1, dev).items():
            for op in ("all_to_all", "all_gather"):
                got = getattr(comm, op)(x)
                assert got.device == dev, (name, op)
                assert torch.equal(got, getattr(ref, op)(x)), (name, op)
        assert comm.exchange_ms() > 0 and comm.exchange_ms() == 0
    finally:
        torch.distributed.destroy_process_group()


def _nccl_world_of_one_run(tmp_path, peel, extra=()):
    """gpt2-smoke for 8 steps of the audit's schedule in a world of one
    over NCCL, its comm recording: the step records, final params, state
    and recorded collectives, with ``peel_last_microbatch=peel``."""
    from repro_torch.analysis import RecordingComm
    from repro_torch.launch import audit as LA
    from repro_torch.launch import train as TLAUNCH

    tmp_path.mkdir(exist_ok=True)
    dev = mesh.init_workers("nccl", "cuda", rank=0, world_size=1,
                            local_rank=0, local_world=1,
                            init_method=mesh.file_rendezvous(tmp_path))
    try:
        args = TLAUNCH.parse_args(
            ["--arch", "gpt2", "--smoke", "--mode", "dist", "--steps", "8",
             "--batch", "8", "--seq", "32", "--log-every", "8",
             "--device", "cuda", *LA.SCHEDULE, *extra])
        tr = TLAUNCH.make_trainer(
            args, device=dev, comm=RecordingComm(DistComm()),
            trainer_cfg={"peel_last_microbatch": peel})
        assert tr.early_issue() == peel
        res = TLAUNCH.train(args, tr)
        return res, list(tr.comm.log)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("micro_batches", [1, 2])
def test_nccl_early_issue_is_the_sequential_step(tmp_path, micro_batches):
    """A world of one over NCCL, each unit issued from the backward on
    the side stream with asynchronous collectives, against
    ``peel_last_microbatch=False``: losses, params and the optimizer
    state bit for bit, the same collectives in the same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there")
    extra = ["--micro-batches", str(micro_batches)]
    early, log_e = _nccl_world_of_one_run(tmp_path / "early", True, extra)
    seq, log_s = _nccl_world_of_one_run(tmp_path / "seq", False, extra)
    assert [r["losses"] for r in early["records"]] == [
        r["losses"] for r in seq["records"]]
    assert all(r["exchange_ms"] > 0 for r in early["records"] if r["sync"])
    for x, y in zip(flatten_tree(early["params"])[1],
                    flatten_tree(seq["params"])[1], strict=True):
        assert torch.equal(x, y)
    a, b = early["state"], seq["state"]
    for k in ("u", "err_w", "err_s", "anchor"):
        for x, y in zip(getattr(a, k), getattr(b, k), strict=True):
            assert (x is None and y is None) or torch.equal(x, y), k
    for k in a.slots:
        for x, y in zip(a.slots[k], b.slots[k], strict=True):
            assert torch.equal(x, y), k
    assert log_e == log_s


@pytest.mark.gpu
def test_nccl_failing_async_collective_fails_the_step(tmp_path,
                                                      monkeypatch):
    """A unit's asynchronous all_to_all that raises on the unit thread
    fails the step with that error; nothing runs the sequential step in
    its place."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there")
    real = dist.all_to_all_single

    def failing(*a, **k):
        if k.get("async_op"):
            raise RuntimeError("the collective failed")
        return real(*a, **k)

    failing.__name__ = "all_to_all_single"
    monkeypatch.setattr(dist, "all_to_all_single", failing)
    with pytest.raises(RuntimeError, match="the collective failed"):
        _nccl_world_of_one_run(tmp_path, True)


# (shape, spec, n, n_inner): the last of 4 slices all pad; a folded
# flatten leaf with the pad in its last slice; a 3-D view (the single-pass
# ef_compress) and a 4-D view, both padded
SLICE_CASES = [((768,), None, 8, 4), ((100003,), None, 4, 2),
               ((13, 40), (None, "model"), 4, 2),
               ((6, 4, 24), (None, None, "model"), 8, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,spec,n,ni", SLICE_CASES)
def test_cuda_kernels_at_stacked_slice_frames(shape, spec, n, ni):
    """Every stacked worker owns inner slice w % n_inner: one frame whose
    workers have different row counts (and whole rows of zero count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    lo = C.make_layout(shape, spec, n, n_inner=ni)
    rows, cols = C.view_rows_cols(lo)
    j = np.arange(n) % ni
    cnt = torch.as_tensor(C.slice_row_counts(lo)[j].reshape(-1), device=dev)
    R = n * rows // ni
    g = torch.Generator(device=dev).manual_seed(5)
    m = torch.arange(cols, device=dev)[None, :] < cnt[:, None]
    z = torch.randn(R, cols, device=dev, generator=g) * m
    e = torch.randn(R, cols, device=dev, generator=g) * 0.3 * m
    if shape == (768,):
        assert not cnt.view(n, -1)[ni - 1].any()   # an all-pad slice
    rk = onebit.abs_rowsum(z, e, cnt)
    rp = onebit.abs_rowsum_plain(z, e, cnt)
    torch.testing.assert_close(rk, rp, rtol=1.5e-5, atol=0)
    assert (rk[cnt == 0] == 0).all()
    s = (rp.view(n, -1).sum(1) / torch.as_tensor(
        np.maximum(C.slice_true_counts(lo)[0][j], 1.0), dtype=torch.float32,
        device=dev)).repeat_interleave(R // n).contiguous()
    pk, ek = onebit.ef_quantize(z, e, s, cnt)
    pp, ep = onebit.ef_quantize_plain(z, e, s, cnt)
    assert torch.equal(pk, pp) and torch.equal(ek, ep)
    assert torch.equal(onebit.decompress(pk, s),
                       onebit.decompress_plain(pk, s))
    if len(lo.view_shape) == 3:
        pk, sk, ek = onebit.ef_compress(z, e, cnt)
        pp, sp, _ = onebit.ef_compress_plain(z, e, cnt)
        assert torch.equal(pk, pp)
        assert _ulps(sk, sp) <= 64
        assert torch.equal(ek, onebit.ef_quantize_plain(z, e, sk, cnt)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["tensor", "chunk", "row"])
@pytest.mark.parametrize("shape,spec,n,ni", SLICE_CASES)
def test_cuda_hier_exchange_matches_cpu(shape, spec, n, ni, mode):
    """The two-level exchange (SimComm split into pods of n_inner) on the
    card against the same on the CPU, two rounds, the second from the
    CPU's round-one EF state on both: worker-side slice compress through
    the kernels, server compress, both inter-pod decodes; one launch per
    phase for the whole stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    lo = C.make_layout(shape, spec, n, n_inner=ni)
    cfg = AR.OneBitConfig(scale_mode=mode, hierarchy=Hierarchy(ni))
    mask = C.pad_mask(lo)
    mask = 1.0 if mask is None else mask
    g = torch.Generator().manual_seed(6)
    efs = {d: AR.init_ef_state(lo, n, d) for d in ("cpu", "cuda")}
    for _ in range(2):
        z = torch.randn((n,) + lo.view_shape, generator=g) * mask
        build.launch_counts.clear()
        got, efs["cuda"] = AR.onebit_allreduce_view(
            SimComm(n), z.to(dev), efs["cuda"], lo, cfg)
        kernels = dict(build.launch_counts)
        want, efs["cpu"] = AR.onebit_allreduce_view(
            SimComm(n), z, efs["cpu"], lo, cfg)
        got = got.cpu()
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-6)
        assert float((got == want).double().mean()) >= 0.99
        assert (got == got[:1]).all()
        for a, b in zip(efs["cuda"], efs["cpu"]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
        single = mode == "row" and len(lo.view_shape) == 3
        flat_row = mode == "row" and len(lo.view_shape) == 2
        assert kernels.get("ef_compress", 0) == int(single)
        assert kernels["abs_rowsum"] == 2 - single - flat_row
        assert kernels["decompress"] == 2 - flat_row
        efs["cpu"] = AR.EFState(*(t.clone() for t in efs["cpu"]))
        efs["cuda"] = AR.EFState(*(t.to(dev) for t in efs["cpu"]))


# (rows, cols, group_rows, operand offset in floats): groups that fit in
# one pass-1 block (one-row groups, two 3-row groups a block) and larger
# ones, added by the second kernel (a warp per group up to 256 rows, 7,000
# groups of 10; 1,024 threads past that, up to 70,000 rows), 256- and
# 50,432-column rows (8 and 1 rows a block), more than 65,535 rows, ragged
# packed rows, operands off a 16-byte boundary (scalar loads)
TWO_PASS_EDGES = [(64, 256, 1, 0), (48, 776, 3, 0), (64, 256, 16, 0),
                  (4096, 768, 1024, 0), (16, 50432, 4, 0), (16, 50432, 8, 1),
                  (70000, 8, 70000, 0), (70000, 8, 10, 0), (48, 776, 12, 1),
                  (8, 70000, 2, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,group_rows,offset", TWO_PASS_EDGES)
def test_cuda_two_pass_edge_shapes(rows, cols, group_rows, offset):
    """Counts full, ragged, 0 and 1 per row, and the whole second group
    pad (its scale exactly 0 over a denominator clamped to 1)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows + cols + offset)
    n = rows * cols
    z = torch.randn(n + offset, device=dev, generator=gen)[offset:]
    e = torch.randn(n + offset, device=dev, generator=gen)[offset:] * 0.3
    z, e = z.view(rows, cols), e.view(rows, cols)
    cnt = torch.tensor([cols, cols // 2 + 1, 0, 1], dtype=torch.int32,
                       device=dev).repeat(-(-rows // 4))[:rows].contiguous()
    groups = rows // group_rows
    if groups > 1:
        cnt[group_rows:2 * group_rows] = 0
    denoms = cnt.view(groups, group_rows).sum(1).clamp_min(1).float()
    rk, sk = onebit.abs_rowsum_scales(z, e, cnt, group_rows, denoms)
    rp, sp = onebit.abs_rowsum_scales_plain(z, e, cnt, group_rows, denoms)
    assert _ulps(rk, rp) <= 64 and _ulps(sk, sp) <= 64
    assert (rk[cnt == 0] == 0).all()
    if groups > 1:
        assert sk[1] == 0
    assert torch.equal(onebit.abs_rowsum(z, e, cnt), rk)
    pk, ek = onebit.ef_quantize(z, e, sk, cnt, group_rows)
    pp, ep = onebit.ef_quantize_plain(z, e, sk, cnt, group_rows)
    assert torch.equal(pk, pp) and torch.equal(ek, ep)
    again = onebit.abs_rowsum_scales(z, e, cnt, group_rows, denoms)
    assert torch.equal(again[0], rk) and torch.equal(again[1], sk)
    for g in range(min(groups, 4)):
        own = slice(g * group_rows, (g + 1) * group_rows)
        _, sg = onebit.abs_rowsum_scales(z[own], e[own], cnt[own].clone(),
                                         group_rows, denoms[g:g + 1].clone())
        assert torch.equal(sg, sk[g:g + 1]), g


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(37, 6), (9, 50431), (64, 4100)])
def test_cuda_abs_rowsum_odd_widths(rows, cols):
    """Widths that are no multiple of 4 or 8 (scalar loads that stop at
    the row's end)."""
    dev = _card()
    z, e, cnt = _frame(rows - rows % 4, cols, 3, dev)
    rk, rp = onebit.abs_rowsum(z, e, cnt), onebit.abs_rowsum_plain(z, e, cnt)
    assert _ulps(rk, rp) <= 64 and (rk[cnt == 0] == 0).all()


def _gpt2_full_layouts(inner):
    tmpl = T.model_template(get("gpt2").config)
    return make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                     L.dp_mask(tmpl), 4,
                     Hierarchy(inner) if inner else None).layouts


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["tensor", "chunk", "row"])
@pytest.mark.parametrize("inner", [None, 2], ids=["flat", "2x2"])
def test_cuda_compress_is_stack_independent(inner, mode):
    """Every gpt2-FULL leaf: each worker's packed bytes, scales and EF
    error from a stack of four workers (worker side on its view or owned
    slice, server side on the chunk it serves) equal that worker's alone,
    bit for bit."""
    dev = _card()
    n, ni = 4, inner or 1
    g = torch.Generator(device=dev).manual_seed(9)
    for lo in _gpt2_full_layouts(inner):
        idx = None if inner is None else tuple(w % ni for w in range(n))
        shape = lo.view_shape if inner is None else lo.slice_shape
        z = torch.randn((n,) + shape, device=dev, generator=g)
        e = torch.randn((n,) + shape, device=dev, generator=g) * 0.3
        whole = dispatch.ef_compress_view(z, e, lo, mode, idx)
        for w in range(n):
            alone = dispatch.ef_compress_view(
                z[w:w + 1].clone(), e[w:w + 1].clone(), lo, mode,
                None if idx is None else idx[w:w + 1])
            for a, b in zip(whole, alone):
                assert torch.equal(a[w:w + 1], b), (lo.shape, w, "worker")
        if mode == "row" and len(lo.view_shape) == 2:
            continue
        no = lo.n_outer
        widx = tuple((w % ni) * no + w // ni for w in range(n))
        ys = (n, 1) + lo.chunk_shape
        avg = torch.randn(ys, device=dev, generator=g)
        es = torch.randn(ys, device=dev, generator=g) * 0.1
        whole = dispatch.server_compress_view(avg, es, lo, mode, widx)
        for w in range(n):
            alone = dispatch.server_compress_view(
                avg[w:w + 1].clone(), es[w:w + 1].clone(), lo, mode,
                widx[w:w + 1])
            for a, b in zip(whole, alone):
                assert torch.equal(a[w:w + 1], b), (lo.shape, w, "server")
        del z, e, avg, es, whole, alone
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 4096 * 33 + 5])
def test_cuda_fma_is_single_rounding(n):
    """The baselines' plain step: ``fused_adam.fma`` on the card (a
    scalar or a tensor factor, and strided operands, which it makes
    contiguous) bit for bit the exact emulation of one rounding."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n)
    a, b, c = (torch.randn(n, device=dev, generator=g) for _ in range(3))
    b1 = float(np.float32(0.9))    # scalars are taken at f32
    for b_ in (b1, float(np.float32(1e-3)), b):
        assert torch.equal(fused_adam.fma(a, b_, c),
                           fused_adam.fma_f32(a, b_, c))
    assert torch.equal(fused_adam.fma(a, 0.9, c), fused_adam.fma(a, b1, c))
    a2 = torch.randn(64, 40, device=dev, generator=g)[:, 3:]
    c2 = torch.randn(64, 40, device=dev, generator=g)[:, :37]
    assert torch.equal(fused_adam.fma(a2, b1, c2),
                       fused_adam.fma_f32(a2, b1, c2))


def _baseline_step(name, dev, onebit_warmup):
    """One step of ``name`` over gpt2-smoke's leaves, 4 stacked workers,
    from zero state and the same seeded params and gradients on every
    device; returns (params, state, launches by kernel, the gradient
    leaves, the optimizer)."""
    from repro_torch.core import api as TA
    from repro_torch.core import schedules as TS
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree

    tmpl = T.model_template(get("gpt2").smoke)
    shapes = L.param_shapes(tmpl)
    opt = TA.build_optimizer(
        TA.OptimizerConfig(name=name, lr=TS.ConstantLr(1e-3),
                           onebit_warmup=onebit_warmup),
        shapes, specs=L.param_specs(tmpl), dp_mask=L.dp_mask(tmpl),
        n_workers=4)
    rng = np.random.default_rng(5)
    paths, leaves = flatten_tree(shapes)

    def tree(scale):
        return unflatten_tree(paths, [torch.from_numpy(
            (rng.standard_normal((4,) + tuple(s)) * scale).astype(
                np.float32)).to(dev) for s in leaves])

    params, grads = tree(0.02), tree(1.0)
    state = opt.init(params)
    build.launch_counts.clear()
    params, state, met = opt.step(SimComm(4), params, grads, state)
    assert met["synced"]
    return (params, state, dict(build.launch_counts),
            flatten_tree(grads)[1], opt)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["adam", "one_bit_adam"])
def test_cuda_baseline_step_matches_cpu(name):
    """One step of a baseline on gpt2-smoke (one_bit_adam in its 1-bit
    stage: the exchange of the gradient, kernels 2-4) on the card and on
    the CPU from the same inputs: the worker side's packed bits bit for
    bit (same input, sign bits). The full-precision mean and the FMAs
    are the same arithmetic on both (adam's m and v bit for bit); the
    card's rsqrt is within 2 ulp of the CPU's and its scales within a few
    ulp (another sum order), so params and the EF state are held to
    1e-5 relative plus 1e-6 of the tensor's largest magnitude. The fused
    local step never runs (these styles have no u)."""
    from repro_torch.core.leafwise import flatten_tree

    dev = _card()
    xk, sk, launches, gk, opt = _baseline_step(name, dev, 0)
    xc, sc, _, gc, _ = _baseline_step(name, torch.device("cpu"), 0)
    n_leaves = len(flatten_tree(xk)[1])
    want = ({} if name == "adam" else
            {k: 2 * n_leaves for k in ("abs_rowsum", "ef_quantize",
                                       "decompress")})
    assert launches == want and "fused_local_step" not in launches

    def close(a, b):
        b = b.to(a.device)
        torch.testing.assert_close(
            a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()) + 1e-30)

    for a, b in zip(flatten_tree(xk)[1], flatten_tree(xc)[1]):
        close(a, b)
    for k in sc.slots:
        for a, b in zip(sk.slots[k], sc.slots[k]):
            if name == "adam":
                assert torch.equal(a.cpu(), b), k
            close(a, b)
    if name == "one_bit_adam":
        for a, b in zip(sk.err_w + sk.err_s, sc.err_w + sc.err_s):
            close(a, b)
        for ga, gb, lo in zip(gk, gc, opt.layouts):
            pa = dispatch.ef_compress_view(
                C.to_view(ga, lo), torch.zeros((4,) + lo.view_shape,
                                               device=dev), lo, "tensor")[0]
            pb = dispatch.ef_compress_view(
                C.to_view(gb, lo), torch.zeros((4,) + lo.view_shape), lo,
                "tensor")[0]
            assert torch.equal(pa.cpu(), pb), lo.shape
    else:
        assert all(e is None for e in sk.err_w + sk.err_s)


def _bucket_layouts(inner):
    """gpt2 FULL's fused buckets of more than one leaf at 25 MiB."""
    from repro_torch.core import bucketing as BK

    tmpl = T.model_template(get("gpt2").config)
    plan = make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                     L.dp_mask(tmpl), 4, Hierarchy(inner) if inner else None)
    return [b.layout for b in BK.make_bucket_plan(plan, 25).buckets
            if len(b.members) > 1]


@pytest.mark.gpu
@pytest.mark.parametrize("inner", [None, 2], ids=["flat", "2x2"])
def test_cuda_kernels_at_bucket_frames(inner):
    """The frames the bucketed exchange adds (gpt2 FULL's three fused
    buckets, views (4, 4608), (4, 4608), (4, 384)), worker and server
    side, tensor scales, 4 workers stacked: the two-pass compress and
    the decode on the card against the same on the CPU (the plain
    versions): scales within 64 ulp, bits and err_out bit for bit where
    the scales are equal, decoded values bit for bit; and each worker's
    compress from the stack bit for bit that worker's alone."""
    dev = _card()
    n, ni = 4, inner or 1
    g = torch.Generator(device=dev).manual_seed(11)
    los = _bucket_layouts(inner)
    assert [lo.view_shape for lo in los] == [(4, 4608), (4, 4608), (4, 384)]
    idx = None if inner is None else tuple(w % ni for w in range(n))
    widx = tuple((w % ni) * (n // ni) + w // ni for w in range(n))
    for lo in los:
        shape = lo.view_shape if inner is None else lo.slice_shape
        z = torch.randn((n,) + shape, device=dev, generator=g)
        e = torch.randn((n,) + shape, device=dev, generator=g) * 0.3
        ys = (n, 1) + lo.chunk_shape
        avg = torch.randn(ys, device=dev, generator=g)
        es = torch.randn(ys, device=dev, generator=g) * 0.1
        sides = ((dispatch.ef_compress_view, z, e, idx),
                 (dispatch.server_compress_view, avg, es, widx))
        for fn, x, err, which in sides:
            packed, scales, err_out = fn(x, err, lo, "tensor", which)
            pc, sc, ec = fn(x.cpu(), err.cpu(), lo, "tensor", which)
            assert _ulps(scales.cpu(), sc) <= 64, (lo.view_shape, fn)
            if torch.equal(scales.cpu(), sc):    # then every bit agrees
                assert torch.equal(packed.cpu(), pc), (lo.view_shape, fn)
                assert torch.equal(err_out.cpu(), ec), (lo.view_shape, fn)
            out = dispatch.decompress_view(packed, scales, lo)
            assert torch.equal(out.cpu(), dispatch.decompress_view(
                packed.cpu(), scales.cpu(), lo)), (lo.view_shape, fn)
            for w in range(n):
                alone = fn(x[w:w + 1].clone(), err[w:w + 1].clone(), lo,
                           "tensor", None if which is None
                           else which[w:w + 1])
                for a, b in zip((packed, scales, err_out), alone):
                    assert torch.equal(a[w:w + 1], b), (lo.view_shape, w)
        del z, e, avg, es
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_cuda_bucketed_step_matches_cpu():
    """One sync step of zero_one_adam at bucket_mb=4 on gpt2-smoke (15
    units, three multi-leaf buckets), 4 stacked workers, on the card and
    on the CPU from the same inputs: the local step launches per leaf
    (19) and kernels 2-4 per unit (2 x 15); params and state held to 1e-5
    relative plus 1e-6 of each tensor's largest magnitude (scales within
    a few ulp: another sum order)."""
    from repro_torch.core import api as TA
    from repro_torch.core import schedules as TS
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree

    dev = _card()
    tmpl = T.model_template(get("gpt2").smoke)
    shapes = L.param_shapes(tmpl)
    paths, leaves = flatten_tree(shapes)
    rng = np.random.default_rng(6)
    arrays = [[(rng.standard_normal((4,) + tuple(s)) * scale).astype(
        np.float32) for s in leaves] for scale in (0.02, 1.0)]
    out = {}
    for d in (dev, torch.device("cpu")):
        opt = TA.build_optimizer(
            TA.OptimizerConfig(lr=TS.ConstantLr(1e-3), bucket_mb=4.0),
            shapes, specs=L.param_specs(tmpl), dp_mask=L.dp_mask(tmpl),
            n_workers=4)
        params, grads = (unflatten_tree(paths, [
            torch.from_numpy(a).to(d) for a in xs]) for xs in arrays)
        state = opt.init(params)
        build.launch_counts.clear()
        params, state, met = opt.step(SimComm(4), params, grads, state)
        assert met["synced"] and len(opt.units) == 15
        out[d.type] = (flatten_tree(params)[1], state,
                       dict(build.launch_counts))
    (xk, sk, launches), (xc, sc, _) = out["cuda"], out["cpu"]
    assert launches == {"fused_local_step": 19, "abs_rowsum": 30,
                        "ef_quantize": 30, "decompress": 30}

    def close(a, b):
        b = b.to(a.device)
        torch.testing.assert_close(
            a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()) + 1e-30)

    for a, b in zip(xk, xc):
        close(a, b)
    for name in ("u", "err_w", "err_s", "anchor"):
        for a, b in zip(getattr(sk, name), getattr(sc, name)):
            close(a, b)


def _full_layouts(arch):
    tmpl = T.model_template(get(arch).config)
    return make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                     L.dp_mask(tmpl), 4).layouts


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gpt2", "bert-base"])
def test_cuda_trust_is_stack_independent(arch):
    """Every gpt2-FULL and bert-base-FULL leaf: each worker's LAMB trust
    (its norms, then the clipped ratio) from a stack of four equals that
    worker's alone, bit for bit, for the natural-shape params and for a
    leaf's update through its comm view (what keeps a rank of the
    multi-process regime bitwise its simulated worker)."""
    from repro_torch.core.base_steps import lamb_base, worker_l2

    dev = _card()
    base = lamb_base()
    g = torch.Generator(device=dev).manual_seed(10)
    for lo in _full_layouts(arch):
        x = torch.randn((4,) + tuple(lo.shape), device=dev, generator=g)
        r = torch.randn((4,) + lo.view_shape, device=dev, generator=g) * 1e-3
        upd = C.from_view(r, lo)
        whole = (worker_l2(x), base.trust_ratio(x, upd))
        for w in range(4):
            alone = (worker_l2(x[w:w + 1].clone()),
                     base.trust_ratio(x[w:w + 1].clone(),
                                      C.from_view(r[w:w + 1].clone(), lo)))
            for a, b in zip(whole, alone):
                assert torch.equal(a[w:w + 1], b), (lo.shape, w)
        del x, r, upd
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_cuda_lamb_local_step_at_bert_frames():
    """Kernel 1 under kind "lamb" at every bert-base-FULL frame (4
    stacked workers): m' and u' bit for bit its plain version, delta
    within 2 ulp, and the trust-scaled delta within 3 ulp of the trust
    times the plain delta (one more rounding)."""
    from repro_torch.core.base_steps import bcast

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    lr, b1 = np.float32(1.5e-4), 0.9
    for lo in _full_layouts("bert-base"):
        shape = (4,) + lo.view_shape
        gr, m, u = (torch.randn(shape, device=dev, generator=g)
                    for _ in range(3))
        v = torch.rand(shape, device=dev, generator=g) * 1e-4
        trust = torch.rand(4, device=dev, generator=g) * 10
        build.launch_counts.clear()
        # the step updates m and u in place: it steps copies of them
        mk, uk = m.clone(), u.clone()
        dk = dispatch.fused_local_step_view_(gr, mk, uk, v, lr, b1, 1e-8,
                                             lo, kind="lamb")
        assert build.launch_counts == {"fused_local_step": 1}
        rows, cols = C.view_rows_cols(lo)
        f = [a.reshape(4 * rows, cols) for a in (gr, m, u, v)]
        mp, up, dp = fused_adam.fused_local_step_plain(*f, lr, b1)
        assert torch.equal(mk.reshape(mp.shape), mp), lo.shape
        assert torch.equal(uk.reshape(up.shape), up), lo.shape
        assert _ulps(dk.reshape(dp.shape), dp) <= 2, lo.shape
        scaled = bcast(trust, dk) * dk
        want = bcast(trust, dk) * dp.reshape(dk.shape)
        assert _ulps(scaled, want) <= 3, lo.shape
        del gr, m, u, v, mk, uk, dk, f, mp, up, dp
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("inner", [None, 2], ids=["flat", "2x2"])
@pytest.mark.parametrize("codec", ["topk", "qint8", "qint4"])
def test_cuda_dense_codecs_match_cpu(codec, inner):
    """topk (density 0.05), qint8 and qint4 at every gpt2-smoke frame, 4
    stacked workers, flat and at 2 pods x 2: the worker encode (payload
    and EF residual), its decode, the server's mean over the senders
    (qint: the first product, then one FMA a sender), the server encode
    and the whole exchange (its estimate and both EF errors) on the card
    bit for bit the same on the CPU (topk on values with ties at the k-th
    magnitude, which both devices break as the reference does)."""
    from repro_torch.core import codecs as CD

    dev = _card()
    c = CD.make_codec(codec, 0.05 if codec == "topk" else None)
    cfg = AR.OneBitConfig(codec=c, hierarchy=Hierarchy(inner)
                          if inner else None)
    tmpl = T.model_template(get("gpt2").smoke)
    layouts = make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                        L.dp_mask(tmpl), 4,
                        Hierarchy(inner) if inner else None).layouts
    rng = np.random.default_rng(12)
    for lo in layouts:
        m = C.pad_mask(lo)
        m = 1.0 if m is None else m.numpy()
        z = (rng.standard_normal((4,) + lo.view_shape) * m).astype(
            np.float32)
        if codec == "topk":
            z = np.round(z * 2) / 2     # ties at the k-th magnitude
        e = (rng.standard_normal((4,) + lo.ef_worker_shape) * 0.3).astype(
            np.float32)
        es = (rng.standard_normal((4,) + lo.chunk_shape) * 0.1).astype(
            np.float32)
        out = []
        for d in (dev, torch.device("cpu")):
            zt, et, est = (torch.from_numpy(a).to(d) for a in (z, e, es))
            res = []
            if inner is None:
                p, err = c.encode_worker(zt, et, lo, "tensor")
                recv = {k: SimComm(4).all_to_all(v) for k, v in p.items()}
                res = [c.decode(p, lo), err, c.decode_mean(recv, lo)]
                ps, errs = c.encode_server(res[2], est, lo, "tensor",
                                           np.arange(4))
                res += [c.decode(ps, lo), errs]
            o, ef = AR.onebit_allreduce_view(SimComm(4), zt,
                                             AR.EFState(et, est), lo, cfg)
            out.append(res + [o, ef.err_worker, ef.err_server])
        for a, b in zip(*out):
            assert torch.equal(a.cpu(), b), (codec, lo.shape)


# gpt2 FULL without its three largest kinds of leaf (the two embedding
# tables and the MLP weights): every layout kind the reshard meets
# (structured and flatten views, fused buckets), at ~3 GB of state
ELASTIC_DROP = (("embed",), ("pos_embed",), ("blocks", "mlp", "w_in"),
                ("blocks", "mlp", "w_out"))
# name: (inner, bucket_mb, n_from, n_to, survivors)
ELASTIC_SCENARIOS = {
    "flat_4to4_identity": (None, None, 4, 4, None),
    "flat_4to2_kill1": (None, None, 4, 2, (0, 2)),
    "flat_2to4_grow": (None, None, 2, 4, None),
    "hier_4to2_podkill": (2, None, 4, 2, (0, 1)),
    "bucketed_4to2_kill1": (None, 25.0, 4, 2, (0, 2)),
    "flat_4to3_kill2": (None, None, 4, 3, (0, 1, 3)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("scenario", list(ELASTIC_SCENARIOS))
def test_cuda_reshard_matches_cpu(scenario):
    """``reshard_trainer`` of one random stacked (params, state) (every
    tensor, pads too, drawn on the card) on the card and on the CPU:
    every output tensor bit for bit, the host scalars equal."""
    import dataclasses
    import types

    from repro_torch import elastic as E
    from repro_torch import interop
    from repro_torch.checkpointing import io as ckpt_io
    from repro_torch.core import api as TA
    from repro_torch.core.leafwise import flatten_tree, unflatten_tree

    dev = _card()
    inner, bucket_mb, n, m, survivors = ELASTIC_SCENARIOS[scenario]
    tmpl = T.model_template(get("gpt2").config)
    keep = [(p, s, sp) for p, s, sp in zip(
        *flatten_tree(L.param_shapes(tmpl)),
        flatten_tree(L.param_specs(tmpl))[1]) if p not in ELASTIC_DROP]
    paths = [p for p, _, _ in keep]
    shapes = unflatten_tree(paths, [s for _, s, _ in keep])
    specs = unflatten_tree(paths, [sp for _, _, sp in keep])
    cfg = TA.OptimizerConfig(hierarchy=Hierarchy(inner) if inner else None,
                             bucket_mb=bucket_mb)
    src, dst = (types.SimpleNamespace(opt=TA.build_optimizer(
        cfg, shapes, specs=specs, n_workers=w)) for w in (n, m))
    g = torch.Generator(device=dev).manual_seed(11)
    params = unflatten_tree(paths, [
        torch.randn((n,) + tuple(s), device=dev, generator=g)
        for _, s, _ in keep])
    state = src.opt.init(params)
    for xs in [*state.slots.values(), state.u, state.err_w, state.err_s,
               state.anchor]:
        for x in xs:
            x.copy_(torch.randn(x.shape, device=dev, generator=g))
    out = []
    for d in (dev, torch.device("cpu")):
        moved = {name: [None if x is None else x.to(d) for x in xs]
                 for name, xs in [("u", state.u), ("err_w", state.err_w),
                                  ("err_s", state.err_s),
                                  ("anchor", state.anchor)]}
        moved["slots"] = {k: [x.to(d) for x in xs]
                          for k, xs in state.slots.items()}
        p, st = E.reshard_trainer(
            src, dst, unflatten_tree(paths, [
                x.to(d) for x in flatten_tree(params)[1]]),
            dataclasses.replace(state, **moved), survivors=survivors)
        out.append(ckpt_io.flatten({"params": p, "state":
                                    interop.state_to_reference(st)}))
        del p, st, moved
    (pk, lk, tk), (pc, lc, tc) = out
    assert pk == pc and tk == tc
    assert lk[0].shape[0] == m
    for path, a, b in zip(pk, lk, lc):
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda" and a.is_contiguous(), path
            assert a.dtype == b.dtype and torch.equal(
                a.cpu().view(torch.int32), b.view(torch.int32)), path
        else:
            assert np.array_equal(a, b), path


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    return tree.to(d)


@pytest.mark.gpu
def test_cuda_decode_matches_cpu():
    """gpt2-smoke: a prefill of three prompts of different lengths into
    their own lanes, then 8 batched greedy decodes at per-row positions,
    on the card and on the CPU from the same params."""
    dev = _card()
    cfg = get("gpt2").smoke
    params = L.init_params(T.model_template(cfg), 0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (1, n)) for n in (5, 9, 12)]
    runs = []
    for d in (dev, torch.device("cpu")):
        p = _to(params, d)
        cache = T.init_cache(cfg, 3, 32, torch.float32, d)
        first = []
        for b, pr in enumerate(prompts):
            lane = {k: c[:, b:b + 1] for k, c in cache.items()}
            lg, _ = T.prefill(p, cfg, {"tokens": torch.from_numpy(pr).to(d)},
                              lane)
            first.append(lg[0, -1, :cfg.vocab])
        logits, toks = [torch.stack(first).cpu()], []
        pos = torch.tensor([pr.shape[1] for pr in prompts], device=d)
        for _ in range(8):
            toks.append(logits[-1].argmax(-1))
            lg, cache = T.decode(p, cfg, toks[-1][:, None].to(d), cache, pos)
            logits.append(lg[:, 0, :cfg.vocab].cpu())
            pos = pos + 1
        runs.append((torch.stack(logits), torch.stack(toks), cache["k"].cpu()))
    (lk, tk, ck), (lc, tc, cc) = runs
    assert float((lk - lc).abs().max()) <= 1e-4
    assert torch.equal(tk, tc)
    assert float((ck - cc).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quant_page_matches_cpu(dtype):
    """Every page of 3 slots of a random cache, each page at its own
    magnitude, and an all-zero page: the card's ``quant_page`` bit for
    bit the CPU's."""
    from repro_torch.serve.scheduler import quant_page

    dev = _card()
    g = torch.Generator().manual_seed(5)
    shape = (12, 3, 64, 12, 64)
    mag = torch.exp(torch.rand((1, 3, 4, 1, 1, 1), generator=g) * 6 - 5)
    base = {k: (torch.randn(shape, generator=g).reshape(
        12, 3, 4, 16, 12, 64) * mag).reshape(shape).to(dtype)
        for k in ("k", "v")}
    for k in base:
        base[k][:, 2, 16:32] = 0
    card = {k: v.to(dev) for k, v in base.items()}
    cpu = {k: v.clone() for k, v in base.items()}
    for slot in range(3):
        for start in range(0, 64, 16):
            quant_page(card, slot, start, 16, 64)
            quant_page(cpu, slot, start, 16, 64)
    for k in cpu:
        assert torch.equal(card[k].cpu(), cpu[k])
        assert not torch.equal(cpu[k], base[k])


@pytest.mark.gpu
def test_cuda_sign1bit_publish_matches_cpu():
    """A snapshot and a sign1bit delta of gpt2-smoke params, per leaf
    (one bucket a leaf) and at the default 4 MiB (one bucket): on the
    card the delta's encode launches kernels 2-4 once each a bucket and
    the subscriber's anchor advance one decompress a bucket; packed bytes
    bit for bit the CPU plain path's from the same params and anchors,
    chunk scales within 64 ulp; the subscriber's anchors bit for bit the
    publisher's."""
    from repro_torch.serve import Publisher, PublishConfig, Subscriber

    dev = _card()
    cfg = get("gpt2").smoke
    p0 = L.init_params(T.model_template(cfg), 0)
    g = torch.Generator().manual_seed(9)
    p1 = _perturb(p0, g)
    for bucket_mb in (None, 4.0):
        pc = PublishConfig(codec="sign1bit", bucket_mb=bucket_mb)
        ups = []
        for d in (dev, torch.device("cpu")):
            pub, sub = Publisher(_to(p0, d), pc), Subscriber(_to(p0, d), pc)
            sub.apply(pub.publish(_to(p0, d)))
            build.launch_counts.clear()
            u = pub.publish(_to(p1, d))
            enc = dict(build.launch_counts)
            build.launch_counts.clear()
            sub.apply(u)
            dec = dict(build.launch_counts)
            assert all(torch.equal(a, b) for a, b in zip(pub._anchor,
                                                         sub._anchor))
            ups.append((u, enc, dec, len(pub.wire.bp.buckets)))
        (uk, enc, dec, nb), (uc, enc_c, dec_c, _) = ups
        assert uk.kind == "delta" and uk.manifest == uc.manifest
        assert enc == {"abs_rowsum": nb, "ef_quantize": nb,
                       "decompress": nb}
        assert dec == {"decompress": nb} and enc_c == dec_c == {}
        for a, b in zip(uk.payloads, uc.payloads):
            assert np.array_equal(a["packed"], b["packed"])
            assert _ulps(torch.from_numpy(a["scales"]),
                         torch.from_numpy(b["scales"])) <= 64


def _perturb(tree, g):
    if isinstance(tree, dict):
        return {k: _perturb(tree[k], g) for k in sorted(tree)}
    return tree + 1e-3 * torch.randn(tree.shape, generator=g)


@pytest.mark.gpu
def test_cuda_blockwise_matches_dot_attn_at_8k():
    """gpt2 FULL's attention shapes (12 heads of 64) at S = 8192, causal:
    the flash-style blockwise path against the dense softmax, within
    1e-5 (the same products, in blocks, with an online softmax)."""
    from repro_torch.models import attention as A

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(4)
    S = 8192
    q, k, v = (torch.randn((1, S, 12, 64), device=dev, generator=g)
               for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    bw = A.blockwise_attn(q, k, v, pos, pos, "causal")
    dense = A.dot_attn(q, k, v, A._mask_bias(pos, pos, "causal"))
    assert float((bw - dense).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_cuda_recording_comm_is_bitwise_transparent():
    """gpt2-smoke, 4 simulated workers on the card, 8 steps of the audit's
    schedule (syncs, variance rounds, local-only steps): with a
    RecordingComm around the SimComm the losses and params are the plain
    run's bit for bit, and the recorded run passes the audit."""
    from repro_torch.analysis import RecordingComm, audit_trainer, watch
    from repro_torch.launch import audit as LA
    from repro_torch.launch import train as TLAUNCH

    _card()
    argv = ["--arch", "gpt2", "--smoke", "--mode", "sim", "--workers", "4",
            "--steps", "8", "--batch", "8", "--seq", "32", "--log-every",
            "1", *LA.SCHEDULE]
    args = TLAUNCH.parse_args(argv)
    plain = TLAUNCH.train(args, TLAUNCH.make_trainer(args))
    tr = TLAUNCH.make_trainer(args, comm=RecordingComm(SimComm(4)))
    trace = watch(tr)
    rec = TLAUNCH.train(args, tr)
    assert [r["losses"] for r in rec["records"]] == [
        r["losses"] for r in plain["records"]]
    for x, y in zip(flatten_tree(plain["params"])[1],
                    flatten_tree(rec["params"])[1]):
        assert torch.equal(x, y)
    rep = audit_trainer(tr, trace=trace)
    assert rep.ok, rep.violations[:3]


@pytest.mark.gpu
def test_cuda_audit_smoke_matrix_is_clean():
    """The audit CLI's 12-entry smoke matrix on the card, kernels 1-4
    launched: every entry clean, frames included."""
    from repro_torch.launch import audit as LA

    _card()
    for kw in LA._matrix(4):
        rec = LA.audit_one("gpt2", device="cuda", **kw)
        assert rec["ok"], (kw, rec["violations"][:3], rec["frame_issues"])



# --------------------------------------------------------------------- #
# the dense rotary family (granite, phi4, chatglm3, gemma3)
# --------------------------------------------------------------------- #

@pytest.mark.gpu
def test_cuda_family_layers_match_cpu():
    """rms_norm, swiglu, partial rotary at gemma3's theta, the sliding
    mask through ``dot_attn``, sliding ``blockwise_attn`` and sliding and
    ring ``decode_attn`` (per-row positions) on the card against the
    CPU, within 1e-5 (f32 products in another order)."""
    from repro_torch.models import attention as A
    from repro_torch.models import rope as R

    dev = _card()
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 40, 64, generator=g)
    scale = torch.randn(64, generator=g) * 0.1
    w = {k: torch.randn(s, generator=g) * 0.02 for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    q = torch.randn(2, 40, 4, 32, generator=g)
    k = torch.randn(2, 40, 2, 32, generator=g)
    v = torch.randn(2, 40, 2, 32, generator=g)
    pos = torch.arange(40, dtype=torch.int32)
    cache = torch.randn(4, 8, 2, 32, generator=g)
    qd = torch.randn(4, 1, 4, 32, generator=g)
    rows = torch.tensor([3, 7, 9, 20])

    def run(d):
        def t(a):
            return a.to(d)
        return [
            L.rms_norm(t(x), t(scale)),
            L.apply_mlp({n: t(a) for n, a in w.items()}, t(x), "swiglu"),
            R.apply_rope(t(q), t(pos)[None].expand(2, -1), 1e6, 0.5),
            A.dot_attn(t(q), t(k), t(v), A._mask_bias(t(pos), t(pos),
                                                      "sliding", 8)),
            A.blockwise_attn(t(q), t(k), t(v), t(pos), t(pos), "sliding", 8,
                             bq=16, bk=8),
            A.decode_attn(t(qd), t(cache), t(cache), t(rows), "sliding", 6),
            A.decode_attn(t(qd), t(cache), t(cache), t(rows), "sliding", 8,
                          ring=True)]

    for a, b in zip(run(dev), run(cpu)):
        assert a.is_cuda
        assert float((a.cpu() - b).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_cuda_kernels_at_a_granite_frame():
    """Kernels 1-4 at granite-3-8b FULL's largest layer frame of run 9a
    (``blocks/mlp/w_gate`` of 2 layers, 2 workers stacked: (16384,
    12800)), worker and server side, against their plain versions: m'
    and u' bit for bit, delta within 2 ulp, row sums and scales within 64
    ulp, packed bytes, err_out and decoded values bit for bit."""
    import dataclasses

    dev = _card()
    cfg = dataclasses.replace(get("granite-3-8b").config, n_layers=2)
    tmpl = T.model_template(cfg)
    plan = make_plan(L.param_shapes(tmpl), L.param_specs(tmpl),
                     L.dp_mask(tmpl), 2)
    lo = plan.layouts[plan.paths.index(("blocks", "mlp", "w_gate"))]
    rows, cols = C.view_rows_cols(lo)
    assert (2 * rows, cols) == (16384, 12800)
    gen = torch.Generator(device=dev).manual_seed(9)
    cnt = torch.as_tensor(np.tile(C.view_row_counts(lo), 2), device=dev)
    g, m, u = (torch.randn(2 * rows, cols, device=dev, generator=gen)
               for _ in range(3))
    vv = torch.randn(2 * rows, cols, device=dev, generator=gen).square()
    lr = np.float32(1.5e-4)
    fk = fused_adam.fused_local_step(g, m, u * 1e-3, vv * 1e-4, lr, 0.9)
    fp = fused_adam.fused_local_step_plain(g, m, u * 1e-3, vv * 1e-4, lr,
                                           0.9)
    assert torch.equal(fk[0], fp[0]) and torch.equal(fk[1], fp[1])
    assert _ulps(fk[2], fp[2]) <= 2
    del fk, fp, vv
    total, _ = C.true_counts(lo)
    for frame_rows, counts, groups in (
            (2 * rows, cnt, 2),
            (rows, torch.as_tensor(C.chunk_row_counts(lo).reshape(-1),
                                   device=dev), 2)):
        z, e = g[:frame_rows] * 0.5, m[:frame_rows] * 0.1
        d = torch.full((groups,), float(total), device=dev)
        gr = frame_rows // groups
        rk, sk = onebit.abs_rowsum_scales(z, e, counts, gr, d)
        rp, sp = onebit.abs_rowsum_scales_plain(z, e, counts, gr, d)
        assert _ulps(rk, rp) <= 64 and _ulps(sk, sp) <= 64
        pk, ek = onebit.ef_quantize(z, e, sk, counts, gr)
        pp, ep = onebit.ef_quantize_plain(z, e, sk, counts, gr)
        assert torch.equal(pk, pp) and torch.equal(ek, ep)
        s = sk.repeat_interleave(gr)
        assert torch.equal(onebit.decompress(pk, s),
                           onebit.decompress_plain(pk, s))


@pytest.mark.gpu
@pytest.mark.parametrize("group_rows", [1, 3, 8])
def test_cuda_ef_quantize_launches_in_slabs(group_rows):
    """The launcher with a slab limit of 24 groups' float4 and less: the
    frame goes in slabs of whole scale groups, one counted launch each,
    bit for bit one launch's bits and err_out (the plain version)."""
    dev = _card()
    rows, cols = 96, 1040
    z, e, cnt = _frame(rows, cols, 3, dev)
    s = torch.rand(rows // group_rows, device=dev) + 0.1
    want = onebit.ef_quantize_plain(z, e, s, cnt, group_rows)
    c4 = cols // 4
    for max_n4 in (group_rows * c4 + 1, 5 * group_rows * c4,
                   24 * group_rows * c4 + 7, 1 << 31):
        packed = torch.full((rows, cols // 8), 7, dtype=torch.uint8,
                            device=dev)
        err_out = torch.full_like(z, 7.0)
        slabs = onebit.ef_quantize_slabs(rows, cols, group_rows, max_n4)
        build.launch_counts.clear()
        onebit._launch_ef_quantize(z, e, s, cnt, packed, err_out,
                                   group_rows, slabs)
        torch.cuda.synchronize()
        assert build.launch_counts["ef_quantize"] == len(slabs), max_n4
        assert torch.equal(packed, want[0]) and torch.equal(err_out,
                                                            want[1]), max_n4


@pytest.mark.gpu
def test_cuda_ef_quantize_past_2_31_float4():
    """A frame of 2**31 + 2**21 float4 (8.6e9 elements, two scale groups
    of 2**30 + 2**20), the size of gemma3-12b FULL's MLP frames at 4
    stacked workers: ef_quantize launches one slab a group; the rows at
    both ends and across the slab boundary bit for bit the plain version
    on those rows. Needs ~70 GB of device memory (z doubles as err)."""
    dev = _card()
    if torch.cuda.get_device_properties(dev).total_memory < 79e9:
        pytest.skip("needs an 80 GB card: the frame alone is 34 GB")
    cols, per = 8192, 524_800          # 2048 float4 a row
    rows = 2 * per
    assert rows * cols // 4 == 2 ** 31 + 2 ** 21
    gen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(rows, cols, device=dev, generator=gen)
    cnt = torch.full((rows,), cols, dtype=torch.int32, device=dev)
    cnt[per - 1] = 5
    s = torch.tensor([0.7, 1.3], device=dev)
    build.launch_counts.clear()
    packed, err_out = onebit.ef_quantize(z, z, s, cnt, per)
    torch.cuda.synchronize()
    assert build.launch_counts["ef_quantize"] == 2
    for lo_, hi_ in ((0, 4), (per - 4, per + 4), (rows - 4, rows)):
        g0 = lo_ // per
        sl = slice(lo_, hi_)
        groups = s[torch.arange(lo_, hi_, device=dev) // per]
        pp, ep = onebit.ef_quantize_plain(z[sl], z[sl], groups, cnt[sl], 1)
        assert torch.equal(packed[sl], pp), (lo_, g0)
        assert torch.equal(err_out[sl], ep), (lo_, g0)


@pytest.mark.gpu
def test_cuda_window_cache_matches_full_cache():
    """gemma3-smoke on the card: 24 decode steps from position 0 (> 2x the
    window of 8) with the ring cache against the full cache within 2e-4
    (the reference's bar), and against the CPU's ring run within 1e-4;
    then a prefill of 13 tokens into each cache and 8 decodes at per-row
    positions, within 2e-4."""
    import dataclasses

    dev = _card()
    cfg = get("gemma3-12b").smoke
    wcfg = dataclasses.replace(cfg, window_cache=True)
    params = L.init_params(T.model_template(cfg), 0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 24)))
    runs = {}
    for name, c, d in (("full", cfg, dev), ("ring", wcfg, dev),
                       ("ring_cpu", wcfg, torch.device("cpu"))):
        p = _to(params, d)
        cache = T.init_cache(c, 2, 32, torch.float32, d)
        runs[name] = torch.stack([T.decode(p, c, toks[:, i:i + 1].to(d),
                                           cache, i)[0].cpu()
                                  for i in range(24)])
    assert float((runs["ring"] - runs["full"]).abs().max()) <= 2e-4
    assert float((runs["ring"] - runs["ring_cpu"]).abs().max()) <= 1e-4
    p = _to(params, dev)
    caches = [T.init_cache(c, 2, 40, torch.float32, dev) for c in (cfg, wcfg)]
    t = toks.to(dev)
    outs = [T.prefill(p, c, {"tokens": t[:, :13]}, k)[0]
            for c, k in zip((cfg, wcfg), caches)]
    assert float((outs[0] - outs[1]).abs().max()) <= 2e-4
    pos = torch.tensor([13, 13], device=dev)
    for i in range(8):
        a = T.decode(p, cfg, t[:, 13 + i:14 + i], caches[0], pos + i)[0]
        b = T.decode(p, wcfg, t[:, 13 + i:14 + i], caches[1], pos + i)[0]
        assert float((a - b).abs().max()) <= 2e-4, i


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["adam", "sgd"])
@pytest.mark.parametrize("rows,cols", [(64, 4104), (37, 99), (8, 50432)])
def test_cuda_local_step_in_place_matches_plain(kind, rows, cols):
    """Kernel 1 as the optimizer calls it: m and u updated through the
    same pointers, the delta written over the gradient (aliased), on
    aligned and unaligned lengths, against the plain version of the same
    inputs: m' and u' bit for bit, the delta to 2 ulp (the SGD delta bit
    for bit); the storage of m, u and g kept."""
    dev = _card()
    z, e, _ = _frame(rows, cols, 5, dev)
    g, m, u = z.clone(), e.clone(), z * 1e-3
    v = e.abs() * 1e-3
    lr = np.float32(1e-3)
    ptrs = (g.data_ptr(), m.data_ptr(), u.data_ptr())
    if kind == "adam":
        want = fused_adam.fused_local_step_plain(g, m, u, v, lr, 0.9)
        d = fused_adam.fused_local_step_(g, m, u, v, lr, 0.9, d=g)
    else:
        want = fused_adam.fused_local_step_sgd_plain(g, m, u, lr, 0.9)
        d = fused_adam.fused_local_step_sgd_(g, m, u, lr, 0.9, d=g)
    torch.cuda.synchronize()
    assert (d.data_ptr(), m.data_ptr(), u.data_ptr()) == ptrs
    assert torch.equal(m, want[0]) and torch.equal(u, want[1])
    assert _ulps(g, want[2]) <= (2 if kind == "adam" else 0)


@pytest.mark.gpu
def test_cuda_merged_expert_sim_matches_gloo_exchange(tmp_path):
    """llama4-smoke (4 experts) in 4 gloo ranks on one card exchanging
    their tokens for real, against 4 simulated workers on the card run
    against the merged experts: losses within 1e-5 and params within
    1e-4 of each rank's simulated worker (an expert's gradient summed in
    another order), each rank audited clean."""
    import pathlib

    from repro_torch.launch import train as launch

    _card()
    argv = ["--arch", "llama4-scout-17b-a16e", "--smoke", "--steps", "8",
            "--batch", "8", "--seq", "32", "--sync-warmup", "2",
            "--double-every", "2", "--kappa", "1", "--lr", "3e-4",
            "--log-every", "8"]
    sim_args = launch.parse_args(argv + ["--mode", "sim", "--workers", "4"])
    sim = launch.train(sim_args, launch.make_trainer(sim_args))
    mesh.spawn(launch.rank_main, 4,
               (argv + ["--mode", "dist", "--backend", "gloo", "--device",
                        "cuda:0", "--workers", "4"], 4,
                mesh.file_rendezvous(tmp_path), str(tmp_path), False, "lm",
                True), timeout_s=600)
    for r in range(4):
        res = torch.load(pathlib.Path(tmp_path) / f"rank{r}.pt")
        assert res["audit"]["ok"], res["audit"]["violations"][:3]
        for got, want in zip(res["records"], sim["records"]):
            assert abs(got["losses"][0] - want["losses"][r]) <= 1e-5
        for a, b in zip(flatten_tree(res["params"])[1],
                        flatten_tree(sim["params"])[1]):
            assert float((a[0] - b[r].cpu()).abs().max()) <= 1e-4, r


# --------------------------------------------------------------------- #
# the state-space family (mamba2, zamba2)
# --------------------------------------------------------------------- #

def _ssd_inputs(g, b=2, L=64, h=4, p=8, n=6, dt_zero=False):
    xh = torch.randn(b, L, h, p, generator=g)
    raw = torch.zeros(b, L, h) if dt_zero else torch.randn(b, L, h,
                                                          generator=g)
    dt = torch.nn.functional.softplus(raw)
    A = -torch.ones(h) if dt_zero else -torch.exp(torch.randn(h,
                                                              generator=g))
    return (xh, dt, A, torch.randn(b, L, h, n, generator=g),
            torch.randn(b, L, h, n, generator=g),
            torch.randn(b, h, p, n, generator=g))


@pytest.mark.gpu
def test_cuda_ssd_and_ssm_layer_match_cpu():
    """``ssd_chunked`` (output and final state, with an initial state) and
    layer 0 of mamba2-smoke's ``ssm_forward`` in its three modes (train,
    prefill into a state, three decodes) on the card against the CPU,
    within 1e-5 (f32 sums in another order)."""
    from repro_torch.models import ssm as SSM

    dev = _card()
    cpu = torch.device("cpu")
    args = _ssd_inputs(torch.Generator().manual_seed(3))
    got = SSM.ssd_chunked(*[a.to(dev) for a in args[:5]], 16,
                          args[5].to(dev))
    want = SSM.ssd_chunked(*args[:5], 16, args[5])
    for a, b in zip(got, want):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-5
    cfg = get("mamba2-2.7b").smoke
    params = L.init_params(T.model_template(cfg), 0)
    lp = {k: v[0] for k, v in params["blocks"]["ssm"].items()}
    x = torch.randn(2, 19, cfg.d_model, generator=torch.Generator(
    ).manual_seed(4))

    def run(d):
        p = {k: v.to(d) for k, v in lp.items()}
        outs = [SSM.ssm_forward(p, cfg, x[:, :16].to(d))[0]]
        st = SSM.init_ssm_state(cfg, 2, device=d)
        outs.append(SSM.ssm_forward(p, cfg, x[:, :16].to(d), state=st)[0])
        for i in range(16, 19):
            outs.append(SSM.ssm_forward(p, cfg, x[:, i:i + 1].to(d),
                                        state=st, decode=True)[0])
        return [o.cpu() for o in outs] + [v.cpu() for v in st.values()]

    for a, b in zip(run(dev), run(cpu)):
        assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_cuda_ssd_gradient_finite_at_chunk_256():
    """The published chunk on a 2-head toy (dt = softplus(0), A = -1): the
    gradient of dt on the card finite, and within 1e-5 of the card's own
    chunk-64 gradient and of the CPU's."""
    from repro_torch.models import ssm as SSM

    dev = _card()
    args = _ssd_inputs(torch.Generator().manual_seed(5), L=256, h=2, p=4,
                       n=4, dt_zero=True)[:5]

    def grad(d, chunk):
        ins = [a.to(d) for a in args]
        ins[1].requires_grad_(True)
        SSM.ssd_chunked(*ins, chunk)[0].sum().backward()
        return ins[1].grad.cpu()

    g256 = grad(dev, 256)
    assert torch.isfinite(g256).all()
    scale = max(1.0, float(g256.abs().max()))
    assert float((g256 - grad(dev, 64)).abs().max()) <= 1e-5 * scale
    assert float((g256 - grad(torch.device("cpu"), 256)).abs().max()) <= \
        1e-5 * scale


@pytest.mark.gpu
def test_cuda_zamba2_decode_with_per_row_positions():
    """zamba2-smoke on the card: two rows prefilled with 8 and 16 tokens
    into their lanes, then 6 batched decodes at per-row positions (the
    shared block's KV slots written per row), against the CPU's run,
    logits within 1e-4 and greedy tokens equal."""
    dev = _card()
    cfg = get("zamba2-1.2b").smoke
    params = L.init_params(T.model_template(cfg), 0)
    rng = np.random.default_rng(6)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, (1, n)))
               for n in (8, 16)]
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 6)))

    def run(d):
        p = _to(params, d)
        cache = T.init_cache(cfg, 2, 32, torch.float32, d)
        for r, pr in enumerate(prompts):
            lane = {k: {kk: vv[:, r:r + 1] for kk, vv in v.items()}
                    for k, v in cache.items()}
            T.prefill(p, cfg, {"tokens": pr.to(d)}, lane)
        pos = torch.tensor([8, 16], device=d)
        return torch.stack([T.decode(p, cfg, nxt[:, i:i + 1].to(d), cache,
                                     pos + i)[0].cpu() for i in range(6)])

    a, b = run(dev), run(torch.device("cpu"))
    assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(a[..., :cfg.vocab].argmax(-1),
                       b[..., :cfg.vocab].argmax(-1))


# --------------------------------------------------------------------- #
# the vlm (qwen2-vl) and the encoder-decoder (whisper)
# --------------------------------------------------------------------- #

def _vlm_encdec_inputs(cfg, b=2, s=16):
    """Tokens, labels and (seeded, 0.02) vision embeddings or frames."""
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.from_numpy((0.02 * rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model))).astype(np.float32))
    if cfg.enc_layers:
        batch["frames"] = torch.from_numpy((0.02 * rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model))).astype(np.float32))
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-large-v3"])
def test_cuda_vlm_encdec_forward_and_grads_match_cpu(arch):
    """The smoke model's logits (M-RoPE and the vision prefix; the encoder
    and cross-attention) and every gradient on the card against the CPU:
    logits within 1e-4, each gradient within 1e-4 of its leaf's largest
    magnitude (f32 sums in another order); whisper's cross ``bk``/``bv``
    gradients exactly zero on both."""
    dev = _card()
    cfg = get(arch).smoke
    params = L.init_params(T.model_template(cfg), 0)
    batch = _vlm_encdec_inputs(cfg)

    def run(d):
        paths, xs = flatten_tree(_to(params, d))
        leaves = [x.requires_grad_(True) for x in xs]
        tree = unflatten_tree(paths, leaves)
        b = {k: v.to(d) for k, v in batch.items()}
        loss, _ = T.lm_loss(tree, cfg, b)
        gs = torch.autograd.grad(loss, leaves, materialize_grads=True)
        logits, _ = T.forward(tree, cfg, b)
        return paths, logits.detach().cpu(), [g.cpu() for g in gs]

    paths, la, ga = run(dev)
    _, lb, gb = run(torch.device("cpu"))
    assert float((la - lb).abs().max()) <= 1e-4
    for path, a, b in zip(paths, ga, gb):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1e-6), path
        if path[0] == "cross" and path[-1] in ("bk", "bv"):
            assert not a.any() and not b.any(), path


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-large-v3"])
def test_cuda_vlm_encdec_decode_matches_cpu(arch):
    """Prefill 11 tokens (the vision prefix, or the frames encoded once)
    and 6 greedy decodes (M-RoPE text positions; ``enc_out`` recomputing
    the cross keys and values) on the card against the CPU: logits within
    1e-4 and greedy tokens equal."""
    dev = _card()
    cfg = get(arch).smoke
    params = L.init_params(T.model_template(cfg), 0)
    batch = _vlm_encdec_inputs(cfg, s=11)

    def run(d):
        p = _to(params, d)
        b = {k: v.to(d) for k, v in batch.items() if k != "labels"}
        enc = T.encode(p, cfg, b["frames"]) if cfg.enc_layers else None
        cache = T.init_cache(cfg, 2, 32, torch.float32, d)
        logits, _ = T.prefill(p, cfg, b, cache)
        out = [logits.cpu()]
        for i in range(6):
            tok = logits[:, -1, :cfg.vocab].argmax(-1)[:, None]
            logits, _ = T.decode(p, cfg, tok, cache, 11 + i, enc_out=enc)
            out.append(logits.cpu())
        return torch.cat(out, dim=1)

    a, b = run(dev), run(torch.device("cpu"))
    assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(a[..., :cfg.vocab].argmax(-1),
                       b[..., :cfg.vocab].argmax(-1))


# --------------------------------------------------------------------- #
# MoE and MLA serving
# --------------------------------------------------------------------- #

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mla_absorbed_decode_matches_cpu(dtype):
    """deepseek-smoke's MLA layer on the card: a prefill of 11 positions
    into the latent cache, then 6 absorbed decode steps with per-row
    positions, against the CPU's: outputs within 1e-4 (f32 cache; in
    bf16 two bf16 ulp of the largest output: the softmax weights and the
    latent context are rounded to bf16) and the caches within 1e-5 (f32;
    one bf16 ulp of the largest value)."""
    from repro_torch.models import attention as A
    from repro_torch.models import rope as R

    dev = _card()
    cfg = get("deepseek-v2-236b").smoke
    params = L.init_params(A.mla_template(
        cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.mla_qk_nope,
        cfg.mla_qk_rope, cfg.mla_v_dim), 0)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 17, cfg.d_model)).astype(np.float32))

    def run(d):
        p = _to(params, d)
        cache = {"ckv": torch.zeros(2, 24, cfg.kv_lora_rank, dtype=dtype,
                                    device=d),
                 "kr": torch.zeros(2, 24, cfg.mla_qk_rope, dtype=dtype,
                                   device=d)}
        out, _ = A.mla_forward(p, cfg, x[:, :11].to(d),
                               R.text_positions(2, 11, device=d),
                               cache=cache, cache_pos=0)
        outs = [out.float().cpu()]
        pos = torch.tensor([11, 7], device=d)
        for i in range(6):
            out, _ = A.mla_forward(p, cfg, x[:, 11 + i:12 + i].to(d),
                                   R.text_positions(2, 1, pos + i, d),
                                   cache=cache, cache_pos=pos + i)
            outs.append(out.float().cpu())
        return torch.cat(outs, 1), {k: v.float().cpu()
                                    for k, v in cache.items()}

    (a, ca), (b, cb) = run(dev), run(torch.device("cpu"))
    bf16 = dtype == torch.bfloat16
    assert float((a - b).abs().max()) <= (
        float(b.abs().max()) * 2 ** -6 if bf16 else 1e-4)
    for k in ca:
        tol = 1e-5 if not bf16 else float(cb[k].abs().max()) * 2 ** -7
        assert float((ca[k] - cb[k]).abs().max()) <= tol, k


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-236b"])
def test_cuda_routing_groups_match_cpu(arch):
    """The smoke model's MoE layer on 8 rows of one token, routed a row a
    group (``groups=8``) and over the whole batch, on the card against
    the CPU: outputs within 1e-5, the dropped fractions equal (the same
    prompt in every row: llama4's batch-wide capacity drops half,
    per-row none); then 4 Scheduler-style decodes of the whole model at
    per-row positions and ``groups=8``, logits within 1e-4 and greedy
    tokens equal."""
    from repro_torch.models import moe as MOE

    dev = _card()
    cfg = get(arch).smoke
    params = L.init_params(T.model_template(cfg), 0)
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 1, cfg.d_model)).astype(np.float32)).expand(8, 1, -1)
    kw = dict(top_k=cfg.top_k, n_experts=cfg.n_experts,
              capacity_factor=cfg.capacity_factor)
    for groups in (1, 8):
        a, ma = MOE.moe_forward(_to(layer, dev), x.to(dev), groups=groups,
                                **kw)
        b, mb = MOE.moe_forward(layer, x, groups=groups, **kw)
        assert float((a.cpu() - b).abs().max()) <= 1e-5, groups
        assert float(ma["dropped_frac"]) == float(mb["dropped_frac"])
        if groups == 8:
            assert float(mb["dropped_frac"]) == 0.0
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 9)))

    def run(d):
        p = _to(params, d)
        cache = T.init_cache(cfg, 8, 16, torch.float32, d)
        logits, _ = T.prefill(p, cfg, {"tokens": prompt.to(d)}, cache)
        pos = torch.full((8,), 9, device=d)
        out = []
        for i in range(4):
            tok = logits[:, -1, :cfg.vocab].argmax(-1)[:, None]
            logits, _ = T.decode(p, cfg, tok, cache, pos + i, groups=8)
            out.append(logits.cpu())
        return torch.cat(out, 1)

    a, b = run(dev), run(torch.device("cpu"))
    assert float((a - b).abs().max()) <= 1e-4
    assert torch.equal(a[..., :cfg.vocab].argmax(-1),
                       b[..., :cfg.vocab].argmax(-1))


# --- production precision: bf16 operands of the state-reading kernels ---

BF16_EDGES = [(64, 4104, 0), (37, 99, 0), (8, 50432, 0), (70000, 8, 0),
              (64, 24, 1), (9, 4096, 3)]


def _bf16_frame(rows, cols, seed, dev, offset=0, dtype=torch.bfloat16):
    """z (f32) and a 16-bit (``dtype``) err whose storage starts
    ``offset`` elements in (an unaligned operand for offset % 4), with
    _frame's row counts."""
    z, e, cnt = _frame(rows, cols, seed, dev)
    if rows % 4:
        cnt = torch.full((rows,), cols, dtype=torch.int32, device=dev)
        cnt[::3] = cols // 2 + 1
    buf = torch.empty(rows * cols + offset, dtype=dtype, device=dev)
    eb = buf[offset:].view(rows, cols)
    eb.copy_(e)
    return z, eb, cnt


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,cols,offset", BF16_EDGES)
def test_cuda_bf16_error_feedback_matches_plain(rows, cols, offset, dtype):
    """abs_rowsum, ef_quantize and ef_compress with a bf16 or fp16 err
    (the optimizer's state_dtype) at edge shapes (ragged and whole pad
    rows, > 65,535 rows, a 99-column row, unaligned err): err_out comes
    back in err's dtype, bit for bit the plain version's given the same
    scales, packed bytes bit for bit, sums within 64 ulp."""
    dev = _card()
    z, e, cnt = _bf16_frame(rows, cols, 17, dev, offset, dtype)
    rk = onebit.abs_rowsum(z, e, cnt)
    rp = onebit.abs_rowsum_plain(z, e, cnt)
    assert _ulps(rk, rp) <= 64
    if cols % 8:
        return
    s = (rp / cnt.clamp_min(1)).contiguous()
    pk, ek = onebit.ef_quantize(z, e, s, cnt)
    pp, ep = onebit.ef_quantize_plain(z, e, s, cnt)
    assert ek.dtype == ep.dtype == dtype
    assert torch.equal(pk, pp) and torch.equal(ek.view(torch.int16),
                                               ep.view(torch.int16))
    pk, sk, ek = onebit.ef_compress(z, e, cnt)
    pp, sp, _ = onebit.ef_compress_plain(z, e, cnt)
    assert torch.equal(pk, pp) and _ulps(sk, sp) <= 64
    assert ek.dtype == dtype
    assert torch.equal(ek, onebit.ef_quantize_plain(z, e, sk, cnt)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16,
                                 torch.float16])
@pytest.mark.parametrize("u_f32", [False, True], ids=["u_state", "u_f32"])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
@pytest.mark.parametrize("rows,cols", [(64, 4104), (37, 99)])
def test_cuda_local_step_dtypes_match_plain(kind, u_f32, sdt, gdt, rows,
                                            cols):
    """Kernel 1 and the SGD kernel at every operand dtype the optimizer
    passes: the gradient f32 or bf16, the state (m, u, v) f32, bf16 or
    fp16,
    u' into the state or into an f32 buffer (a sync step's), aligned and
    unaligned lengths: m' and u' bit for bit the plain version's (one
    rounding to nearest even), the delta (f32) within 2 ulp (SGD: bit
    for bit)."""
    dev = _card()
    z, e, _ = _frame(rows, cols, 19, dev)
    g, m, u = z.to(gdt), e.to(sdt), (z * 1e-3).to(sdt)
    v = (e.abs() * 1e-3).to(sdt)
    uo = torch.zeros(rows, cols, device=dev) if u_f32 else None
    lr = np.float32(1e-3)
    outs = []
    for adam, sgd in ((fused_adam.fused_local_step_,
                       fused_adam.fused_local_step_sgd_),
                      (fused_adam.fused_local_step_plain_,
                       fused_adam.fused_local_step_sgd_plain_)):
        mm, uu = m.clone(), u.clone()
        o = None if uo is None else uo.clone()
        if kind == "adam":
            d = adam(g, mm, uu, v, lr, 0.9, u_out=o)
        else:
            d = sgd(g, mm, uu, lr, 0.9, u_out=o)
        outs.append((mm, uu if o is None else o, d))
    torch.cuda.synchronize()
    (mk, uk, dk), (mp, up, dp) = outs
    assert mk.dtype == sdt and uk.dtype == (torch.float32 if u_f32 else sdt)
    assert torch.equal(mk, mp) and torch.equal(uk, up)
    assert _ulps(dk, dp) <= (2 if kind == "adam" else 0)


@pytest.mark.gpu
def test_cuda_kernels_refuse_other_dtypes():
    """A state or error operand of any dtype but f32, bf16 and fp16, or
    a gradient of any but f32 and bf16, raises on the card, naming it;
    nothing falls back to the plain version."""
    dev = _card()
    z = torch.zeros(8, 16, device=dev)
    cnt = torch.full((8,), 16, dtype=torch.int32, device=dev)
    h, w = z.to(torch.float16), z.to(torch.float64)
    build.launch_counts.clear()
    with pytest.raises(TypeError, match="float64"):
        onebit.abs_rowsum(z, w, cnt)
    with pytest.raises(TypeError, match="float64"):
        onebit.ef_quantize(z, w, torch.ones(8, device=dev), cnt)
    with pytest.raises(TypeError, match="float64"):
        onebit.ef_compress(z, w, cnt)
    with pytest.raises(TypeError, match="float64"):
        fused_adam.fused_local_step_(z, w, w.clone(), w.clone(), 1e-3, 0.9)
    with pytest.raises(TypeError, match="float16"):
        fused_adam.fused_local_step_sgd_(h, z, z.clone(), 1e-3, 0.9)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_adam.fused_local_step_(z, z.clone(), z.clone(), z.clone(),
                                     1e-3, 0.9, d=z.to(torch.bfloat16))
    assert not build.launch_counts


@pytest.mark.gpu
def test_cuda_fp16_narrowing_is_the_cpu_half():
    """The kernels' fp16 narrowing (``csrc/lowp4.cuh``) through
    ef_quantize with a zero err and zero scales (err_out = z rounded to
    fp16) on f32 values of every kind (log-uniform magnitudes 1e-9 to
    3e5 of both signs: fp16 subnormals, zeros and infs among the
    results; fp16's edges; +-0, +-inf): bit for bit the plain version's
    on the CPU and torch's CPU ``.half()`` of ``z + 0``; a NaN comes back
    a NaN (the card's f32 add writes its own NaN first)."""
    dev = _card()
    rng = np.random.default_rng(20)
    mag = np.exp(rng.uniform(np.log(1e-9), np.log(3e5), 1 << 16))
    edges = np.array([3e-8, 2.9e-8, 5.96e-8, 6.1e-5, 65504.0, 65519.0,
                      65520.0, 1e9, 0.0, np.inf], np.float32)
    x = np.concatenate([mag * rng.choice([-1.0, 1.0], mag.size), edges,
                        -edges, [np.nan, -np.nan] * 3]).astype(np.float32)
    z = torch.from_numpy(x[: x.size // 8 * 8]).view(-1, 8)
    rows = z.shape[0]
    err = torch.zeros(rows, 8, dtype=torch.float16)
    cnt = torch.full((rows,), 8, dtype=torch.int32)
    scales = torch.zeros(rows)
    _, ek = onebit.ef_quantize(z.to(dev), err.to(dev), scales.to(dev),
                               cnt.to(dev))
    _, ep = onebit.ef_quantize_plain(z, err, scales, cnt)
    ek = ek.cpu()
    nan = torch.isnan(z)
    bits = lambda t: t.view(torch.int16)
    assert torch.equal(bits(ek)[~nan], bits(ep)[~nan])
    assert torch.equal(bits(ek)[~nan], bits((z + 0.0).half())[~nan])
    assert torch.isnan(ek[nan]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("store_anchor", [True, False])
@pytest.mark.parametrize("name", ["zero_one_adam", "zero_one_sgd",
                                  "one_bit_adam"])
def test_cuda_production_precision_step_matches_cpu(name, store_anchor, sdt):
    """The optimizer at bf16 params and gradients and bf16 or fp16 state
    on gpt2-smoke shapes: a sync step with a variance round, a local
    step and a sync
    step after CPU steps, each from equal inputs on the card and on the
    CPU: a local step's params and state bit for bit (kernel 1 alone:
    step 5 of the accumulate style), a step with an exchange at most
    1e-4 of elements unequal at bf16 state, 8e-4 at fp16 (its scales are
    f32 sums in the kernel's order; measured 1e-5 to 2e-5 at bf16,
    up to 1.8e-4 at fp16); every state leaf in the dtype the
    reference keeps it (the state dtype, scalar slots f32)."""
    from repro_torch.core import api
    from repro_torch.core import schedules as S

    dev = _card()
    cfg = get("gpt2").smoke
    tmpl = T.model_template(cfg)
    shapes = L.param_shapes(tmpl)
    paths, leaves = flatten_tree(shapes)
    bf = torch.bfloat16
    rng = np.random.default_rng(3)

    def draw(sc):
        return [torch.from_numpy((rng.standard_normal((4,) + tuple(sh))
                                  * sc).astype(np.float32)).to(bf)
                for sh in leaves]

    def to(xs, d):
        return unflatten_tree(paths, [x.to(d, copy=True) for x in xs])

    ocfg = api.OptimizerConfig(
        name=name, lr=S.ConstantLr(1e-3), onebit_warmup=1,
        var_policy=S.AdaptiveFreezePolicy(kappa=1),
        sync_policy=S.LrProportionalSyncPolicy(2, 2), state_dtype=sdt,
        store_anchor=store_anchor)
    opt = api.build_optimizer(ocfg, shapes, specs=L.param_specs(tmpl),
                              dp_mask=L.dp_mask(tmpl), n_workers=4)
    params, grads = draw(0.02), [draw(1.0) for _ in range(7)]
    state = opt.init(to(params, "cpu"))
    for t in range(7):
        if t in (0, 5, 6):
            res = []
            for d in (dev, torch.device("cpu")):
                st = _state_to(state, d)
                p, st, _ = opt.step(SimComm(4), to(params, d),
                                    to(grads[t], d), st)
                res.append([x.cpu() for x in flatten_tree(p)[1]]
                           + [x.cpu() for x in _state_tensors(st)])
            n = sum(a.numel() for a in res[0])
            unequal = sum(int((a != b).sum()) for a, b in zip(*res))
            local = t == 5 and name != "one_bit_adam"   # no exchange
            # fp16's 3 more significand bits show a sum-order ulp of the
            # scales eight times as often (measured 1.8e-4, one_bit_adam)
            bar = 1e-4 * (8 if sdt == torch.float16 else 1)
            assert unequal <= (0 if local else bar * n), (t, unequal, n)
        p, state, _ = opt.step(SimComm(4), to(params, "cpu"),
                               to(grads[t], "cpu"), state)
        params = flatten_tree(p)[1]
    for name_, xs in state.slots.items():
        for x in xs:
            assert x.dtype == (torch.float32 if name_ == "trust" else sdt)


def _state_tensors(st):
    return [x for xs in (*st.slots.values(), st.u, st.err_w, st.err_s,
                         st.anchor) for x in xs if x is not None]


def _state_to(st, d):
    """A copy of the optimizer state ``st`` on device ``d``."""
    import dataclasses

    def mv(xs):
        return [None if x is None else x.to(d, copy=True) for x in xs]
    return dataclasses.replace(
        st, slots={k: mv(v) for k, v in st.slots.items()}, u=mv(st.u),
        err_w=mv(st.err_w), err_s=mv(st.err_s), anchor=mv(st.anchor))
