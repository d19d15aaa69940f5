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
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_adam, onebit


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
