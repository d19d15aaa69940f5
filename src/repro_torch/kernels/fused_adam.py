"""Fused local half-steps of the 0/1 optimizers, one per base kind: CUDA
kernels, plain versions, wrappers.

* :func:`fused_local_step_` (Adam base) replaces the Pallas kernel
  ``src/repro/kernels/fused_adam.py::fused_local_step``:

      m' = fma(b1, m, (1-b1)*g)
      u' = fma(lr, m', u)
      d  = (lr*m') / sqrt(v + eps)

* :func:`fused_local_step_sgd_` (momentum-SGD base) replaces
  ``src/repro/kernels/fused_adam.py::fused_local_step_sgd``:

      m' = fma(b1, m, (1-b1)*g)
      u' = fma(lr, m', u)
      d  = lr*m'

The kernels are in ``csrc/fused_adam.cu``. The reference's XLA build
contracts both updates into single-rounding FMAs (for SGD too, although
``d = lr*m'`` is written out there and ``u' = u + d`` in the source); the
kernels write those two FMAs out and the plain versions reproduce them
exactly (see :func:`fma_f32`), so m' and u' agree bit for bit, and so does
the SGD step's ``d``. Adam's divide and square root are IEEE-rounded on
both sides (the plain version's root through :func:`sqrt`); its ``d`` is
held to 2 ulp against the reference.

Both kernels update ``m`` and ``u`` in place and write ``d`` into a
buffer the caller names, which may be the gradient's own (the optimizer
passes it where the gradient is dead after the step), so that a step
holds no second copy of the state. :func:`fused_local_step` and
:func:`fused_local_step_sgd` are the out-of-place forms over copies, and
the plain versions keep the same contracts.

Operands come in the production precision too: the gradient in the
parameter dtype (f32 or bf16) and the state (m, u, v) in ``state_dtype``
(f32, bf16, or fp16 as the paper keeps it). The math stays f32, as the
reference feeds its kernel f32 upcasts; m' and u' round once (to nearest
even, the bits of torch's CPU conversion) to the state dtype, where the
reference rounds them at the end of its step, except that a sync step
takes u' unrounded into an f32 ``u_out`` (its exchange reads the f32
u'); ``d`` is f32 (``x_half = (x - d)`` rounds to the parameter dtype
once, outside). Any other dtype raises, on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

KERNEL = "fused_local_step"
KERNEL_SGD = "fused_local_step_sgd"


# an f64 whose low 29 mantissa bits are 1 followed by 28 zeros lies
# exactly halfway between two f32 neighbours (normal range)
_F32_MID, _F32_LOW = 1 << 28, (1 << 29) - 1
_F32_TINY = 2.0 ** -126        # below it the f32 result is subnormal


def _round_to_odd_f32(p, c64, s):
    """``s = p + c64`` made round-to-odd with the TwoSum error term, then
    rounded to f32: round-to-odd at 53 bits followed by round-to-nearest
    at 24 bits is the correctly rounded result."""
    bv = s - p
    av = s - bv
    e = (p - av) + (c64 - bv)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    odd = torch.where((e != 0) & ((bits & 1) == 0), bits + step, bits)
    return odd.view(torch.float64).float()  # audit-ok: float64-literal (round-to-odd bits)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` in f32 with one rounding, like a hardware FMA.

    The product of two f32 is exact in f64. Rounding the f64 sum to f32
    is the correctly rounded result unless the sum lies exactly halfway
    between two f32 (then the f64 rounding may have moved it onto the
    tie) or in f32's subnormal range: those elements alone go through
    :func:`_round_to_odd_f32` (no double-rounding error)."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)  # audit-ok: float64-literal (the exact f32 product)
    c64 = c.double()  # audit-ok: float64-literal (the sum in f64)
    s = p + c64
    out = s.float()
    if out.is_meta:
        return out      # shapes only (the audit's payload manifests)
    slow = (((s.view(torch.int64) & _F32_LOW) == _F32_MID)
            | ((s.abs() < _F32_TINY) & (s != 0)))
    if bool(slow.any()):
        out[slow] = _round_to_odd_f32(p[slow], c64[slow], s[slow])
    return out


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` with one rounding, for f32 tensors ``a``, ``c`` and a
    scalar (taken at f32) or f32 tensor ``b``: the plain steps of the
    gradient and mean styles, whose multiply-adds XLA contracts. On the CPU the exact
    :func:`fma_f32`; on the card ``torch.add(c, a, alpha=b)`` or
    ``torch.addcmul(c, a, b)``, whose CUDA kernels compute one hardware
    FMA on contiguous operands (not on strided ones; held to
    :func:`fma_f32` bit for bit by ``chip_smoke.py`` and
    ``tests/test_torch_gpu.py``)."""
    if not isinstance(b, torch.Tensor):
        b = float(np.float32(b))    # the card rounds a scalar to f32
    if not a.is_cuda:
        return fma_f32(a, b, c)
    a, c = a.contiguous(), c.contiguous()
    if isinstance(b, torch.Tensor):
        return torch.addcmul(c, a, b.contiguous())
    return torch.add(c, a, alpha=b)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` of an f32 tensor, correctly rounded on every device, as
    the kernels' ``__fsqrt_rn``: the card's ``torch.sqrt`` is; the CPU's
    vectorized f32 ``torch.sqrt`` is not (1 ulp off on some inputs), so
    the CPU takes it through f64, whose rounding to f32 is then exact for
    a square root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()  # audit-ok: float64-literal (a correctly rounded root)


def sqrt_(x: torch.Tensor) -> torch.Tensor:
    """:func:`sqrt` into ``x`` itself (a temporary): the same bits."""
    if x.is_cuda:
        return x.sqrt_()
    return x.copy_(sqrt(x))


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1/sqrt(x)`` in f32, as XLA lowers the reference's ``buf /
    sqrt(v + eps)`` (a multiply by ``rsqrt``). XLA's CPU ``rsqrt`` is an
    approximation within 1 ulp of the correctly rounded value, which the
    CPU path computes (through f64); the card's ``torch.rsqrt`` is within
    2 ulp."""
    if x.is_cuda:
        return torch.rsqrt(x)
    return torch.rsqrt(x.double()).float()  # audit-ok: float64-literal (XLA's CPU rsqrt)


def _scalars(lr, beta1, eps):
    """The f32 scalars the kernel receives: 1-b1 is folded in f64 and
    rounded once, as the reference folds it on the host."""
    return (float(np.float32(lr)), float(np.float32(beta1)),
            float(np.float32(1.0 - beta1)), float(np.float32(eps)))


# dtypes of the operands: the gradient (the parameter dtype) and the state
GRAD_DTYPES = (torch.float32, torch.bfloat16)
STATE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _f32(t):
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _check(kernel, g, m, u, v, d, u_out):
    """Raise unless the operands fit the kernel: ``g`` f32 or bf16; ``m``,
    ``u`` (and ``v``) contiguous in one state dtype, f32, bf16 or fp16;
    ``u_out`` f32 or the state dtype; ``d`` f32. Returns the C entry's
    ``types`` bits (1: bf16 g; 2: bf16 state, 8: fp16 state; 4: u' in
    the state's 16-bit dtype)."""
    dev, shape = g.device, g.shape
    if g.dtype not in GRAD_DTYPES:
        raise TypeError(f"{kernel}: g has dtype {g.dtype}, expected one of "
                        f"{GRAD_DTYPES}")
    build.check_operand(kernel, "g", g, g.dtype, shape, dev)
    sd = m.dtype
    if sd not in STATE_DTYPES:
        raise TypeError(f"{kernel}: m has dtype {sd}, expected one of "
                        f"{STATE_DTYPES}")
    ops = (("m", m, sd), ("u", u, sd)) + (
        (("v", v, sd),) if v is not None else ())
    if d is not None:
        ops += (("d", d, torch.float32),)
    if u_out is not None:
        if u_out.dtype not in (torch.float32, sd):
            raise TypeError(f"{kernel}: u_out has dtype {u_out.dtype}, "
                            f"expected torch.float32 or the state's {sd}")
        ops += (("u_out", u_out, u_out.dtype),)
    for name, t, dt in ops:
        build.check_operand(kernel, name, t, dt, shape, dev)
    uo = u if u_out is None else u_out
    return (int(g.dtype == torch.bfloat16) | 2 * (sd == torch.bfloat16)
            | 8 * (sd == torch.float16) | 4 * (uo.dtype != torch.float32))


def fused_local_step_plain_(g, m, u, v, lr, beta1, eps=1e-8, d=None,
                            u_out=None):
    """Plain PyTorch version of the kernel (the CPU path), with its
    in-place contract: ``m`` and ``u`` (or ``u_out``) are updated in place
    and the delta is written into ``d`` (a new f32 tensor when None; may
    be an f32 ``g``). Returns ``d``. Every operand is upcast, the math is
    f32, and each output rounds once to its own dtype (``copy_``: round
    to nearest even)."""
    lr32, b1, omb1, eps32 = _scalars(lr, beta1, eps)
    mh = fma_f32(_f32(m), b1, _f32(g) * omb1)
    delta = (mh * lr32) / sqrt(_f32(v) + eps32)
    (u if u_out is None else u_out).copy_(fma_f32(mh, lr32, _f32(u)))
    m.copy_(mh)
    if d is None:
        return delta
    return d.copy_(delta)


def fused_local_step_(g, m, u, v, lr, beta1, eps=1e-8, d=None, u_out=None):
    """One fused local step over (R, C) frames, in place: ``m`` <- m',
    ``u`` <- u' (or u' into ``u_out``: an f32 buffer where the caller
    needs u' unrounded), and the f32 delta into ``d`` (a new tensor when
    None; an f32 ``g`` itself where the gradient is dead after the
    step). Returns ``d``. The gradient is f32 or bf16 and the state (m,
    u, v) f32, bf16 or fp16 (see :func:`_check`).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    types = _check(KERNEL, g, m, u, v, d, u_out)
    if not build.on_card(KERNEL, g):
        return fused_local_step_plain_(g, m, u, v, lr, beta1, eps, d, u_out)
    if d is None:
        d = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    uo = u if u_out is None else u_out
    if g.numel():
        lr32, b1, omb1, eps32 = _scalars(lr, beta1, eps)
        build.launch(KERNEL, "fused_local_step", g.device, g.data_ptr(),
                     m.data_ptr(), u.data_ptr(), uo.data_ptr(), v.data_ptr(),
                     d.data_ptr(), g.numel(), lr32, b1, omb1, eps32, types)
    return d


def fused_local_step_plain(g, m, u, v, lr, beta1, eps=1e-8):
    """Plain PyTorch version of :func:`fused_local_step` (the CPU path)."""
    m, u = m.clone(), u.clone()
    d = fused_local_step_plain_(g, m, u, v, lr, beta1, eps)
    return m, u, d


def fused_local_step(g, m, u, v, lr, beta1, eps=1e-8):
    """The out-of-place form: (m', u', d) in new tensors, the inputs as
    they were (the in-place kernel on copies of ``m`` and ``u``)."""
    m, u = m.clone(), u.clone()
    d = fused_local_step_(g, m, u, v, lr, beta1, eps)
    return m, u, d


def fused_local_step_sgd_plain_(g, m, u, lr, beta1, d=None, u_out=None):
    """Plain PyTorch version of the SGD kernel (the CPU path), in place as
    :func:`fused_local_step_plain_`."""
    lr32, b1, omb1, _ = _scalars(lr, beta1, 0.0)
    mh = fma_f32(_f32(m), b1, _f32(g) * omb1)
    delta = mh * lr32
    (u if u_out is None else u_out).copy_(fma_f32(mh, lr32, _f32(u)))
    m.copy_(mh)
    if d is None:
        return delta
    return d.copy_(delta)


def fused_local_step_sgd_(g, m, u, lr, beta1, d=None, u_out=None):
    """One fused momentum-SGD local step over (R, C) frames, in place as
    :func:`fused_local_step_`, with its operand dtypes. Returns ``d``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    types = _check(KERNEL_SGD, g, m, u, None, d, u_out)
    if not build.on_card(KERNEL_SGD, g):
        return fused_local_step_sgd_plain_(g, m, u, lr, beta1, d, u_out)
    if d is None:
        d = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    uo = u if u_out is None else u_out
    if g.numel():
        lr32, b1, omb1, _ = _scalars(lr, beta1, 0.0)
        build.launch(KERNEL_SGD, "fused_local_step_sgd", g.device,
                     g.data_ptr(), m.data_ptr(), u.data_ptr(), uo.data_ptr(),
                     d.data_ptr(), g.numel(), lr32, b1, omb1, types)
    return d


def fused_local_step_sgd_plain(g, m, u, lr, beta1):
    """Plain PyTorch version of :func:`fused_local_step_sgd`."""
    m, u = m.clone(), u.clone()
    d = fused_local_step_sgd_plain_(g, m, u, lr, beta1)
    return m, u, d


def fused_local_step_sgd(g, m, u, lr, beta1):
    """The out-of-place SGD form: (m', u', d) in new tensors."""
    m, u = m.clone(), u.clone()
    d = fused_local_step_sgd_(g, m, u, lr, beta1)
    return m, u, d
