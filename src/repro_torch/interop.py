"""Carry values between the JAX reference's trees and the port's.

The reference initializes parameters from jax's threefry, whose bits
PyTorch's generators do not reproduce; a comparison of the two packages
starts both from the reference's draw. Inputs are numpy trees (e.g.
``jax.device_get`` of the reference's pytrees); nothing here imports jax.

The same conversion gives the checkpoint tree both packages write
(:mod:`repro_torch.checkpointing.io`): ``{"params", "state"}`` in the
shapes of the reference trainer's tree for the same mode.

A MoE model's expert-parallel leaves need no conversion: in sim mode
both packages stack each worker's block of experts on dim 0 ``(n, ...,
E/n, ...)``, and the reference's state keeps for them the slots in
that shape and ``None`` for ``u``, the EF state, the anchor and LAMB's
trust, as the port's. (Single mode has no expert-parallel leaf: one
worker holds every expert as a data-parallel leaf in both.)

The state-space family needs no conversion either: its stacked
``blocks`` (``norm``, ``ssm.*``) and zamba2's ``shared_attn`` carry the
reference's names and shapes, so its params and optimizer state cross
leaf for leaf both ways. Nor do the vlm and the encoder-decoder:
qwen2-vl-2b's 15 leaves and whisper-large-v3's 47 (its ``encoder``
stack and position table, and the per-layer ``cross`` norm and
attention, the always-zero ``bk``/``bv`` among them) cross leaf for
leaf with their optimizer state (``tests/test_torch_vlm_encdec_train.py``).

Expert-parallel serving (``serve.Server(comm=)``) holds a process's
block of the experts; :func:`expert_block` cuts it from the reference's
whole tree, so that a rank and the reference's single-device run of its
rows compute from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compressed import ComposedOptimizer, CompressedDPState
from repro_torch.models.layers import ep_axes


def _tensor(a, device):
    """A copy of ``a`` as a tensor on ``device``, in its own dtype: a
    numpy bfloat16 (the ``ml_dtypes`` type the reference's arrays carry,
    or the raw 2-byte records an npz file holds) becomes torch's, bit for
    bit; a tensor is copied."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone().to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def params_from_reference(tree, device="cpu"):
    """The reference's parameter tree (nested dicts of arrays, any
    leading worker dim kept) -> the port's parameter tree."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def expert_block(tree, template, n: int, i: int, device="cpu"):
    """The reference's whole parameter tree (a single device's, every
    expert) -> the port's tree of process ``i`` of an expert-parallel
    degree ``n`` (``serve.Server(comm=)``): each leaf with an ``ep_axis``
    in ``template`` (a template built with ``ep_workers=n``, see
    ``layers.ep_axes``) keeps block ``i`` of ``n`` along it, every other
    leaf comes whole. The reference's MoE ``shard_map`` hands each worker
    that block."""
    def cut(t, axes):
        if isinstance(t, dict):
            return {k: cut(t[k], axes[k]) for k in t}
        x = np.asarray(t)
        if axes is not None:
            x = np.split(x, n, axis=axes)[i]
        return _tensor(x, device)
    return cut(tree, ep_axes(template))


def state_from_reference(state, opt: ComposedOptimizer, device="cpu",
                         stacked: bool = True) -> CompressedDPState:
    """The reference's ``CompressedDPState`` -> the port's state for
    ``opt``, in any style, per leaf or bucketed (EF state and anchors per
    bucket of ``opt.bucket_plan``). ``stacked``: every leaf carries the
    worker dim (sim mode, as ``Trainer.sim_init`` returns it); else none
    (single mode), and the port's stack of one is added. Scalars and
    policy states must be identical on all workers (a ``ValueError``
    otherwise); a leaf the style keeps as ``None`` stays ``None``. Every
    leaf keeps its dtype (bf16 under ``state_dtype=bf16``)."""
    def first(x, name):
        a = np.asarray(x).reshape(-1)
        if not (a == a[0]).all():
            raise ValueError(f"state {name} differs across workers "
                             f"({a.tolist()}); the port keeps one value")
        return a[0]

    def scalar(x, name):
        v = first(x, name)
        return bool(v) if v.dtype == np.bool_ else int(v)

    def leaves(xs):
        out = []
        for x in xs:
            t = None if x is None else _tensor(x, device)
            out.append(t if t is None or stacked else t[None])
        return out

    n_leaves = len(opt.layouts)
    n_units = (n_leaves if opt.bucket_plan is None
               else len(opt.bucket_plan.buckets))
    for name, n in (("u", n_leaves), ("err_w", n_units), ("err_s", n_units),
                    ("anchor", n_units)):
        if len(getattr(state, name)) != n:
            raise ValueError(f"reference state has {len(getattr(state, name))}"
                             f" {name} leaves, the port plans {n}")
    return CompressedDPState(
        step=int(first(state.step, "step")),
        gamma_acc=np.float32(first(state.gamma_acc, "gamma_acc")),
        sync_pstate=tuple(scalar(x, "sync_pstate")
                          for x in state.sync_pstate),
        var_pstate=tuple(scalar(x, "var_pstate") for x in state.var_pstate),
        slots={name: leaves(state.slots[name])
               for name in opt.base.slot_specs()},
        u=leaves(state.u), err_w=leaves(state.err_w),
        err_s=leaves(state.err_s), anchor=leaves(state.anchor))


def _host_scalar(v):
    """A host value of the port's state as the reference's array dtype:
    bool, float32 (gamma) or int32 (step, policy counters)."""
    if isinstance(v, (bool, np.bool_)):
        return np.bool_(v)
    if isinstance(v, (float, np.floating)):
        return np.float32(v)
    return np.int32(v)


def state_to_reference(state: CompressedDPState,
                       stacked: bool = True) -> CompressedDPState:
    """The port's state -> the reference's state layout (the same field
    order and ``None`` placements; tensors stay where they are): with
    ``stacked`` every scalar becomes an array over the stacked workers
    (sim mode), else the stack of one is dropped (single mode)."""
    stack = state.slots["m"][0].shape[0]

    def scalar(v):
        a = _host_scalar(v)
        return np.full((stack,), a) if stacked else np.asarray(a)

    def leaves(xs):
        return [None if x is None else (x if stacked else x[0]) for x in xs]

    return CompressedDPState(
        step=scalar(state.step), gamma_acc=scalar(state.gamma_acc),
        sync_pstate=tuple(scalar(v) for v in state.sync_pstate),
        var_pstate=tuple(scalar(v) for v in state.var_pstate),
        slots={name: leaves(xs) for name, xs in state.slots.items()},
        u=leaves(state.u), err_w=leaves(state.err_w),
        err_s=leaves(state.err_s), anchor=leaves(state.anchor))
