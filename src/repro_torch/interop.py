"""Carry the JAX reference's values into the port.

The reference initializes parameters from jax's threefry, whose bits
PyTorch's generators do not reproduce; a comparison of the two packages
starts both from the reference's draw. Inputs are numpy trees (e.g.
``jax.device_get`` of the reference's pytrees); nothing here imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compressed import ComposedOptimizer, CompressedDPState


def _tensor(a, device):
    return torch.as_tensor(np.array(a, copy=True), device=device)


def params_from_reference(tree, device="cpu"):
    """The reference's parameter tree (nested dicts of arrays, any
    leading worker dim kept) -> the port's parameter tree."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def state_from_reference(state, opt: ComposedOptimizer,
                         device="cpu") -> CompressedDPState:
    """The reference's sim-mode ``CompressedDPState`` (every leaf stacked
    over workers, as ``Trainer.sim_init`` returns it) -> the port's state
    for ``opt``, in any style. Scalars and policy states are identical on
    all workers and come from worker 0; a leaf the style keeps as
    ``None`` stays ``None``."""
    def first(x):
        return np.asarray(x).reshape(-1)[0]

    def scalar(x):
        v = first(x)
        return bool(v) if v.dtype == np.bool_ else int(v)

    def leaves(xs):
        return [None if x is None else _tensor(x, device).to(torch.float32)
                for x in xs]

    n_leaves = len(opt.layouts)
    for name in ("u", "err_w", "err_s", "anchor"):
        if len(getattr(state, name)) != n_leaves:
            raise ValueError(f"reference state has {len(getattr(state, name))}"
                             f" {name} leaves, the port plans {n_leaves}")
    return CompressedDPState(
        step=int(first(state.step)),
        gamma_acc=np.float32(first(state.gamma_acc)),
        sync_pstate=tuple(scalar(x) for x in state.sync_pstate),
        var_pstate=tuple(scalar(x) for x in state.var_pstate),
        slots={name: leaves(state.slots[name])
               for name in opt.base.slot_specs()},
        u=leaves(state.u), err_w=leaves(state.err_w),
        err_s=leaves(state.err_s), anchor=leaves(state.anchor))
