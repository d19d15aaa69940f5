"""Trainer, PyTorch port of the sim mode of ``src/repro/train/step.py``.

``n`` simulated data-parallel workers live on one device. Every parameter
and optimizer-state tensor carries the worker stack on dim 0; the forward
and backward passes run one worker at a time on its slice of the global
batch, then the optimizer steps all workers at once through the
simulated collectives (``core.comm.SimComm``), so each exchange phase of
each leaf is one kernel launch for the whole stack. Gradients are not
accumulated over micro-batches yet (the reference's ``micro_batches=1``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.core import api as opt_api
from repro_torch.core.comm import SimComm
from repro_torch.core.leafwise import flatten_tree, unflatten_tree
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dp_mask, init_params, param_shapes,
                                       param_specs)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' (--device cpu) to run the plain versions on "
                "the CPU")
        # the reference is f32 throughout; keep matmuls and convolutions
        # out of TF32 (cuDNN's default is TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class Trainer:
    """Static plan (template, layouts, optimizer) plus the sim step."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg, *, n_workers: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.n_workers = n_workers
        self.comm = SimComm(n_workers)
        self.template = T.model_template(model_cfg)
        self.opt = opt_api.build_optimizer(
            opt_cfg, param_shapes(self.template),
            specs=param_specs(self.template),
            dp_mask=dp_mask(self.template), n_workers=n_workers)

    def sim_init(self, seed: int):
        """Stacked params (every worker starts from the same draw) and
        the optimizer state."""
        params = init_params(self.template, seed, device=self.device,
                             dtype=self.model_cfg.param_dtype)
        paths, leaves = flatten_tree(params)
        n = self.n_workers
        stacked = [x[None].expand((n,) + tuple(x.shape)).clone()
                   for x in leaves]
        params = unflatten_tree(paths, stacked)
        return params, self.opt.init(params)

    def grads(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Per-worker loss and gradients: worker w takes rows
        [w*B/n, (w+1)*B/n) of the global batch. Returns (losses (n,),
        stacked grads tree)."""
        n = self.n_workers
        paths, xs = flatten_tree(params)
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"global batch {B} is not divisible by "
                             f"{n} workers")
        per = B // n
        gbuf: List[torch.Tensor] = [torch.empty_like(x) for x in xs]
        losses = torch.empty(n, dtype=torch.float32, device=self.device)
        for w in range(n):
            leaves = [x[w].detach().requires_grad_(True) for x in xs]
            b = {k: v[w * per:(w + 1) * per] for k, v in batch.items()}
            loss, _ = T.lm_loss(unflatten_tree(paths, leaves),
                                self.model_cfg, b)
            gs = torch.autograd.grad(loss, leaves)
            for buf, g in zip(gbuf, gs):
                buf[w].copy_(g)
            losses[w] = loss.detach()
        return losses, unflatten_tree(paths, gbuf)

    def sim_step(self, params, state, batch):
        """One training step of all workers: (params, state, metrics)."""
        losses, grads = self.grads(params, batch)
        params, state, met = self.opt.step(self.comm, params, grads, state)
        met["loss"] = losses.mean()
        return params, state, met
