"""Serving engine, PyTorch port of ``src/repro/serve/engine.py``: prefill
and single-token decode over a fixed batch and KV-cache extent.

The reference compiles ``prefill_fn``/``decode_fn`` with ``jit`` and
donates the cache; here they are plain callables that write the cache in
place. One process serves on one device. A MoE model serves expert
parallel across processes, the counterpart of the reference's MoE
``shard_map``: a ``Server`` given its process's comm (a ``DistComm``)
holds this worker's ``E / n`` experts (the largest-suffix rule of the
reference, ``train.step.choose_ep``; every dense leaf whole), serves
``batch`` rows, the process's share of the global batch (the reference
splits the batch over the workers), and its MoE layers exchange the
dispatch buffers with the other processes (``models.moe``). Each
process's rows compute what one device computes from those rows alone,
as in the reference. The reference's GSPMD paths (``param_shardings``,
``cache_shardings``: tensor parallelism and the sequence-sharded caches)
need tensor parallelism, which the port does not run yet (ROADMAP queue
item 3).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params, local_shapes
from repro_torch.train.step import choose_ep, resolve_device


class Server:
    """Prefill + decode of ``model_cfg`` over ``batch`` rows and a cache of
    ``max_seq`` positions, on ``device`` (CUDA unless the caller asks for
    the CPU). ``comm``: a MoE model's expert-parallel comm of this
    process (None: one process holds every expert)."""

    def __init__(self, model_cfg: ModelConfig, *, mesh=None, comm=None,
                 batch: int = 1, max_seq: int = 2048,
                 cache_dtype=torch.bfloat16, device="cuda"):
        self.is_moe = model_cfg.n_experts > 0
        if mesh is not None or (comm is not None and not self.is_moe):
            raise NotImplementedError(
                "a serving mesh or a dense model across processes needs "
                "tensor parallelism and sequence-sharded caches, which the "
                "port does not run yet (ROADMAP queue item 3); a MoE model "
                "serves expert parallel across processes (comm=)")
        if model_cfg.rope == "learned" and max_seq > model_cfg.max_seq:
            raise ValueError(
                f"max_seq {max_seq} exceeds {model_cfg.name}'s learned "
                f"position table ({model_cfg.max_seq})")
        self.cfg = model_cfg
        self.batch = batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.n_workers = comm.size() if comm is not None else 1
        self.ep_degree = choose_ep(model_cfg.n_experts, self.n_workers, None)
        # the comm of the MoE layers: None where every expert is local
        self.comm = comm if self.ep_degree > 1 else None
        self.ep_index = int(comm.index()[0]) if self.comm is not None else 0
        self.template = T.model_template(model_cfg,
                                         ep_workers=self.ep_degree)

    def abstract_params(self, dtype=torch.bfloat16):
        """This process's parameter tree (its block of experts) as tensors
        on the ``meta`` device."""
        def f(node):
            if isinstance(node, dict):
                return {k: f(v) for k, v in node.items()}
            return torch.empty(node, dtype=dtype, device="meta")
        return f(local_shapes(self.template, self.ep_degree))

    def init_params(self, seed: int, dtype=torch.float32):
        """This process's parameters from the port's seeded init: the
        whole model's draw, each expert-parallel leaf cut to this
        process's block of experts."""
        return init_params(self.template, seed, device=self.device,
                           dtype=dtype,
                           ep_block=(self.ep_degree, self.ep_index))

    def abstract_cache(self):
        return T.init_cache(self.cfg, self.batch, self.max_seq,
                            self.cache_dtype, device="meta")

    def prefill_fn(self):
        """``run(params, batch, cache) -> (last logits, cache)``; the
        batch passes through whole: ``tokens``, and the vlm's
        ``vision_embeds``, the encoder-decoder's ``enc_out`` or
        ``frames``."""
        cfg, comm = self.cfg, self.comm

        def run(params, batch, cache):
            return T.prefill(params, cfg, batch, cache, comm=comm)

        return run

    def decode_fn(self):
        """``run(params, cache, tokens, pos, enc_out=None, groups=1,
        moe_stats=None) -> (logits, cache)``; ``pos`` an int or a (batch,)
        tensor of per-row positions, ``enc_out`` the encoder-decoder's
        encoder output, ``groups`` the MoE layers' routing groups of rows
        (1: the whole batch, as the reference's ``decode_fn``)."""
        cfg, comm = self.cfg, self.comm

        def run(params, cache, tokens, pos, enc_out=None, groups=1,
                moe_stats=None):
            return T.decode(params, cfg, tokens, cache, pos, enc_out=enc_out,
                            comm=comm, groups=groups, moe_stats=moe_stats)

        return run
