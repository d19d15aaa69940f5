"""Serving engine, PyTorch port of ``src/repro/serve/engine.py``: prefill
and single-token decode over a fixed batch and KV-cache extent, on one
device.

The reference compiles ``prefill_fn``/``decode_fn`` with ``jit`` and
donates the cache; here they are plain callables that write the cache in
place. Its ``mesh`` path (``param_shardings``, ``cache_shardings``, the
MoE ``shard_map``) needs tensor and expert parallelism, which the port
does not run yet (ROADMAP queue items 3 and 4).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import param_shapes
from repro_torch.train.step import resolve_device


class Server:
    """Prefill + decode of ``model_cfg`` over ``batch`` rows and a cache of
    ``max_seq`` positions, on ``device`` (CUDA unless the caller asks for
    the CPU)."""

    def __init__(self, model_cfg: ModelConfig, *, mesh=None,
                 batch: int = 1, max_seq: int = 2048,
                 cache_dtype=torch.bfloat16, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a serving mesh needs tensor and expert parallelism, which "
                "the port does not run yet (ROADMAP queue items 3 and 4)")
        if model_cfg.rope == "learned" and max_seq > model_cfg.max_seq:
            raise ValueError(
                f"max_seq {max_seq} exceeds {model_cfg.name}'s learned "
                f"position table ({model_cfg.max_seq})")
        self.cfg = model_cfg
        self.batch = batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        self.template = T.model_template(model_cfg)

    def abstract_params(self, dtype=torch.bfloat16):
        """The parameter tree as tensors on the ``meta`` device."""
        def f(node):
            if isinstance(node, dict):
                return {k: f(v) for k, v in node.items()}
            return torch.empty(node, dtype=dtype, device="meta")
        return f(param_shapes(self.template))

    def abstract_cache(self):
        return T.init_cache(self.cfg, self.batch, self.max_seq,
                            self.cache_dtype, device="meta")

    def prefill_fn(self):
        """``run(params, batch, cache) -> (last logits, cache)``; the batch
        passes through whole: ``tokens``, and the vlm's
        ``vision_embeds``, the encoder-decoder's ``enc_out`` or
        ``frames``."""
        cfg = self.cfg

        def run(params, batch, cache):
            return T.prefill(params, cfg, batch, cache)

        return run

    def decode_fn(self):
        """``run(params, cache, tokens, pos, enc_out=None) -> (logits,
        cache)``; ``pos`` an int or a (batch,) tensor of per-row positions,
        ``enc_out`` the encoder-decoder's encoder output."""
        cfg = self.cfg

        def run(params, cache, tokens, pos, enc_out=None):
            return T.decode(params, cfg, tokens, cache, pos, enc_out=enc_out)

        return run
