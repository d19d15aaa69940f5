"""Architecture registry, PyTorch port of ``src/repro/configs/base.py``.

Each entry carries the FULL config and a reduced SMOKE config of the same
family. Ported so far: gpt2, bert-base and bert-large, and the dense
rotary family: granite-3-8b, phi4-mini-3.8b, chatglm3-6b, gemma3-12b;
the moe family: llama4-scout-17b-a16e, deepseek-v2-236b; the
state-space family: mamba2-2.7b and the hybrid zamba2-1.2b; the vlm
qwen2-vl-2b (M-RoPE, the vision prefix) and the encoder-decoder
whisper-large-v3: every architecture the reference registers.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke: ModelConfig


_REGISTRY: Dict[str, ArchSpec] = {}
_ARCH_MODULES = ["whisper_large_v3", "chatglm3_6b", "qwen2_vl_2b",
                 "deepseek_v2_236b", "gemma3_12b", "granite_3_8b",
                 "llama4_scout_17b_a16e", "mamba2_2p7b", "phi4_mini_3p8b",
                 "zamba2_1p2b", "bert_base", "bert_large", "gpt2"]


def register(name: str, spec: ArchSpec):
    _REGISTRY[name] = spec


def _load():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get(name: str) -> ArchSpec:
    _load()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _load()
    return sorted(_REGISTRY)
