"""Architecture registry: the 10 assigned configs + reduced smoke variants,
and the forms the reference does not have (:data:`FORMS`), which
:func:`get_config` also gives."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, SMOKE_OVERRIDES

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "mistral-large-123b": "mistral_large_123b",
    "llama3-8b": "llama3_8b",
    "stablelm-12b": "stablelm_12b",
    "zamba2-2.7b": "zamba2_2_7b",
    "dbrx-132b": "dbrx_132b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-780m": "mamba2_780m",
}

# Zamba2-2.7B as Zyphra runs it (models.config.Zamba2Config)
_FORM_MODULES = {"zamba2-2.7b-zyphra": "zamba2_2_7b_zyphra"}

__all__ = ["ARCHS", "FORMS", "get_config", "smoke_config", "list_archs"]

ARCHS: List[str] = list(_MODULES)
FORMS: List[str] = list(_FORM_MODULES)


def get_config(arch: str) -> ModelConfig:
    module = _MODULES.get(arch) or _FORM_MODULES.get(arch)
    if module is None:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS + FORMS}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    cfg = get_config(arch)
    over: Dict = dict(SMOKE_OVERRIDES)
    # preserve MHA-vs-GQA topology
    if cfg.n_heads and cfg.n_kv_heads == cfg.n_heads:
        over["n_kv_heads"] = over["n_heads"]
    if cfg.family == "ssm":
        over.update(n_heads=0, n_kv_heads=0, d_ff=0)
    if cfg.mrope_sections is not None:
        over["mrope_sections"] = (2, 3, 3)  # sums to smoke head_dim // 2
    if cfg.family == "hybrid":
        over["n_layers"] = 4  # 2 super-layers of (2 mamba + shared attn)
    if not cfg.n_experts:
        over.pop("n_experts", None)
        over.pop("topk", None)
        over["n_experts"] = 0
        over["topk"] = 0
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **over)


def list_archs() -> List[str]:
    return list(ARCHS)
