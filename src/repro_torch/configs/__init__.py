"""Configs of the PyTorch port: its own copy of the DPSNN dataclasses
and grids (``base.py``, ``dpsnn.py``), and of the LM zoo's dataclasses,
its ten arch configs (one module each) and the registry below
(``get_config(arch_id)``, ``reduced_config(arch_id)``, ``ARCH_IDS``),
copied from ``repro/configs/__init__.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AttnConfig, DPSNNConfig,  # noqa: F401
                                      ModelConfig, MoEConfig, SHAPES,
                                      ShapeConfig, SSMConfig, TrainConfig)

_ARCH_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "whisper-medium": "whisper_medium",
    "gemma2-27b": "gemma2_27b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-2b": "granite_3_2b",
    "gemma2-9b": "gemma2_9b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-1b": "internvl2_1b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    import importlib
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def reduced_config(arch_id: str) -> ModelConfig:
    """Same-family tiny instance for CPU smoke tests: few layers, small
    width/vocab/experts — preserves every structural feature (group
    layout divisibility, GQA ratio, softcaps, shared blocks...)."""
    cfg = get_config(arch_id)
    kw = dict(
        num_layers=4,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        attn=dataclasses.replace(
            cfg.attn, num_heads=4, num_kv_heads=min(cfg.attn.num_kv_heads, 2),
            head_dim=16,
            sliding_window=32 if cfg.attn.sliding_window else 0),
        dtype="float32",
        remat="none",
    )
    if cfg.moe is not None:
        # high capacity factor: random-init routing must not drop tokens
        # in the smoke tests (drops are legitimate at training scale but
        # break decode/forward parity assertions)
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4,
                                        capacity_factor=8.0)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk=16)
    if cfg.num_decoder_layers:
        kw["num_decoder_layers"] = 2
    if cfg.family == "hybrid":
        kw["num_layers"] = 15      # 2 groups of 6 + 3 tail (exercises tail)
    return dataclasses.replace(cfg, **kw)
