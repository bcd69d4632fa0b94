"""Architecture registry: ``get_config(arch_id)`` + ``reduced()`` smoke configs.

Copy of :mod:`repro.configs` for the PyTorch port: the same ten published
configurations, as data.  :func:`repro_torch.models.api.build_model` builds
all ten: dense, moe (mixtral, qwen3), hybrid (zamba2), ssm (xlstm), vlm
(paligemma) and audio (musicgen).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from repro_torch.configs.deepseek_7b import CONFIG as _deepseek_7b
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3_12b
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3_27b
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.qwen3_moe_235b import CONFIG as _qwen3_moe
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.musicgen_large import CONFIG as _musicgen

ARCHS: dict[str, ModelConfig] = {
    c.arch_id: c
    for c in [
        _deepseek_7b, _gemma3_12b, _gemma3_27b, _llama3_405b, _qwen3_moe,
        _mixtral, _zamba2, _xlstm, _paligemma, _musicgen,
    ]
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family/pattern, tiny dims: one full period + one tail layer,
    CPU-runnable in a smoke test."""
    return dataclasses.replace(
        cfg,
        n_layers=len(cfg.pattern) + 1,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        window=min(cfg.window, 8),
        n_patches=4 if cfg.n_patches else 0,
        q_chunk=16,
        loss_chunk=16,
    )
