"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].

Period: 6 Mamba2 blocks then one shared-weight attention+MLP block (weights
shared across all invocations, per-invocation KV cache).  81 layers = 11
full periods + 4 tail mamba blocks.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    pattern=tuple([LayerSpec("mamba", "none")] * 6 + [LayerSpec("shared_attn", "none")]),
    ssm_state=64,
    rope_theta=10_000.0,
)
