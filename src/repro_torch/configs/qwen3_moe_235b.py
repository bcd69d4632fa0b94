"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

d_ff = 1536 is the per-expert FFN width (the MoE layer replaces the dense
FFN in every block).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    pattern=(LayerSpec("attn", "moe"),),
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
)
