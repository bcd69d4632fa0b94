"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

Sliding-window attention (4096) per the assignment listing; long_500k decode
therefore runs with a ring-buffer window cache.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    pattern=(LayerSpec("local", "moe"),),
    window=4096,
    n_experts=8,
    top_k=2,
    rope_theta=1_000_000.0,
)
