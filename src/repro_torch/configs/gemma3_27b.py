"""gemma3-27b [dense] — 5:1 local:global, 128k ctx [hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b",
    family="dense",
    n_layers=62,                      # 10 full periods + 2 local tail layers
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    pattern=tuple([LayerSpec("local", "mlp")] * 5 + [LayerSpec("attn", "mlp")]),
    window=1024,
    tied_embeddings=True,
    rope_theta=1_000_000.0,
)
