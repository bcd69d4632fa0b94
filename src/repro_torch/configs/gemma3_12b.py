"""gemma3-12b [dense] — 5:1 local:global, 128k ctx [hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    pattern=tuple([LayerSpec("local", "mlp")] * 5 + [LayerSpec("attn", "mlp")]),
    window=1024,
    tied_embeddings=True,
    rope_theta=1_000_000.0,
)
