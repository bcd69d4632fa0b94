"""llama3-405b [dense] — GQA, 128k vocab-ish [arXiv:2407.21783; unverified]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=500_000.0,
)
