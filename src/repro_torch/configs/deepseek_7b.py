"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    pattern=(LayerSpec("attn", "mlp"),),
    rope_theta=10_000.0,
)
