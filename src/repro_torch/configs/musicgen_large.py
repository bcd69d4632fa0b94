"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

The EnCodec frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings; the backbone predicts 4 parallel codebook
heads of vocab 2048 (the delay-pattern interleaving is a data-layout
concern outside the backbone).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=(LayerSpec("attn", "mlp"),),
    n_codebooks=4,
    rope_theta=10_000.0,
)
