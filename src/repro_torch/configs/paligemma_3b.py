"""paligemma-3b [vlm] — SigLIP + gemma [arXiv:2407.07726; hf].

The SigLIP vision tower is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings (256 patches) which form a
bidirectional prefix ahead of the causal text tokens (prefix-LM).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    pattern=(LayerSpec("attn", "mlp"),),
    n_patches=256,
    tied_embeddings=True,
    rope_theta=10_000.0,
)
