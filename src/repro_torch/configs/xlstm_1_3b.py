"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, 7:1 [arXiv:2405.04517; unverified].

d_ff = 0 in the assignment: xLSTM blocks carry their own internal
up/down projections (mLSTM pf=2, sLSTM pf=4/3), no separate FFN.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=tuple([LayerSpec("mlstm", "none")] * 7 + [LayerSpec("slstm", "none")]),
)
