"""The cells cut to a few pages, so that the harness runs whole on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: each cell cut to a few pages on the CPU: 256-word pages, small heads, 2-3 layers
TINY_FR = {"word_bits": 16, "page_words": 256, "num_bases": 14, "width_set": [8],
           "bucket_caps": [256], "outlier_cap": 16}
#: queries over a few dozen keys: the lean toward the own key cut so that it
#: takes about a quarter of the softmax, as in the cells
TINY_Q = {"std": 16.0, "own_key_logit": 4.0}
TINY = {
    "mixtral-8x22b.decode-32k": (
        {"num_hidden_layers": 2, "num_key_value_heads": 2, "num_attention_heads": 4,
         "head_dim": 32},
        {"batch": 2, "context": 32, "round_steps": 8, "trace_steps": 4, "queries": TINY_Q}),
    "musicgen-large.decode-2k": (
        {"num_hidden_layers": 2, "num_key_value_heads": 8, "num_attention_heads": 8,
         "head_dim": 32},
        {"batch": 2, "context": 16, "round_steps": 8, "trace_steps": 4, "queries": TINY_Q}),
    "mixtral-8x22b.prefill-readback-32k": (
        {"num_hidden_layers": 3, "num_key_value_heads": 2, "num_attention_heads": 4,
         "head_dim": 32},
        {"batch": 2, "context": 64, "check_pages": 16, "trace_ops": 2}),
}


def tiny(cell):
    """``cell`` cut to its tiny CPU size, in place."""
    config, traffic = TINY[cell.name]
    cell.config.update(config, fr=dict(TINY_FR), table_fit={"iters": 8, "sample_words": 4096})
    cell.traffic.update(traffic)
    return cell
