"""Unified model configuration covering all six assigned families.

Copy of :mod:`repro.models.config` for the PyTorch port (plain data).  A
model is a repeating ``pattern`` of layer specs (mixer, ffn) applied
``n_layers`` times: the parameters of full repetitions are stacked on a
leading axis (:mod:`repro_torch.models.transformer`, as the reference
stacks them for its scan), the remainder is kept per layer.  This preserves
exact layer order for heterogeneous stacks (gemma3 5:1 local:global, zamba2
6:1 mamba:shared-attention, xlstm 7:1 mLSTM:sLSTM).  Fields that steer only
the reference's XLA lowering (``remat``, ``scan_unroll``, ``mesh_axes``,
``dp_shards``) are kept so configs carry across unchanged; the port reads
none of them.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "local", "mamba", "shared_attn", "mlstm", "slstm"]
Ffn = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ffn: Ffn = "mlp"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0                 # 0 -> d_model // n_heads
    window: int = 1024                # local-attention window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / recurrent
    ssm_state: int = 0
    conv_width: int = 4
    # modality stubs
    n_codebooks: int = 0              # audio: parallel output heads
    n_patches: int = 0                # vlm: prefix patch embeddings
    # misc
    tied_embeddings: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # perf knobs (hillclimbed in EXPERIMENTS.md §Perf)
    q_chunk: int = 512                # query chunk for attention scan
    loss_chunk: int = 512             # seq chunk for logits+CE scan
    remat: str = "period"             # none|period (checkpoint each period)
    scan_unroll: int = 1
    # distribution: DP mesh axes for activation sharding constraints
    # (empty = single-device runs, no constraints inserted)
    mesh_axes: tuple = ()
    dp_shards: int = 1                # product of mesh_axes sizes (set by launch)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_layers(self) -> tuple[LayerSpec, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def sub_quadratic(self) -> bool:
        """True if no mixer needs a full-length quadratic cache (long_500k ok)."""
        return all(s.mixer != "attn" and s.mixer != "shared_attn" for s in self.pattern) or all(
            s.mixer in ("local", "mamba", "mlstm", "slstm") for s in self.pattern
        )

    def param_count(self) -> int:
        """Exact dense parameter count (used for 6ND roofline checks)."""
        d, hd = self.d_model, self.head_dim_
        specs = list(self.pattern) * self.n_periods + list(self.tail_layers)
        shared_counted = False
        total = self.vocab_size * d  # embed
        if not self.tied_embeddings:
            total += d * self.vocab_size * max(1, self.n_codebooks or 1)
        total += d  # final norm
        for s in specs:
            if s.mixer in ("attn", "local", "shared_attn"):
                if s.mixer == "shared_attn" and shared_counted:
                    pass
                else:
                    total += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                    total += (self.n_heads * hd) * d + 2 * d  # out proj + norms
                    if s.mixer == "shared_attn":
                        total += 2 * (d * self.d_ff + self.d_ff * d)  # its own mlp
                        shared_counted = True
            elif s.mixer == "mamba":
                di, n = 2 * d, self.ssm_state
                total += d * (2 * di + 2 * n + (di // 64)) + di * d + di * self.conv_width + 2 * d
            elif s.mixer == "mlstm":
                di = 2 * d
                total += d * di * 4 + di * d + 2 * d
            elif s.mixer == "slstm":
                total += 4 * d * d + 2 * d
            if s.ffn == "mlp":
                total += 3 * d * self.d_ff + d
            elif s.ffn == "moe":
                total += d * self.n_experts + self.n_experts * 3 * d * self.d_ff + d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        specs = list(self.pattern) * self.n_periods + list(self.tail_layers)
        n_moe = sum(1 for s in specs if s.ffn == "moe")
        moe_all = n_moe * self.n_experts * 3 * self.d_model * self.d_ff
        moe_active = n_moe * self.top_k * 3 * self.d_model * self.d_ff
        return full - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
