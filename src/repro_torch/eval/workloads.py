"""The port's workload table: synthetic dumps + ML tensors + real dumps.

PyTorch counterpart of :mod:`repro.eval.workloads`, with the reference's
families in the reference's order:

* the twelve C, Java and Column families come from
  :mod:`repro_torch.data.workloads` (copies of the reference generators, so
  both packages see the same bytes);
* ``ml_weights_fp32`` / ``ml_weights_bf16`` — the reduced deepseek-7b's
  weights after two AdamW steps (:mod:`repro_torch.models`), flattened by bit
  pattern in the reference's leaf order;
* ``ml_adamw_moments`` — first/second AdamW moments after those steps;
* ``ml_grads_bf16`` — gradients of the LM loss in bf16;
* ``ml_kvcache_bf16`` — channel-structured attention K/V in bf16; float32 ->
  bf16 rounds to nearest even in torch, as it does in JAX;
* ``dump:<name>`` (kind ``Dump``) — real memory images ingested with
  :mod:`repro_torch.eval.ingest`, found under ``dump_dir``.

The four model-backed families train the model on the registry's device:
the CUDA card unless ``device="cpu"`` is passed.  The port draws its initial
weights from its own ``torch.Generator``, so its streams differ from the
reference's draw for draw; :func:`ml_streams` turns a state carried across
from the reference into the reference's bytes exactly.  Model-derived
tensors have a fixed intrinsic size, so streams are tiled / trimmed to the
requested ``n_bytes`` — value structure, not length, is what CR depends on.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.data.workloads import WORKLOADS, generate
from repro_torch.eval.registry import Workload, WorkloadRegistry

#: the families that need a trained model, in the reference's order
MODEL_FAMILIES = ("ml_weights_fp32", "ml_weights_bf16", "ml_adamw_moments", "ml_grads_bf16")


def _fit_bytes(buf: np.ndarray, n_bytes: int) -> np.ndarray:
    """Tile/trim a byte view to n_bytes (structure matters, length doesn't)."""
    raw = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return np.resize(raw, n_bytes)


def _to_bf16_words(x: np.ndarray) -> np.ndarray:
    bf = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return bf.view(torch.int16).numpy().view(np.uint16)


def _leaves_fp32(trees: list, n_elems: int) -> np.ndarray:
    """The leaves of ``trees``, in order and each in the reference's leaf
    order, as one float32 vector cut to its first ``n_elems`` values (all of
    them if there are fewer): what ``_fit_bytes`` keeps of the whole."""
    parts, left = [], n_elems
    for tree in trees:
        for leaf in tree_leaves(tree):
            if left <= 0:
                break
            part = leaf.detach().reshape(-1)[:left].float()
            parts.append(part)
            left -= part.numel()
    return torch.cat(parts).cpu().numpy()


def ml_streams(params, grads, state, n_bytes: int) -> dict[str, np.ndarray]:
    """The four model-backed families' streams of ``n_bytes`` from a model's
    parameter and gradient trees and its AdamW state (trees of tensors on
    any device, e.g. carried from the reference by
    :func:`repro_torch.interop.params_from_numpy`)."""
    n32, n16 = -(-n_bytes // 4), -(-n_bytes // 2)
    return {
        "ml_weights_fp32": _fit_bytes(_leaves_fp32([params], n32), n_bytes).view(np.uint32),
        "ml_weights_bf16": _fit_bytes(_to_bf16_words(_leaves_fp32([params], n16)),
                                      n_bytes).view(np.uint16),
        "ml_adamw_moments": _fit_bytes(_leaves_fp32([state["m"], state["v"]], n32),
                                       n_bytes).view(np.uint32),
        "ml_grads_bf16": _fit_bytes(_to_bf16_words(_leaves_fp32([grads], n16)),
                                    n_bytes).view(np.uint16),
    }


def train_state(model, seed: int) -> tuple:
    """The reference's ``_model_state`` recipe on an initialised model: one
    ``TokenPipeline`` batch (4 x 32), the LM loss's gradients, then two AdamW
    steps with them.  Returns (params, grads, state) as trees of tensors."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.optim import adamw

    pipe = TokenPipeline(PipelineConfig(model.cfg.vocab_size, 32, 4, seed=seed))
    model.zero_grad(set_to_none=True)
    model.loss({"tokens": pipe.batch_at(0)["tokens"]})[0].backward()
    params = model.params()
    grads = tree_map(lambda p: p.grad, params)
    state = adamw.init_state(params)
    acfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    for _ in range(2):
        params, state, _ = adamw.apply_updates(acfg, params, grads, state)
    return params, grads, state


@functools.lru_cache(maxsize=4)
def _model_state(seed: int, device: str) -> tuple:
    """Init the reduced transformer once per (seed, device) from a
    ``torch.Generator`` on that device; share across families."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.api import build_model

    model = build_model(reduced(ARCHS["deepseek-7b"]), device)
    model.init(torch.Generator(device=device).manual_seed(seed))
    return train_state(model, seed)


def _model_family(name: str, n_bytes: int, seed: int, *, device: str | None = None) -> np.ndarray:
    params, grads, state = _model_state(seed, str(resolve_device(device)))
    return ml_streams(params, grads, state, n_bytes)[name]


def ml_kvcache_bf16(n_bytes: int, seed: int) -> np.ndarray:
    """Channel-structured attention K/V in bf16 (per-channel means + noise)."""
    n_kv, hd = 4, 32
    rng = np.random.default_rng(seed)
    n_tok = max(1, n_bytes // (2 * n_kv * hd))
    ch = rng.normal(0, 1, (1, n_kv, hd)) * 2            # per-channel means
    kv = (ch + rng.normal(0, 0.1, (n_tok, n_kv, hd))).astype(np.float32)
    return _fit_bytes(_to_bf16_words(kv.reshape(-1)), n_bytes).view(np.uint16)


_ML_FAMILIES = [
    ("ml_weights_fp32", 32, "reduced-transformer weights, fp32"),
    ("ml_weights_bf16", 16, "reduced-transformer weights, bf16"),
    ("ml_adamw_moments", 32, "AdamW m/v moments after real steps"),
    ("ml_grads_bf16", 16, "LM-loss gradients, bf16 transport"),
    ("ml_kvcache_bf16", 16, "channel-structured attention K/V, bf16"),
]


def default_workloads(dump_dir: str | None = None, *,
                      device: str | None = None) -> WorkloadRegistry:
    """The full registry: synthetic families, ML tensors (the model-backed
    ones trained on ``device``, resolved when first generated), and any real
    ``dump:<name>`` families found under ``dump_dir`` (default:
    ``$REPRO_DUMP_DIR`` or ``experiments/dumps``; a missing directory just
    means no Dump kind)."""
    from repro_torch.eval import ingest

    reg = WorkloadRegistry()
    for name, (kind, fn) in WORKLOADS.items():
        reg.register(Workload(
            name=name, kind=kind,
            generate=functools.partial(generate, name), word_bits=32,
            description=fn.__doc__.strip().splitlines()[0] if fn.__doc__ else "",
        ))
    for name, wb, desc in _ML_FAMILIES:
        gen = (ml_kvcache_bf16 if name == "ml_kvcache_bf16"
               else functools.partial(_model_family, name, device=device))
        reg.register(Workload(name=name, kind="ML", generate=gen, word_bits=wb, description=desc))
    ingest.scan_dump_dir(reg, dump_dir if dump_dir is not None else ingest.default_dump_dir())
    return reg


__all__ = ["MODEL_FAMILIES", "WORKLOADS", "default_workloads", "generate", "ml_kvcache_bf16",
           "ml_streams", "train_state"]
