"""Public model API: build once from a ModelConfig, use everywhere.

  model = build_model(cfg, device)
  model.init(generator)                       # or model.set_params(tree)
  loss, metrics = model.loss(batch)           # train; loss.backward() fills .grad
  cache, logits = model.prefill(batch, cache) # serving
  logits, cache = model.decode_step(step_in, cache, pos)

PyTorch counterpart of :mod:`repro.models.api`, every family of the ten
configs.  A :class:`Model` is an ``nn.Module`` whose parameters sit at the
reference's tree paths (``embed``, ``final_norm.scale``, ``head``,
``stack.periods.slot0.attn.wq``, ``stack.shared.mlp.wg``, ...);
:meth:`Model.params` gives them back as the reference's nested dict and
:meth:`Model.flatten_params` in its leaf order (dict keys sorted, as
``jax.tree.leaves`` walks them).  Batch layouts by family, numpy or torch:

  LM:    {"tokens": (B, S) int}                        labels = shifted tokens
  vlm:   {"patch_embeds": (B, P, d), "tokens": (B, S-P)}  prefix-LM over patches
  audio: {"frame_embeds": (B, S, d), "targets": (B, S, K)}  K codebook heads

The cross-entropy is computed in sequence chunks so the full (B, S, V)
logits tensor is never materialised.  Serving methods run under
``torch.no_grad`` and never write a cache in place: each returns a new cache
tree, which is what lets :meth:`Model.prefill_into` keep other rows
bit-stable.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch._tree import path_str, tree_flatten_with_path, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, constrain_batch, dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.transformer import (
    ATTN_MIXERS,
    stack_apply,
    stack_cache_init,
    stack_init,
)

if TYPE_CHECKING:
    from repro_torch.serving.kv_cache import KVSpec


def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (seq-chunked CE)."""
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return S


def _register(module: nn.Module, tree: dict) -> None:
    """Register a nested dict of tensors on ``module``: a tensor becomes a
    parameter, a dict a child module, a list a ``ModuleList``."""
    for key, value in tree.items():
        if isinstance(value, dict):
            child = nn.Module()
            _register(child, value)
            module.add_module(key, child)
        elif isinstance(value, list):
            seq = nn.ModuleList()
            for item in value:
                child = nn.Module()
                _register(child, item)
                seq.append(child)
            module.add_module(key, seq)
        else:
            module.register_parameter(
                key, nn.Parameter(value, requires_grad=value.is_floating_point()))


def _tree_of(module: nn.Module) -> Any:
    if isinstance(module, nn.ModuleList):
        return [_tree_of(m) for m in module]
    out: dict = dict(module._parameters)
    out.update({k: _tree_of(m) for k, m in module._modules.items()})
    return out


class Model(nn.Module):
    """A model of any of the configs' families with the reference's
    parameter tree."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    # -- parameters ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Draw fresh parameters from ``generator`` (on its device, moved to
        the model's) and register them; returns the parameter tree."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        p: Params = {"stack": stack_init(generator, cfg, dt, dev),
                     "final_norm": rmsnorm_init(cfg.d_model, dt, dev)}
        if cfg.family != "audio":
            embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                                device=generator.device, dtype=torch.float32)
            p["embed"] = (embed * 0.02).to(device=dev, dtype=dt)
        if not cfg.tied_embeddings:
            if cfg.n_codebooks:
                p["head"] = dense_init(generator, (cfg.n_codebooks, cfg.d_model, cfg.vocab_size),
                                       dt, dev, in_axis=1)
            else:
                p["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), dt, dev)
        return self.set_params(p)

    def set_params(self, tree: Params) -> Params:
        """Register ``tree`` (the reference's nested dict) as the parameters,
        replacing any there were."""
        for key in list(self._parameters):
            del self._parameters[key]
        for key in list(self._modules):
            del self._modules[key]
        _register(self, tree)
        return self.params()

    def params(self) -> Params:
        """The parameters as the reference's nested dict tree."""
        return _tree_of(self)

    def flatten_params(self) -> dict[str, nn.Parameter]:
        """``{"stack/periods/slot0/attn/wq": param, ...}`` in the reference's
        leaf order."""
        return {path_str(path): leaf for path, leaf in tree_flatten_with_path(self.params())}

    # -- embedding / head ----------------------------------------------------
    def _tensor(self, x: Any, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _tokens(self, batch: dict, key: str = "tokens") -> torch.Tensor:
        return self._tensor(batch[key], torch.int64)

    def _embed_inputs(self, p: Params, batch: dict) -> tuple[torch.Tensor, int]:
        """(input embeddings, prefix length): audio takes its frame
        embeddings as they come; vlm puts its patch embeddings ahead of the
        tokens as a bidirectional prefix (absent in decode)."""
        cfg = self.cfg
        if cfg.family == "audio":
            return self._tensor(batch["frame_embeds"], self.dtype), 0
        tok = p["embed"][self._tokens(batch)]
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = torch.cat([self._tensor(batch["patch_embeds"], tok.dtype), tok], dim=1)
            return x, cfg.n_patches
        return tok, 0

    def _head(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tied_embeddings:
            return torch.einsum("bsd,vd->bsv", h, p["embed"])
        if self.cfg.n_codebooks:
            return torch.einsum("bsd,kdv->bskv", h, p["head"])
        return torch.einsum("bsd,dv->bsv", h, p["head"])

    # -- forward ------------------------------------------------------------
    def hidden(self, batch: dict, *, cache: Params | None = None, cache_pos: Any = None,
               mode: str = "train") -> tuple[torch.Tensor, Params | None, torch.Tensor, int]:
        """(final-norm hidden states, new cache or None, aux loss, prefix length)."""
        cfg, p = self.cfg, self.params()
        x, prefix_len = self._embed_inputs(p, batch)
        x = constrain_batch(x, cfg)
        S = x.shape[1]
        if mode == "decode":
            if getattr(cache_pos, "ndim", 0) > 0:
                # per-slot positions: (B,) -> (B, S=1) for RoPE
                cache_pos = torch.as_tensor(cache_pos, dtype=torch.int64, device=self.device)
                positions = cache_pos[:, None]
            else:
                cache_pos = int(cache_pos)
                positions = torch.tensor([cache_pos], dtype=torch.int64, device=self.device)
        else:
            positions = torch.arange(S, dtype=torch.int64, device=self.device)
        x, new_cache, aux = stack_apply(p["stack"], cfg, x, positions, prefix_len=prefix_len,
                                        cache=cache, cache_pos=cache_pos, mode=mode)
        return rmsnorm(p["final_norm"], x, cfg.norm_eps), new_cache, aux, prefix_len

    def forward(self, batch: dict) -> torch.Tensor:
        h, _, _, _ = self.hidden(batch)
        return self._head(self.params(), h)

    # -- loss (seq-chunked CE) -----------------------------------------------
    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        cfg, p = self.cfg, self.params()
        h, _, aux, prefix_len = self.hidden(batch, mode="train")
        # next-token targets via roll + zero weight on the last position, so
        # the chunks see the full (divisible) sequence length
        if cfg.family == "audio":
            t_in = torch.roll(self._tokens(batch, "targets"), -1, dims=1)
        else:
            if cfg.family == "vlm":
                h = h[:, prefix_len:]
            t_in = torch.roll(self._tokens(batch), -1, dims=1)
        t_in = t_in.clamp_min(0)
        B, S = h.shape[:2]
        w_in = torch.ones((S,), dtype=torch.float32, device=h.device)
        w_in[-1] = 0.0
        C = _pick_chunk(S, cfg.loss_chunk)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(S // C):
            chunk = slice(i * C, (i + 1) * C)
            hc, tc, wc = h[:, chunk], t_in[:, chunk], w_in[chunk]
            logits = self._head(p, constrain_batch(hc, cfg)).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, tc[..., None])[..., 0]
            nll = logz - gold
            if nll.ndim == 3:  # codebook heads: (B, C, K)
                nll = nll.sum(-1)
            total = total + (nll * wc[None, :]).sum()
        denom = B * (S - 1) * max(1, cfg.n_codebooks)
        return total / denom + 0.01 * aux, {"ce": total / denom, "aux": aux}

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        return stack_cache_init(self.cfg, batch, max_len, self.dtype, self.device)

    @property
    def n_kv_layers(self) -> int:
        """Attention-bearing layers — the ones owning a (B, S, Kv, hd) KV
        cache.  A serving scheduler multiplies per-layer KV byte costs by
        this to account a whole sequence's cache footprint."""
        cfg = self.cfg
        per_period = sum(1 for s in cfg.pattern if s.mixer in ATTN_MIXERS)
        tail = sum(1 for s in cfg.tail_layers if s.mixer in ATTN_MIXERS)
        return cfg.n_periods * per_period + tail

    def kv_cache_spec(self, max_len: int, *, fr: Any = None,
                      resident_decode: bool = False) -> KVSpec:
        """Per-layer compressed-KV geometry (:class:`repro_torch.serving.kv_cache.KVSpec`)
        matching this model's attention shape."""
        from repro_torch.serving.kv_cache import KV_FR, KVSpec

        cfg = self.cfg
        return KVSpec(n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_, max_len=max_len,
                      fr=fr if fr is not None else KV_FR, resident_decode=resident_decode)

    @torch.no_grad()
    def prefill(self, batch: dict, cache: Params) -> tuple[Params, torch.Tensor]:
        h, new_cache, _, _ = self.hidden(batch, cache=cache, mode="prefill")
        return new_cache, self._head(self.params(), h[:, -1:])

    def merge_cache_rows(self, old: Params, new: Params, keep_new: torch.Tensor) -> Params:
        """Row-wise cache merge: batch rows where ``keep_new`` is True take
        ``new``, the rest keep ``old`` bit-for-bit.  Period-stacked leaves
        carry batch on axis 1, tail leaves on axis 0."""
        keep = torch.as_tensor(keep_new, dtype=torch.bool, device=self.device)

        def merge(axis: int):
            def f(o: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
                shape = [1] * o.ndim
                shape[axis] = keep.shape[0]
                return torch.where(keep.reshape(shape), n, o)
            return f

        out: Params = {}
        if "periods" in old:
            out["periods"] = tree_map(merge(1), old["periods"], new["periods"])
        out["tail"] = tree_map(merge(0), old["tail"], new["tail"])
        return out

    def prefill_into(self, batch: dict, cache: Params,
                     row_mask: torch.Tensor) -> tuple[Params, torch.Tensor]:
        """Prefill only the batch rows selected by ``row_mask`` (bool (B,)),
        leaving every other row's cache untouched (bit-stable)."""
        new_cache, logits = self.prefill(batch, cache)
        return self.merge_cache_rows(cache, new_cache, row_mask), logits

    @torch.no_grad()
    def decode_step(self, step_in: dict, cache: Params, pos: Any) -> tuple[torch.Tensor, Params]:
        """step_in: {"tokens": (B, 1)} (LM, vlm) or {"frame_embeds": (B, 1, d)}
        (audio).  ``pos`` is a scalar (shared decode position) or a (B,)
        vector of per-slot positions (continuous batching with staggered
        admits)."""
        h, new_cache, _, _ = self.hidden(step_in, cache=cache, cache_pos=pos, mode="decode")
        return self._head(self.params(), h), new_cache


def build_model(cfg: ModelConfig, device: str | torch.device | None = None) -> Model:
    """A :class:`Model` on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for)."""
    return Model(cfg, device)
