"""Bridge for state carried across from the JAX package, as numpy arrays.

The port imports nothing of :mod:`repro`; a caller that holds the reference's
state (a fitted table, a config, a blob) hands it over as numpy arrays and
plain fields, and gets the port's objects back:

* :func:`table_from_numpy` — ``(bases, widths)`` -> :class:`BaseTable`;
* :func:`config_from_fields` — the reference ``FRConfig``'s dataclass fields
  (e.g. ``dataclasses.asdict(cfg)``) -> the port's :class:`FRConfig`;
* :func:`blob_from_numpy` / :func:`blob_to_numpy` — blob dicts both ways;
* :func:`kv_spec_from_fields` — the reference ``KVSpec``'s fields (its
  ``fr`` as a field mapping) -> the port's :class:`KVSpec`;
* :func:`cache_from_numpy` — a reference KV cache tree -> the port's cache.

With these, one package can encode and the other decode, and both can
attend over the same cache.  Like every entry point of the port, the
helpers that make tensors put them on the CUDA card unless ``device``
names another (``device="cpu"`` for the host).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.format import BaseTable
from repro_torch.core.gbdi_fr import FRConfig
from repro_torch.serving.kv_cache import Cache, KVSpec

#: the reference FRConfig's constructor fields (``delta_bits`` is an
#: init-only alias and never carried)
CONFIG_FIELDS = ("word_bits", "page_words", "num_bases", "width_set",
                 "bucket_caps", "outlier_cap", "cap_profiles")


def table_from_numpy(bases: Any, widths: Any,
                     device: str | torch.device | None = None) -> BaseTable:
    device = resolve_device(device)
    return BaseTable(
        torch.as_tensor(np.array(bases, dtype=np.int32), device=device),
        torch.as_tensor(np.array(widths, dtype=np.int32), device=device),
    )


def config_from_fields(fields: Mapping[str, Any] | None = None, **kw: Any) -> FRConfig:
    """Build the port's config from the reference config's field values."""
    vals = {**(fields or {}), **kw}
    unknown = set(vals) - set(CONFIG_FIELDS)
    if unknown:
        raise ValueError(f"not FRConfig fields: {sorted(unknown)}")

    def tup(v: Any) -> Any:
        return tuple(tup(x) for x in v) if isinstance(v, (list, tuple)) else v

    return FRConfig(**{k: tup(v) for k, v in vals.items()})


def blob_from_numpy(blob: Mapping[str, Any],
                    device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Blob arrays (any int dtype) -> contiguous int32 tensors on ``device``."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, dtype=np.int32), device=device).contiguous()
            for k, v in blob.items()}


def blob_to_numpy(blob: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).astype(np.int32)
            for k, v in blob.items() if not k.startswith("_")}


def kv_spec_from_fields(fields: Mapping[str, Any] | None = None, **kw: Any) -> KVSpec:
    """The port's KVSpec from the reference KVSpec's field values (e.g.
    ``dataclasses.asdict(spec)``, whose ``fr`` is then a field mapping)."""
    vals = {**(fields or {}), **kw}
    if isinstance(vals.get("fr"), Mapping):
        vals["fr"] = config_from_fields(vals["fr"])
    return KVSpec(**vals)


def _bf16_from_numpy(words: Any, device: str | torch.device | None = None) -> torch.Tensor:
    """bf16 bit patterns as uint16 (or any int dtype) -> a bf16 tensor."""
    device = resolve_device(device)
    w16 = np.ascontiguousarray(np.asarray(words).astype(np.uint16)).view(np.int16)
    return torch.from_numpy(w16).view(torch.bfloat16).to(device)


def cache_from_numpy(tree: Mapping[str, Any],
                     device: str | torch.device | None = None) -> Cache:
    """A reference KV cache tree handed over as numpy -> the port's cache.

    ``tree`` holds ``k_pages``/``v_pages`` (blob dicts of int arrays),
    ``k_tail``/``v_tail`` (and ``k_dec``/``v_dec`` for a resident cache) as
    their uint16 bf16 words, and ``table`` as ``(bases, widths)``.
    """
    device = resolve_device(device)
    cache: Cache = {side: blob_from_numpy(tree[side], device=device)
                    for side in ("k_pages", "v_pages")}
    for key in ("k_tail", "v_tail", "k_dec", "v_dec"):
        if key in tree:
            cache[key] = _bf16_from_numpy(tree[key], device=device)
    cache["table"] = table_from_numpy(*tree["table"], device=device)
    return cache


__all__ = ["CONFIG_FIELDS", "blob_from_numpy", "blob_to_numpy",
           "cache_from_numpy", "config_from_fields", "kv_spec_from_fields",
           "table_from_numpy"]
