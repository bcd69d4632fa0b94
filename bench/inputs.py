"""Every input a run hands to the program and to the reference, made from
``--seed`` on the run's device.

K/V follow the repository's KV-cache family ``ml_kvcache_bf16``: per-channel
means N(0, 1) x 2 over (Kv, hd), here drawn anew for every layer and side,
plus N(0, 0.1) a token, rounded to bf16.  A query is N(0, std^2) a channel,
leaning toward its own token's key, in bf16: the traffic mix states both
numbers, so that attention is peaked, as a trained model's is, and the
output depends on the query well above its bf16 rounding.  Each tensor comes
from its own generator, seeded from the run's seed and the tensor's tags, in
one call, so the reference can draw any layer again without the others.
"""
from __future__ import annotations

import zlib

import torch

MEAN_STD = 2.0
TOKEN_STD = 0.1


def sub_seed(seed: int, *tags: object) -> int:
    """A 63-bit seed for one tensor: the run's seed mixed with its tags."""
    h = zlib.crc32(repr(tags).encode())
    return (int(seed) * 0x9E3779B97F4A7C15 + h * 0xBF58476D1CE4E5B9) % (1 << 63)


def generator(device: torch.device, seed: int, *tags: object) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def channel_means(seed: int, n_layers: int, n_kv: int, hd: int,
                  device: torch.device) -> torch.Tensor:
    """(n_layers, 2, Kv, hd) float32: each layer's K and V channel means."""
    g = generator(device, seed, "means")
    return torch.randn(n_layers, 2, n_kv, hd, generator=g, device=device) * MEAN_STD


def kv_tokens(means: torch.Tensor, shape: tuple[int, ...], seed: int, *tags: object
              ) -> torch.Tensor:
    """K and V tokens about ``means`` (..., 2, Kv, hd): a tensor of ``shape``
    whose trailing axes broadcast against the means, in bf16."""
    g = generator(means.device, seed, *tags)
    noise = torch.randn(shape, generator=g, device=means.device)
    return (noise.mul_(TOKEN_STD) + means).to(torch.bfloat16)


def queries(own: torch.Tensor, n_heads: int, std: float, own_logit: float, seed: int,
            *tags: object) -> torch.Tensor:
    """(..., n_heads, hd) bf16 queries, N(0, std^2) a channel plus a lean
    toward ``own`` (..., Kv, hd), the noise of each query's own token's keys
    about their means: query head ``h`` leans toward KV head ``h // (H / Kv)``
    so that its scaled logit on its own key stands ``own_logit`` above its
    mean logit over the other keys, in expectation.  With std s, the logits
    over the other keys spread by about s x TOKEN_STD."""
    n_kv, hd = own.shape[-2:]
    g = generator(own.device, seed, *tags)
    q = torch.randn(own.shape[:-2] + (n_heads, hd), generator=g, device=own.device).mul_(std)
    lean = own_logit / (TOKEN_STD ** 2 * hd ** 0.5)
    q += own.repeat_interleave(n_heads // n_kv, dim=-2).mul_(lean)
    return q.to(torch.bfloat16)
