"""Modified k-means for global-base selection, on tensors.

PyTorch counterpart of :mod:`repro.core.kmeans`: clusters int32 word bit
patterns by *encoded bit cost* (the paper's modified k-means) and pairs each
base with the width class that minimises its cluster's bits.

The float32 steps follow the JAX reference operation by operation so that a
fit on the CPU returns the same table:

* the percentile-spread init reproduces ``jnp.linspace``'s float32 index
  arithmetic;
* cluster sums are float32 ``index_add_`` in sample order, which on the CPU
  is the same sequential accumulation XLA's ``segment_sum`` performs;
* quantiles reproduce ``jnp.nanpercentile``'s linear interpolation in
  float32;
* top-k ties go to the lower sample index, as ``jax.lax.top_k`` orders them.

On the card the cluster sums run through atomics, so their float32 order and
with it the last bit of a mean may differ; the table is then equally valid
but not always identical.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import numpy.typing as npt
import torch

from repro_torch._device import resolve_device

_INT32_MIN = -(1 << 31)
_QUANTILES = (10.0, 25.0, 50.0, 75.0, 90.0)


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Fold an integer tensor to int32 two's complement (mod 2**32)."""
    v = v.to(torch.int64)
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def wrapped_delta(values: torch.Tensor, bases: torch.Tensor, word_bits: int) -> torch.Tensor:
    """(..., n, k) signed wrapping delta ``values[..., None] - bases``."""
    d = values.to(torch.int64)[..., None] - bases.to(torch.int64)
    if word_bits == 32:
        return wrap_int32(d)
    span, half = (1 << word_bits), (1 << (word_bits - 1))
    return (((d + half) & (span - 1)) - half).to(torch.int32)


def delta_magnitude(d: torch.Tensor) -> torch.Tensor:
    """m such that d fits width w iff m < 2**(w-1): ``max(d, ~d)``, INT_MIN-safe."""
    return torch.maximum(d, torch.bitwise_not(d))


def width_cost(m: torch.Tensor, width_set: Sequence[int], word_bits: int) -> torch.Tensor:
    """Smallest width class holding magnitude m, else word_bits (outlier)."""
    cost = torch.full(m.shape, word_bits, dtype=torch.int32, device=m.device)
    for w in reversed(list(width_set)):
        cost = torch.where(m < (1 << (w - 1)), w, cost)
    return cost.to(torch.int32)


def _init_bases(sample: torch.Tensor, k: int) -> torch.Tensor:
    """Percentile-spread init; float32 index arithmetic as in ``jnp.linspace``."""
    s = torch.sort(sample).values
    div = k + 1
    step = (torch.arange(div, dtype=torch.float32, device=sample.device)
            / torch.tensor(div, dtype=torch.float32, device=sample.device))
    pos = torch.tensor(s.shape[0] - 1, dtype=torch.float32, device=sample.device) * step
    idx = pos[1:].to(torch.int64)
    # break exact duplicates so no two bases start identical
    return wrap_int32(s[idx].to(torch.int64)
                      + torch.arange(k, dtype=torch.int64, device=sample.device))


def _nanquantile_cols(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Column-wise linear-interpolation quantiles ignoring NaN: (n, k) -> (len(q), k).

    Mirrors ``jnp.nanquantile`` (sort with NaN last, float32 positions
    ``q * (count - 1)``, floor/ceil clamped into the live rows).  XLA's CPU
    compiler contracts the interpolation ``low * low_w + high * high_w`` to
    ``fma(high, high_w, low * low_w)``, so that is what is computed here
    (:func:`_fma_f32`).
    """
    s = torch.sort(a, dim=0).values
    counts = (~torch.isnan(s)).sum(dim=0).to(torch.float32)         # (k,)
    pos = q[:, None] * (counts[None, :] - 1)                         # (Q, k)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    top = counts[None, :] - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top)).long()
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top)).long()
    low_v = torch.gather(s, 0, low)
    high_v = torch.gather(s, 0, high)
    return _fma_f32(high_v, high_w, low_v * low_w)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    ``a * b`` is exact in float64; the float64 sum ``s`` and its exact error
    ``err`` (TwoSum) hold ``a * b + c`` exactly.  Rounding ``s`` to float32
    is then correct except where ``s`` sits exactly halfway between two
    float32 values and ``err`` breaks the tie, which is repaired.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    back = r.double()
    other = torch.nextafter(r, torch.where(s > back, torch.inf, -torch.inf).to(r.dtype))
    tie = (s != back) & ((back + other.double()) * 0.5 == s) & (err != 0)
    toward_other = (err > 0) == (other.double() > back)
    return torch.where(tie & toward_other, other, r)


def fit_bases(
    sample: torch.Tensor,
    *,
    num_bases: int,
    width_set: tuple[int, ...],
    word_bits: int,
    iters: int = 12,
    modified: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster ``sample`` (int32 bit patterns, zeros pre-filtered) into
    ``num_bases`` global bases and pick each base's paired delta width.

    Returns ``(bases (k,) int32, widths (k,) int32)`` on ``sample.device``.
    """
    sample = sample.to(torch.int32)
    dev = sample.device
    k = num_bases
    n = sample.shape[0]
    ar_k = torch.arange(k, device=dev)
    q = (torch.tensor(_QUANTILES, dtype=torch.float32, device=dev)
         / torch.tensor(100.0, dtype=torch.float32, device=dev))

    def assign(bases: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        d = wrapped_delta(sample, bases, word_bits)
        m = delta_magnitude(d)
        a = torch.argmin(m.to(torch.float32), dim=1)   # nearest value (geometry)
        return a, d.gather(1, a[:, None])[:, 0], m.gather(1, a[:, None])[:, 0]

    def mean_shift(a: torch.Tensor, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        d_upd = d.clamp(-(1 << 15), 1 << 15).to(torch.float32)
        cnt = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(
            0, a, torch.ones_like(d_upd))
        dsum = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(0, a, d_upd)
        mean = dsum / torch.clamp_min(cnt, 1.0)
        return cnt, torch.where(cnt > 0, mean, torch.zeros_like(mean))

    def bits_shift(a: torch.Tensor, d: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
        # |d| in int32 wraps at INT_MIN, exactly as jnp.abs does
        near = (d.to(torch.int64).abs() < (1 << 24)) | (d == _INT32_MIN)
        dn = torch.where(near, d, torch.zeros_like(d)).to(torch.float32)
        masked = torch.where(a[:, None] == ar_k[None, :], dn[:, None],
                             torch.tensor(float("nan"), device=dev))    # (n, k)
        qs = _nanquantile_cols(masked, q)                                # (5, k)
        cands = torch.cat([mean[None, :], torch.nan_to_num(qs)], dim=0)  # (C, k)
        cands = torch.round(cands).to(torch.int32)
        own = cands.T[a]                                                 # (n, C)
        shifted = wrap_int32(d.to(torch.int64)[:, None] - own.to(torch.int64))
        bits = width_cost(delta_magnitude(shifted), width_set, word_bits).to(torch.float32)
        tot = torch.zeros(k, bits.shape[1], dtype=torch.float32, device=dev).index_add_(
            0, a, bits)                                                  # (k, C), exact
        best = torch.argmin(tot, dim=1)
        return cands.T.gather(1, best[:, None])[:, 0].to(torch.float32)

    bases = _init_bases(sample, k)
    n_seed = min(k, n)
    for _ in range(iters):
        a, d, m = assign(bases)
        cnt, mean = mean_shift(a, d)
        shift = bits_shift(a, d, mean) if modified else mean
        new = wrap_int32(bases.to(torch.int64) + torch.round(shift).to(torch.int64))
        # re-seed empty clusters onto the worst-covered sample values
        empty = cnt == 0
        order = torch.sort(m, descending=True, stable=True).indices[:n_seed]
        worst_vals = sample[order]
        rank = torch.clamp(torch.cumsum(empty.to(torch.int64), 0) - 1, 0, n_seed - 1)
        bases = torch.where(empty, worst_vals[rank], new)

    # pair each base with the width class minimising its cluster's bits
    a, d, m = assign(bases)
    n_tot = torch.bincount(a, minlength=k).to(torch.float32)
    per_width = []
    for w in width_set:
        n_fit = torch.bincount(a, weights=(m < (1 << (w - 1))).to(torch.float32),
                               minlength=k).to(torch.float32)
        per_width.append(n_fit * w + (n_tot - n_fit) * word_bits)
    best = torch.argmin(torch.stack(per_width, dim=0), dim=0)
    widths = torch.tensor(width_set, dtype=torch.int32, device=dev)[best]
    return bases.to(torch.int32), widths


def fit_bases_host(
    data_words: npt.NDArray[Any] | torch.Tensor,
    *,
    num_bases: int,
    width_set: tuple[int, ...],
    word_bits: int,
    iters: int = 12,
    sample_words: int = 1 << 16,
    modified: bool = True,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[npt.NDArray[np.int32], npt.NDArray[np.int32]]:
    """Host convenience wrapper: subsample, drop zero words, fit.

    ``data_words`` is a numpy array (uploaded to ``device``, the card by
    default) or a tensor (fitted on its own device unless ``device`` names
    another).  The seeded subsample draws its indices on the host with
    numpy, as the reference does, whatever the device.
    """
    if isinstance(data_words, torch.Tensor):
        dev = data_words.device if device is None else torch.device(device)
        flat = data_words.reshape(-1).to(device=dev, dtype=torch.int64)
    else:
        dev = resolve_device(device)
        host = np.ascontiguousarray(data_words).reshape(-1).astype(np.int64)
        flat = torch.from_numpy(host).to(dev)
    flat = flat[flat != 0]
    if flat.numel() == 0:  # degenerate all-zero input: any bases work
        bases = np.arange(num_bases, dtype=np.int32)
        return bases, np.full(num_bases, width_set[0], dtype=np.int32)
    if flat.numel() > sample_words:
        rng = np.random.default_rng(seed)
        idx = rng.choice(flat.numel(), sample_words, replace=False)
        flat = flat[torch.from_numpy(idx).to(dev)]
    mask = (1 << word_bits) - 1
    half = 1 << (word_bits - 1)
    sample = (((flat & mask) + half) & mask) - half  # signed view, int32-safe
    bases, widths = fit_bases(
        sample.to(torch.int32), num_bases=num_bases, width_set=tuple(width_set),
        word_bits=word_bits, iters=iters, modified=modified,
    )
    return bases.cpu().numpy().astype(np.int32), widths.cpu().numpy().astype(np.int32)
