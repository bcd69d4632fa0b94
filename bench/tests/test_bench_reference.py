"""The frozen reference against the program's plain versions on the CPU.

The reference under ``bench/reference`` imports nothing of the program; here
(and only here) the two meet, at small sizes, so that the yardstick is
known to be the program's own format at the time it was frozen.
"""
from __future__ import annotations

import pytest
import torch

from bench import inputs
from bench.reference import attention as ref_attn
from bench.reference import fr as R
from repro_torch.core.gbdi_fr import FRConfig, fit_fr_bases, fr_decode, fr_encode
from repro_torch.core.format import BaseTable
from repro_torch.kernels.gbdi_paged_attn import paged_attention_decode_plain
from repro_torch.serving import kv_cache as kvc

CONFIGS = {
    "kv_fr": dict(word_bits=16, page_words=2048, num_bases=14, width_set=(8,),
                  bucket_caps=(2048,), outlier_cap=64),
    "bf16_two_widths": dict(word_bits=16, page_words=256, num_bases=14, width_set=(4, 8),
                            bucket_caps=(24, 232), outlier_cap=16),
    "word32": dict(word_bits=32, page_words=256, num_bases=14, width_set=(8, 16),
                   bucket_caps=(128, 128), outlier_cap=32),
    "adaptive": dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
                     bucket_caps=(64, 192), outlier_cap=8,
                     cap_profiles=((64, 192), (192, 64), (0, 256))),
}


def _words(cfg: dict, n_pages: int, seed: int) -> torch.Tensor:
    """KV-like words (the bench's own family) with a spread of outliers."""
    g = torch.Generator().manual_seed(seed)
    P, wb = cfg["page_words"], cfg["word_bits"]
    x = torch.randn(n_pages * P, generator=g) * 2 + torch.randn(n_pages * P, generator=g) * 0.1
    if wb == 16:
        w = R.bf16_to_words(x)
    else:
        w = x.view(torch.int32)
    w[torch.rand(w.shape, generator=g) < 0.02] = 0
    return w.reshape(n_pages, P)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fit_encode_decode_equal_the_program(name):
    cfg = CONFIGS[name]
    fr, prog = R.FR(**cfg), FRConfig(**cfg)
    x = _words(cfg, 6, seed=len(name))
    bases, widths = R.fit_table(x, fr, iters=8, sample_cap=4096)
    table = fit_fr_bases(x, prog, iters=8, sample_cap=4096)
    assert torch.equal(bases, table.bases) and torch.equal(widths, table.widths)
    want = fr_encode(x, BaseTable(bases, widths), prog)
    got = R.encode_chunked(x, bases, widths, fr, chunk=4)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(R.decode_chunked(got, bases, widths, fr, chunk=4),
                       fr_decode(want, BaseTable(bases, widths), prog))
    assert fr.page_bytes() == prog.compressed_bytes_per_page()
    assert fr.ptr_lanes == prog.ptr_lanes and fr.delta_lanes == prog.delta_lanes


def test_bf16_word_views_equal_the_program():
    from repro_torch.core.gbdi_fr import bf16_to_words, words_to_bf16

    own = torch.randn(4, 2, 32, generator=torch.Generator().manual_seed(11)) * inputs.TOKEN_STD
    x = inputs.queries(own, 2, 16.0, 4.0, 11, "x").reshape(4, 64)
    assert torch.equal(R.bf16_to_words(x), bf16_to_words(x))
    w = R.bf16_to_words(x)
    assert torch.equal(R.words_to_bf16(w).view(torch.int16), words_to_bf16(w).view(torch.int16))


@pytest.mark.parametrize("std,own_logit", [(1.0, 0.0), (16.0, 4.0)], ids=["flat", "peaked"])
def test_attention_equals_the_programs_oracle_backend(std, own_logit):
    """float32 attention over a decoded cache equals kv_cache's paged backend
    to its output's bf16 rounding, and the plain paged version to float32;
    under flat attention the oracle backend too (it rounds its probabilities
    to bf16, which peaked attention shows above the output's rounding)."""
    cpu = torch.device("cpu")
    fr = FRConfig(word_bits=16, page_words=256, num_bases=14, width_set=(8,),
                  bucket_caps=(256,), outlier_cap=16)
    spec = kvc.KVSpec(2, 32, max_len=40, fr=fr)
    m = inputs.channel_means(3, 1, 2, 32, cpu)[0].reshape(2, 1, 1, 2, 32)
    kv = inputs.kv_tokens(m, (2, 3, 37, 2, 32), 3, "t")
    words = R.bf16_to_words(kv[:, 0].reshape(2, -1))
    bases, widths = R.fit_table(words, R.FR.from_dict({**fr.__dict__, "width_set": [8]}),
                                iters=8, sample_cap=4096)
    cache = kvc.init_compressed(spec, 3, BaseTable(bases, widths), device="cpu")
    kvc.extend(spec, cache, kv[0], kv[1], 0)
    pos = 36
    q = inputs.queries(kv[0, :, pos:pos + 1].float() - m[0], 8, std, own_logit, 3, "q")
    K, V, _ = kvc.read_full(spec, cache, pos)
    ref = ref_attn.attend(q[:, 0], K[:, :pos + 1], V[:, :pos + 1])
    backends = ("oracle", "paged") if own_logit == 0 else ("paged",)
    for b in backends:
        got = kvc.attention_decode(spec, q, cache, pos, backend=b).float()
        gap = ((got.reshape(ref.shape) - ref).abs() / ref.abs().clamp_min(1.0)).max()
        assert gap <= 2.0 ** -8
    acc, _, l = paged_attention_decode_plain(q.reshape(3, 2, 4, 32), cache["k_pages"],
                                              cache["v_pages"], cache["table"], 32, fr,
                                              n_kv=2, hd=32, groups=4)
    ref32 = ref_attn.attend(q[:, 0], K[:, :32], V[:, :32])
    assert torch.allclose((acc / l[..., None]).reshape(ref32.shape), ref32, atol=1e-5, rtol=1e-5)


def test_fp8_control_rounds_below_bf16():
    x = torch.tensor([2.0625, -0.3, 5.5, 1e-3], dtype=torch.bfloat16)
    y = ref_attn.to_fp8(x)
    assert y.dtype == torch.bfloat16 and (y != x).any() and torch.equal(ref_attn.to_fp8(y), y)
