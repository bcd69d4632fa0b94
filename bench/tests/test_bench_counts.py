"""The frozen counts against hand-worked examples."""
from __future__ import annotations

import pytest

from bench.counts import peaks, work

# mixtral-8x22b's share of one chip: 1 KV head of 128, 6 query heads, 56 layers;
# a KV_FR page is 2,048 words, 3,332 bytes serialised (4 x (256 + 512) + 128 + 128 + 4)
MIXTRAL = work.Geom(n_layers=56, n_heads=6, n_kv=1, head_dim=128, batch=32,
                    page_words=2048, page_bytes=3332)
# musicgen-large: 32 KV heads of 64, one 2,048-word token a page
MUSICGEN = work.Geom(n_layers=48, n_heads=32, n_kv=32, head_dim=64, batch=32,
                     page_words=2048, page_bytes=3332)


def test_geometry():
    assert (MIXTRAL.page_tokens, MIXTRAL.pages_per_row) == (16, 1)
    assert (MUSICGEN.page_tokens, MUSICGEN.pages_per_row) == (1, 1)
    wide = work.Geom(1, 32, 32, 128, 1, 2048, 3332)
    assert (wide.page_tokens, wide.pages_per_row) == (1, 2)


def test_codec_bytes_at_two_bytes_a_word():
    # one page: 2,048 words x 2 B in, 3,332 B out (and the reverse for B)
    assert work.encode_bytes(1, MIXTRAL) == 4096 + 3332
    assert work.decode_bytes(65536, MIXTRAL) == 65536 * 7428


def test_attention_at_a_position():
    # pos 32,704: 2,044 whole pages of 16 tokens before it
    assert work.valid_pages(32704, MIXTRAL) == 2044
    flops, nbytes = work.attn_work(32704, MIXTRAL)
    assert flops == 4 * 32 * 6 * (2044 * 16) * 128
    assert nbytes == 2 * 32 * 2044 * 3332 + 2 * 32 * 6 * 128 * 2
    # musicgen at frame 2,000: 2,000 pages of one token
    assert work.attn_work(2000, MUSICGEN) == (4 * 32 * 32 * 2000 * 64,
                                              2 * 32 * 2000 * 3332 + 2 * 32 * 32 * 64 * 2)


def test_decode_step():
    # a step that does not complete a page: attention over pos + 1 tokens,
    # pages, q and out, the tail ring (16 tokens, K and V) and the appended token
    flops, nbytes = work.decode_step_work(32704, MIXTRAL)
    row = 32 * 128 * 2
    assert flops == 56 * 4 * 32 * 6 * 32705 * 128
    assert nbytes == 56 * (2 * 32 * 2044 * 3332 + 2 * 32 * 6 * 128 * 2 + 2 * 16 * row + 2 * row)
    # the 16th token completes page 2,044: its K and V blobs are written too
    _, flush = work.decode_step_work(32719, MIXTRAL)
    _, plain = work.decode_step_work(32718, MIXTRAL)
    assert flush - plain == 56 * 2 * 32 * 3332


def test_write_and_read_operations():
    raw = 2 * 32 * 32768 * 128 * 2                       # 536,870,912 B a layer
    assert work.write_op_bytes(32768, MIXTRAL) == 56 * (raw + 2 * 32 * 2048 * 3332
                                                        + 2 * 32 * 16 * 128 * 2)
    assert work.read_op_bytes(32768, MIXTRAL) == 56 * (2 * 32 * 2047 * 3332
                                                       + 2 * 32 * 16 * 128 * 2 + raw)


def test_bound_takes_the_larger_term():
    assert peaks.bound_s(989.4e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989.4e12, 6.7e12) == pytest.approx(2.0)
