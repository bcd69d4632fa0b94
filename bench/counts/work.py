"""The work that kernels A, B and C and a whole decode step must do, counted
from the cell's shapes and data widths alone.

Each input byte is counted once as read and each output byte once as
written, whatever an implementation reads again.  A K/V word is 2 bytes (the
cache is bf16), and a compressed page is its serialised size under the
cell's FR configuration (``page_bytes``, ``docs/FORMAT.md`` §5), so the count
reads the same work whatever implements it.
"""
from __future__ import annotations

import dataclasses

WORD_BYTES = 2          # a bf16 K/V value


@dataclasses.dataclass(frozen=True)
class Geom:
    """One chip's share of a model's KV cache, as a cell runs it."""

    n_layers: int
    n_heads: int
    n_kv: int
    head_dim: int
    batch: int
    page_words: int
    page_bytes: int

    @property
    def row_words(self) -> int:
        return self.n_kv * self.head_dim

    @property
    def page_tokens(self) -> int:
        return max(1, self.page_words // self.row_words)

    @property
    def pages_per_row(self) -> int:
        return max(1, self.row_words // self.page_words)


def encode_bytes(n_pages: int, g: Geom) -> int:
    """Kernel A over ``n_pages`` pages: raw words in, page blobs out."""
    return n_pages * (g.page_words * WORD_BYTES + g.page_bytes)


def decode_bytes(n_pages: int, g: Geom) -> int:
    """Kernel B over ``n_pages`` pages: page blobs in, raw words out."""
    return n_pages * (g.page_bytes + g.page_words * WORD_BYTES)


def valid_pages(pos: int, g: Geom) -> int:
    """Whole pages before the one that holds ``pos``: what kernel C reads."""
    return pos // g.page_tokens


def attn_flops(tokens: int, g: Geom) -> int:
    """QK^T and PV for one query token a row over ``tokens`` cached tokens."""
    return 4 * g.batch * g.n_heads * tokens * g.head_dim


def attn_bytes(pos: int, g: Geom) -> int:
    """Kernel C at ``pos``: the K and V pages of the valid slots, q and the
    output at 2 bytes a value."""
    pages = 2 * g.batch * valid_pages(pos, g) * g.pages_per_row * g.page_bytes
    return pages + 2 * g.batch * g.n_heads * g.head_dim * WORD_BYTES


def attn_work(pos: int, g: Geom) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch of kernel C in one layer at ``pos``."""
    return attn_flops(valid_pages(pos, g) * g.page_tokens, g), attn_bytes(pos, g)


def decode_step_work(pos: int, g: Geom) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode step over every layer at ``pos``: the
    attention over ``pos + 1`` tokens; the pages read, the raw tail ring, the
    appended K and V, the blobs a flush writes (a step whose token completes
    a page), q and the output."""
    flops = attn_flops(pos + 1, g)
    row = g.batch * g.row_words * WORD_BYTES               # one token of K (or V), all rows
    nbytes = attn_bytes(pos, g)                             # pages, q, out
    nbytes += 2 * g.page_tokens * row                       # the tail ring, K and V
    nbytes += 2 * row                                       # the appended token
    if (pos + 1) % g.page_tokens == 0:
        nbytes += 2 * g.batch * g.pages_per_row * g.page_bytes
    return g.n_layers * flops, g.n_layers * nbytes


def write_op_bytes(tokens: int, g: Geom) -> int:
    """A prefill write of ``tokens`` tokens into every layer: raw K and V in,
    the blobs of their whole pages and the raw tail ring out."""
    pages = 2 * g.batch * (tokens // g.page_tokens) * g.pages_per_row
    tail = 2 * g.batch * min(tokens, g.page_tokens) * g.row_words * WORD_BYTES
    raw = 2 * g.batch * tokens * g.row_words * WORD_BYTES
    return g.n_layers * (raw + pages * g.page_bytes + tail)


def read_op_bytes(tokens: int, g: Geom) -> int:
    """A whole-cache read of ``tokens`` tokens from every layer: the blobs of
    the pages before the last token's and the tail ring in, raw K and V out."""
    pages = 2 * g.batch * valid_pages(tokens - 1, g) * g.pages_per_row
    tail = 2 * g.batch * g.page_tokens * g.row_words * WORD_BYTES
    raw = 2 * g.batch * tokens * g.row_words * WORD_BYTES
    return g.n_layers * (pages * g.page_bytes + tail + raw)
