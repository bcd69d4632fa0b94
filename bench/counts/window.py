"""The work that kernel C and a whole decode step must do in a model whose
layers mix sliding-window and full attention, counted from the cell's
shapes, its ``layer_types`` and its ``sliding_window``.

A query at ``pos`` in a window layer of ``W`` tokens attends over positions
``[pos - W + 1, pos]``; kernel C takes the full pages' part, ``[lo, cur *
pt)`` with ``cur = pos // pt``, and needs only the pages that hold those
tokens (the ring's other slots, the oldest page's early tokens and a flush
step's reused slot, are masked and not counted).  A full layer is ``W`` 0,
which gives :mod:`bench.counts.work`'s numbers.  Bytes and FLOPs are counted
as there: each input byte once, a page at its serialised size.
"""
from __future__ import annotations

import re

from bench.counts import work
from bench.counts.work import WORD_BYTES, Geom

#: the name ``layer_types`` gives a sliding-window layer
SLIDING = "sliding_attention"
#: kernel C's ring instantiation, ``attn_kernel<CPL, WIDE, true>``, by the
#: name the profiler gives it
RING_KERNEL = re.compile(r"(^|\W)attn_kernel<[^<>]*,\s*true>")


def layer_windows(config: dict) -> list[int]:
    """Each layer's window in tokens, 0 for a full-attention layer."""
    return [config["sliding_window"] if t == SLIDING else 0 for t in config["layer_types"]]


def first_position(pos: int, window: int) -> int:
    """The first position a query at ``pos`` attends to."""
    return max(0, pos - window + 1) if window else 0


def read_pages(pos: int, g: Geom, window: int) -> int:
    """Whole pages before the one that holds ``pos`` that hold a token the
    window reaches: what kernel C must read in one layer."""
    cur = pos // g.page_tokens
    return max(0, cur - first_position(pos, window) // g.page_tokens)


def page_tokens_attended(pos: int, g: Geom, window: int) -> int:
    """Tokens of those pages inside the window, ``[lo, cur * pt)``."""
    return max(0, pos // g.page_tokens * g.page_tokens - first_position(pos, window))


def attn_work(pos: int, g: Geom, window: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch of kernel C in one layer at ``pos``: the
    K and V pages it must read, q and the output at 2 bytes a value."""
    pages = 2 * g.batch * read_pages(pos, g, window) * g.pages_per_row * g.page_bytes
    nbytes = pages + 2 * g.batch * g.n_heads * g.head_dim * WORD_BYTES
    return work.attn_flops(page_tokens_attended(pos, g, window), g), nbytes


def decode_layer_work(pos: int, g: Geom, window: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one layer's part of a decode step at ``pos``: the
    attention over ``[lo, pos]``; C's pages, q and the output; the raw tail
    ring, the appended K and V, and the blobs a flush writes (a step whose
    token completes a page)."""
    flops = work.attn_flops(pos + 1 - first_position(pos, window), g)
    row = g.batch * g.row_words * WORD_BYTES                # one token of K (or V), all rows
    nbytes = attn_work(pos, g, window)[1]
    nbytes += 2 * g.page_tokens * row + 2 * row
    if (pos + 1) % g.page_tokens == 0:
        nbytes += 2 * g.batch * g.pages_per_row * g.page_bytes
    return flops, nbytes


def step_attn_bound_s(pos: int, g: Geom, windows: list[int], bound_s) -> float:
    """The least time of kernel C's launches of one step, every layer:
    ``bound_s(flops, bytes)`` a launch, summed."""
    return sum(bound_s(*attn_work(pos, g, w)) for w in windows)


def decode_step_work(pos: int, g: Geom, windows: list[int]) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode step over every layer at ``pos``."""
    parts = [decode_layer_work(pos, g, w) for w in windows]
    return sum(f for f, _ in parts), sum(b for _, b in parts)
