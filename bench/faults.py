"""Faults planted in the program's timed path, to show that ``correct``
catches them: each replaces one entry of ``repro_torch.serving.kv_cache``
for the length of a window.  The CPU tests plant every one in a tiny run
(``bench/tests/test_bench_faults.py``); ``bench/calibrate.py --fault-seeds``
reads the decode cells' attention faults on the card at the cell's own size.
The benchmark's own runs plant none.

A fault is named by what it breaks: a step that leaves its state unchanged;
half of the batch left out, the mean of the rest in its place; an answer
altered where it is produced; and in the decode cells the parts of kernel C
and the merge that only a query-dependent output can show: the query ignored
(uniform weights), the softmax scale 1 in place of 1/sqrt(hd), each head's
query taken from its neighbour, the raw tail left out of the merge.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.serving import kv_cache as kvc


def _half_mean(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[0] // 2
    x[h:] = x[:h].float().mean(0).to(x.dtype)
    return x


def _unchanged(real):
    return lambda spec, cache, *a: cache


def _attend_half(real):
    return lambda *a, **kw: _half_mean(real(*a, **kw))


def _attend_altered(real):
    def f(*a, **kw):
        out = real(*a, **kw)
        out[..., 0] += 0.5
        return out
    return f


def _with_query(change):
    """attention_decode with ``change(q)`` (B, 1, H, hd) in place of q."""
    def make(real):
        return lambda spec, q, cache, pos, **kw: real(spec, change(q), cache, pos, **kw)
    return make


def _scale_one(q: torch.Tensor) -> torch.Tensor:
    return (q.float() * math.sqrt(q.shape[-1])).to(q.dtype)


def _tail_dropped(real):
    """merge_softmax keeping the pages' part alone."""
    return lambda acc, m, l, *tail: (acc, m, l)


def _extend_half(real):
    def f(spec, cache, ks, vs, start):
        h = ks.shape[0] // 2
        keep = {side: {k: t[h:].clone() for k, t in cache[f"{side}_pages"].items()}
                for side in "kv"}
        real(spec, cache, ks, vs, start)
        for side in "kv":
            for k, t in keep[side].items():
                cache[f"{side}_pages"][k][h:] = t
        return cache
    return f


def _read_half(real):
    def f(*a, **kw):
        K, V, valid = real(*a, **kw)
        return _half_mean(K), _half_mean(V), valid
    return f


def _read_altered(real):
    def f(spec, cache, pos):
        K, V, valid = real(spec, cache, pos)
        K.view(K.shape[0], -1)[:, 0] += 1
        return K, V, valid
    return f


#: name -> (the kv_cache entry it replaces, the replacement made from the real one)
FAULTS = {
    "append_unchanged": ("append", _unchanged),
    "attend_half_batch": ("attention_decode", _attend_half),
    "attend_altered": ("attention_decode", _attend_altered),
    "query_ignored": ("attention_decode", _with_query(torch.zeros_like)),
    "scale_one": ("attention_decode", _with_query(_scale_one)),
    "query_wrong_head": ("attention_decode", _with_query(lambda q: q.roll(1, dims=2))),
    "tail_dropped": ("merge_softmax", _tail_dropped),
    "extend_unchanged": ("extend", _unchanged),
    "extend_half_batch": ("extend", _extend_half),
    "read_half_batch": ("read_full", _read_half),
    "read_altered": ("read_full", _read_altered),
}
#: the faults each driver's cells can have
BY_DRIVER = {
    "kv_decode": ("append_unchanged", "attend_half_batch", "attend_altered", "query_ignored",
                  "scale_one", "query_wrong_head", "tail_dropped"),
    "kv_write_read": ("extend_unchanged", "extend_half_batch", "read_half_batch",
                      "read_altered"),
}
#: the decode faults that only a query-dependent output shows
ATTENTION = ("query_ignored", "scale_one", "query_wrong_head", "tail_dropped")


@contextlib.contextmanager
def planted(name: str | None):
    """``kv_cache`` with fault ``name`` in place (none for None)."""
    if name is None:
        yield
        return
    attr, make = FAULTS[name]
    real = getattr(kvc, attr)
    setattr(kvc, attr, make(real))
    try:
        yield
    finally:
        setattr(kvc, attr, real)
