"""The program's own spans (``repro_torch.obs``) in a traced stretch, on the
view's time axis, and the device's idle time split by them.

The recorder stamps its spans with absolute ``time.perf_counter()`` seconds;
the view's axis is zero at the host time of its first marker, which the view
does not carry.  The offset is recovered by pairing the program's last N
``kv_cache.append`` and ``kv_cache.attention_decode`` spans, in order, with
the view's N benchmark spans ``append`` and ``attention_decode``: each
program span opens just inside its benchmark span, so the least difference
of their starts is the offset, to within one call's overhead.  A process can
hold earlier stretches' spans (the card tests run several cells in one
process), so only the last N pair, and the stretch's spans are those from
the first of them to the end of the last.  (The view's ``window_s`` is the
device's clock, which may end a few ms before the host's last span.)

Both functions return None where the program keeps no spans (a program
without ``repro_torch.obs``), or where the spans do not pair with the view's.
"""
from __future__ import annotations

from bench.trace import View, _overlaps, _union

#: each benchmark span, and the program's span that opens inside it
PAIRS = {"append": "kv_cache.append", "attention_decode": "kv_cache.attention_decode"}
#: the host spans of kernel C's and kernel A's wrappers
WRAPPERS = ("paged_attn", "encode")

#: a span: (name, start, end, index of its parent or -1)
Span = tuple[str, float, float, int]

_last: list[tuple[View, list[Span] | None]] = []      # the last view read, and its spans


def _snapshot() -> dict | None:
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def program_spans(view: View, snap: dict | None = None) -> list[Span] | None:
    """The recorder's spans of this traced stretch, shifted onto the view's
    axis, parents as indices into the list (``snap``: a recorder snapshot,
    by default the recorder's own)."""
    if snap is None:
        if _last and _last[0][0] is view:
            return _last[0][1]
        got = _snapshot()
        out = None if got is None else _align(view, got["spans"])
        _last[:] = [(view, out)]
        return out
    return _align(view, snap["spans"])


def _align(view: View, rows: list[Span]) -> list[Span] | None:
    bench = [(n, a, b) for n, a, b in view.spans if n in PAIRS]
    tops = [i for i, r in enumerate(rows) if r[0] in PAIRS.values()]
    if not bench or len(tops) < len(bench):
        return None
    tops = tops[-len(bench):]
    if any(PAIRS[b[0]] != rows[i][0] for b, i in zip(bench, tops)):
        return None
    offset = min(rows[i][1] - b[1] for b, i in zip(bench, tops))
    # each program span closes inside its own benchmark span
    if not all(rows[i][2] - offset <= b[2] for b, i in zip(bench, tops)):
        return None
    first, end = tops[0], rows[tops[-1]][2]
    out: list[Span] = []
    for name, a, b, parent in rows[first:]:
        if a > end:                         # past the stretch's last call
            break
        if not b >= a:                      # still open when the snapshot was taken
            return None
        out.append((name, a - offset, b - offset, parent - first if parent >= first else -1))
    return out


def self_s(spans: list[Span], name: str) -> float:
    """Seconds inside spans named ``name`` and outside their children."""
    total = 0.0
    for name_, a, b, _ in spans:
        if name_ == name:
            total += b - a
    for _, a, b, parent in spans:
        if parent >= 0 and spans[parent][0] == name:
            total -= b - a
    return total


def in_wrapper(spans: list[Span], i: int) -> str:
    """``wrapper`` for a span inside kernel A's or C's wrapper (an upload
    there included), else the span's own name."""
    j = i
    while j >= 0:
        if spans[j][0] in WRAPPERS:
            return "wrapper"
        j = spans[j][3]
    return spans[i][0]


def idle_by_span(view: View, key=None) -> dict[str, float] | None:
    """Device-idle seconds inside the traced decode steps, by the innermost
    program span the host was in (``key(spans, index)`` names the bucket
    instead), and ``outside`` for idle time in no program span."""
    spans = program_spans(view)
    if spans is None:
        return None
    gaps, prev = [], 0.0
    for a, b in _union((s, s + d) for _, s, d in view.kernels) + [(view.window_s,) * 2]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    steps = _union((s["t0"], s["t1"]) for s in view.steps_of("decode"))
    idle = [(lo, hi) for lo, hi, _ in _overlaps(gaps, steps)]
    children: dict[int, list[int]] = {}
    for i, (_, _, _, parent) in enumerate(spans):
        if parent >= 0:
            children.setdefault(parent, []).append(i)
    own: list[tuple[float, float, int]] = []        # each span's time outside its children
    for i, (_, a, b, _) in enumerate(spans):
        prev = a
        for c in children.get(i, []):
            if spans[c][1] > prev:
                own.append((prev, spans[c][1], i))
            prev = max(prev, spans[c][2])
        if b > prev:
            own.append((prev, b, i))
    own.sort()
    out = {"outside": sum(b - a for a, b in idle)}
    for lo, hi, j in _overlaps(idle, own):
        i = own[j][2]
        name = spans[i][0] if key is None else key(spans, i)
        out[name] = out.get(name, 0.0) + hi - lo
        out["outside"] -= hi - lo
    return out
