"""Host milliseconds a traced decode step inside kernel C's wrapper: the
self time of the program's ``paged_attn`` spans (its checks, launch plan,
table pad and launch), its blocking uploads left out."""
from bench import program_trace


def read(view):
    spans = program_trace.program_spans(view)
    steps = view.steps_of("decode")
    if spans is None or not steps:
        return None
    return 1e3 * program_trace.self_s(spans, "paged_attn") / len(steps)
