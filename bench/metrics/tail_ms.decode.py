"""Host milliseconds a traced decode step in the raw-tail attention and
softmax merge after kernel C: the self time of the program's
``kv_cache.tail_merge`` spans, its blocking upload left out."""
from bench import program_trace


def read(view):
    spans = program_trace.program_spans(view)
    steps = view.steps_of("decode")
    if spans is None or not steps:
        return None
    return 1e3 * program_trace.self_s(spans, "kv_cache.tail_merge") / len(steps)
