"""Host milliseconds a traced flush step in the KV cache's page flushes: the
program's ``kv_cache.flush`` spans (the word views, kernel A's wrapper and
the slot writes of both sides, every layer) over the steps that flush."""
from bench import program_trace


def read(view):
    spans = program_trace.program_spans(view)
    flushes = [s for s in view.steps_of("decode") if s["flush"]]
    if spans is None or not flushes:
        return None
    return 1e3 * sum(b - a for name, a, b, _ in spans if name == "kv_cache.flush") / len(flushes)
