"""Host milliseconds a traced decode step inside the window layers'
attention: the program's ``kv_cache.window`` spans (the ring's bounds,
kernel C's wrapper and launch, the raw-tail merge), every window layer, over
the traced steps; None where the program keeps no such span."""
from bench import program_trace


def read(view):
    spans = program_trace.program_spans(view)
    steps = view.steps_of("decode")
    if spans is None or not steps:
        return None
    windows = [b - a for name, a, b, _ in spans if name == "kv_cache.window"]
    if not windows:
        return None
    return 1e3 * sum(windows) / len(steps)
