"""Device-idle milliseconds a traced decode step while the host is inside
kernel C's or kernel A's wrapper (the program's ``paged_attn`` and ``encode``
spans, their blocking uploads included)."""
from bench import program_trace


def read(view):
    idle = program_trace.idle_by_span(view, key=program_trace.in_wrapper)
    steps = view.steps_of("decode")
    if idle is None or not steps:
        return None
    return 1e3 * idle.get("wrapper", 0.0) / len(steps)
