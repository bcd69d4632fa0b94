"""Host milliseconds a traced decode step inside the attention of layers
whose rows span several page slots: the program's ``kv_cache.multipage``
spans (kernel C's wrapper and launch, the raw-tail merge), every such layer,
over the traced steps; None where the program keeps no such span."""
from bench import program_trace


def read(view):
    spans = program_trace.program_spans(view)
    steps = view.steps_of("decode")
    if spans is None or not steps:
        return None
    multi = [b - a for name, a, b, _ in spans if name == "kv_cache.multipage"]
    if not multi:
        return None
    return 1e3 * sum(multi) / len(steps)
