"""Blocking host-to-device copies a traced decode step: the program's
``upload`` spans (``repro_torch._device.upload``) in the traced stretch over
its decode steps; 0 where the program made none."""
from bench import program_trace


def read(view):
    spans = program_trace.program_spans(view)
    steps = view.steps_of("decode")
    if spans is None or not steps:
        return None
    return sum(1 for s in spans if s[0] == "upload") / len(steps)
