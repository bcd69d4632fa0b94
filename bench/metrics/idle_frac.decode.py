"""The share of the traced decode steps in which no kernel, copy or set ran
on the device."""


def read(view):
    steps = view.steps_of("decode")
    total = sum(s["t1"] - s["t0"] for s in steps)
    if total <= 0:
        return None
    return 1.0 - view.busy_in([(s["t0"], s["t1"]) for s in steps]) / total
