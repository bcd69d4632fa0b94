"""Kernel C's share of its roofline over the traced decode steps: the least
time its launches could take (the larger of the pages' compressed bytes plus
q and the output over the HBM rate, and the attention FLOPs over the bf16
peak, a launch) over its measured device time."""
from bench.counts import peaks, work


def read(view):
    steps = view.steps_of("decode")
    t = view.kernel_s("C")
    if not steps or t <= 0:
        return None
    g = view.cell.geom()
    bound = g.n_layers * sum(peaks.bound_s(*work.attn_work(s["pos"], g)) for s in steps)
    return 100.0 * bound / t
