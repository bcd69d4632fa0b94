"""The whole decode step's share of the chip's peak: the least time its work
could take (the larger of every layer's attention FLOPs over the bf16 peak
and every byte the step must move over the HBM rate) over the traced steps'
measured time."""
from bench.counts import peaks, work


def read(view):
    steps = view.steps_of("decode")
    total = sum(s["t1"] - s["t0"] for s in steps)
    if total <= 0:
        return None
    g = view.cell.geom()
    return 100.0 * sum(peaks.bound_s(*work.decode_step_work(s["pos"], g)) for s in steps) / total
