"""Kernel C's share of its roofline over the traced decode steps of a model
whose layers mix sliding-window and full attention: the least time of every
launch (window layers counted by the pages their window reaches,
``bench/counts/window.py``) over the device time of all of C's kernels,
both instantiations and the split merge."""
from bench.counts import peaks, window


def read(view):
    steps = view.steps_of("decode")
    t = view.kernel_s("C")
    if not steps or t <= 0:
        return None
    g, ws = view.cell.geom(), window.layer_windows(view.cell.config)
    bound = sum(window.step_attn_bound_s(s["pos"], g, ws, peaks.bound_s) for s in steps)
    return 100.0 * bound / t
