"""The share of its roofline of kernel C's ring instantiation
(``attn_kernel<., ., true>``, the window layers' launches alone, found by
name in the device trace): the least time of the window layers' launches
over the traced decode steps over that instantiation's device time.  The
split merge, whose kernel both instantiations share, is left out of the
time."""
from bench.counts import peaks, window


def read(view):
    steps = view.steps_of("decode")
    t = sum(d for n, _, d in view.kernels if window.RING_KERNEL.search(n))
    if not steps or t <= 0:
        return None
    g = view.cell.geom()
    ws = [w for w in window.layer_windows(view.cell.config) if w]
    bound = sum(window.step_attn_bound_s(s["pos"], g, ws, peaks.bound_s) for s in steps)
    return 100.0 * bound / t
