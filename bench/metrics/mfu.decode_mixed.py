"""The whole decode step's share of the chip's peak in a model whose layers
mix sliding-window and full attention: the least time of its work (every
layer's attention over its window, or the whole context, over the bf16
peak, and every byte the step must move over the HBM rate,
``bench/counts/window.py``) over the traced steps' measured time."""
from bench.counts import peaks, window


def read(view):
    steps = view.steps_of("decode")
    total = sum(s["t1"] - s["t0"] for s in steps)
    if total <= 0:
        return None
    g, ws = view.cell.geom(), window.layer_windows(view.cell.config)
    bound = sum(peaks.bound_s(*window.decode_step_work(s["pos"], g, ws)) for s in steps)
    return 100.0 * bound / total
