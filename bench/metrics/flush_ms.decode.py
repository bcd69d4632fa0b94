"""Device milliseconds of kernel A's launches a flush step: the encodes that
write a completed page's blobs in every layer."""


def read(view):
    flushes = [s for s in view.steps_of("decode") if s["flush"]]
    t = view.kernel_s("A")
    if not flushes or t <= 0:
        return None
    return 1e3 * t / len(flushes)
