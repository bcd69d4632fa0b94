"""Kernel A's share of its roofline over the traced writes: every page the
writes encode (raw words at 2 bytes in, serialised blobs out) over the HBM
rate, against A's measured device time."""
from bench.counts import peaks, work


def read(view):
    writes = view.steps_of("write")
    t = view.kernel_s("A")
    if not writes or t <= 0:
        return None
    g, T = view.cell.geom(), view.cell.traffic["context"]
    pages = len(writes) * g.n_layers * 2 * g.batch * (T // g.page_tokens) * g.pages_per_row
    return 100.0 * work.encode_bytes(pages, g) / peaks.HBM_BYTES_S / t
