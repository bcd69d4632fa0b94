"""Kernel B's share of its roofline over the traced reads: every page slot
the reads decode (serialised blobs in, words at 2 bytes out) over the HBM
rate, against B's measured device time."""
from bench.counts import peaks, work


def read(view):
    reads = view.steps_of("read")
    t = view.kernel_s("B")
    if not reads or t <= 0:
        return None
    g, T = view.cell.geom(), view.cell.traffic["context"]
    pages = len(reads) * g.n_layers * 2 * g.batch * (T // g.page_tokens) * g.pages_per_row
    return 100.0 * work.decode_bytes(pages, g) / peaks.HBM_BYTES_S / t
