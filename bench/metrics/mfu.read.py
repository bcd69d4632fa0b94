"""The whole read operation's share of the chip's peak: the bytes a
whole-cache read of every layer must move over the HBM rate, against the
traced reads' measured time."""
from bench.counts import peaks, work


def read(view):
    reads = view.steps_of("read")
    total = sum(s["t1"] - s["t0"] for s in reads)
    if total <= 0:
        return None
    g, T = view.cell.geom(), view.cell.traffic["context"]
    return 100.0 * len(reads) * work.read_op_bytes(T, g) / peaks.HBM_BYTES_S / total
