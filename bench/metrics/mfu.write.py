"""The whole write operation's share of the chip's peak: the bytes a prefill
write of every layer must move over the HBM rate, against the traced writes'
measured time."""
from bench.counts import peaks, work


def read(view):
    writes = view.steps_of("write")
    total = sum(s["t1"] - s["t0"] for s in writes)
    if total <= 0:
        return None
    g, T = view.cell.geom(), view.cell.traffic["context"]
    return 100.0 * len(writes) * work.write_op_bytes(T, g) / peaks.HBM_BYTES_S / total
