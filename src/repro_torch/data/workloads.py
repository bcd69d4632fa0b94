"""Synthetic memory-dump workload classes (paper §V "Data Selection").

Copy of :mod:`repro.data.workloads` for the PyTorch port (numpy only, so the
generated bytes are the reference's for the same ``seed``).  Each generator
reproduces the documented value structure of its benchmark family:

  * C/C++ heaps: pointers clustered in a few mmap regions, small ints,
    zero pages, struct padding;
  * JVM heaps additionally repeat object-header words (class pointers,
    mark words);
  * column-store segments: near-monotone keys, dictionary codes,
    fixed-point measures.

Nothing here touches a device.
"""
from __future__ import annotations

import zlib

import numpy as np


def _interleave(rng, parts):
    """Concatenate in 64-byte-block units and shuffle blocks, like pages of
    a real heap mixing allocation types."""
    blocks = []
    for arr in parts:
        a = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        pad = (-a.size) % 64
        if pad:
            a = np.concatenate([a, np.zeros(pad, np.uint8)])
        blocks.append(a.reshape(-1, 64))
    all_blocks = np.concatenate(blocks)
    rng.shuffle(all_blocks)
    return all_blocks.reshape(-1).view(np.uint32)


def spec_mcf(rng, n_bytes):
    """Pointer-chasing graph: node structs = {ptr, ptr, int, int}."""
    n = n_bytes // 16
    heap = np.uint64(0x7F3A_0000_0000)
    ptrs1 = (heap + rng.integers(0, 1 << 26, n).astype(np.uint64) * 16).view(np.uint64)
    ptrs2 = (heap + rng.integers(0, 1 << 26, n).astype(np.uint64) * 16).view(np.uint64)
    ints = rng.integers(0, 4000, (n, 2)).astype(np.int32)
    rec = np.empty((n, 4), np.uint32)
    rec[:, 0] = (ptrs1 & 0xFFFFFFFF).astype(np.uint32)
    rec[:, 1] = (ptrs1 >> 32).astype(np.uint32)
    rec[:, 2:] = ints.view(np.uint32).reshape(n, 2)
    del ptrs2
    return _interleave(rng, [rec, np.zeros(n // 4, np.uint32)])


def spec_perlbench(rng, n_bytes):
    """Strings + tagged SV pointers."""
    n = n_bytes // 4
    ascii_ = rng.integers(32, 127, n // 2).astype(np.uint8)
    text = np.frombuffer(ascii_.tobytes() * 4, dtype=np.uint32)[: n // 2]
    svs = (0x5601_0000 + rng.integers(0, 1 << 20, n // 3) * 8).astype(np.uint32)
    return _interleave(rng, [text, svs, np.zeros(n // 8, np.uint32)])


def spec_omnetpp(rng, n_bytes):
    """Discrete-event objects: doubles (times in a narrow range) + ptrs."""
    n = n_bytes // 8
    times = (1e6 + rng.random(n // 2) * 1e3).astype(np.float64)
    ptrs = (0x6100_0000 + rng.integers(0, 1 << 22, n // 2) * 8).astype(np.uint32)
    return _interleave(rng, [times.view(np.uint32), ptrs, np.zeros(n // 6, np.uint32)])


def spec_deepsjeng(rng, n_bytes):
    """Chess bitboards: sparse uint64, many zero words, small ints."""
    n = n_bytes // 8
    boards = rng.integers(0, 2, (n // 2, 64)).astype(np.uint8)
    bb = np.packbits(boards, axis=1).view(np.uint64)[:, 0]
    bb = np.where(rng.random(n // 2) < 0.5, 0, bb)
    scores = rng.integers(-2000, 2000, n // 2).astype(np.int32)
    return _interleave(rng, [bb.view(np.uint32), scores.view(np.uint32)])


def parsec_fluidanimate(rng, n_bytes):
    """Particle state: fp32 positions/velocities in a narrow dynamic range."""
    n = n_bytes // 4
    pos = (rng.random(n // 2) * 64).astype(np.float32)
    vel = rng.normal(0, 0.1, n // 2).astype(np.float32)
    return _interleave(rng, [pos.view(np.uint32), vel.view(np.uint32)])


def parsec_freqmine(rng, n_bytes):
    """FP-growth itemset counters: skewed small ints + node pointers."""
    n = n_bytes // 4
    counts = np.minimum(rng.zipf(1.6, n // 2), 1 << 20).astype(np.uint32)
    nodes = (0x9000_0000 + rng.integers(0, 1 << 18, n // 3) * 32).astype(np.uint32)
    return _interleave(rng, [counts, nodes, np.zeros(n // 6, np.uint32)])


def _jvm_headers(rng, n_objs):
    """Repeated class-pointer + mark words (the Java-CR story)."""
    klass = (0x0000_0008_0010_0000 + rng.integers(0, 64, n_objs) * 0x1000).astype(np.uint64)
    mark = np.full(n_objs, 0x0000_0000_0000_0001, np.uint64)
    hdr = np.empty((n_objs, 4), np.uint32)
    hdr[:, 0] = (mark & 0xFFFFFFFF).astype(np.uint32)
    hdr[:, 1] = (mark >> 32).astype(np.uint32)
    hdr[:, 2] = (klass & 0xFFFFFFFF).astype(np.uint32)
    hdr[:, 3] = (klass >> 32).astype(np.uint32)
    return hdr


def java_trianglecount(rng, n_bytes):
    n = n_bytes // 4
    adj = rng.integers(0, 1 << 20, n // 2).astype(np.uint32)   # vertex ids
    hdr = _jvm_headers(rng, n // 8)
    return _interleave(rng, [adj, hdr, np.zeros(n // 8, np.uint32)])


def java_svm(rng, n_bytes):
    n = n_bytes // 4
    feats = rng.normal(0, 1, n // 2).astype(np.float32)
    hdr = _jvm_headers(rng, n // 6)
    return _interleave(rng, [feats.view(np.uint32), hdr, np.zeros(n // 10, np.uint32)])


def java_matrixfactorization(rng, n_bytes):
    n = n_bytes // 4
    fac = (rng.random(n // 2).astype(np.float32) * 0.1)
    idx = rng.integers(0, 1 << 16, n // 4).astype(np.uint32)
    hdr = _jvm_headers(rng, n // 8)
    return _interleave(rng, [fac.view(np.uint32), idx, hdr])


# ---------------------------------------------------------------------------
# Column-store analytics families (Lin et al., "Data Compression for
# Analytics over Large-scale In-memory Column Databases").  In-memory column
# segments have value structure GBDI was never evaluated on in the paper:
# near-monotone surrogate keys, dictionary code ids, fixed-point measures.
# ---------------------------------------------------------------------------

def col_int_keys(rng, n_bytes):
    """Sorted 64-bit surrogate keys (skewed gaps) + epoch-second timestamps.

    Keys are globally monotone, so consecutive values share a handful of
    high-order "bases" — inter-block locality per-block BDI cannot see.
    """
    n = n_bytes // 8
    gaps = np.minimum(rng.zipf(1.7, n // 2), 1 << 12).astype(np.uint64)
    keys = (np.uint64(1) << np.uint64(40)) + np.cumsum(gaps)
    ts = (np.uint64(1_700_000_000) + np.cumsum(rng.poisson(3, n // 2))).astype(np.uint64)
    return _interleave(rng, [keys.view(np.uint32), ts.astype(np.uint32)])


def col_dict_codes(rng, n_bytes):
    """Dictionary-encoded string column: zipf-skewed code ids into a 4k
    dictionary, plus the monotone offsets array of the dictionary heap."""
    n = n_bytes // 4
    codes = (rng.zipf(1.3, n // 2) % 4096).astype(np.uint32)
    offsets = np.cumsum(rng.integers(4, 24, n // 3)).astype(np.uint32)
    return _interleave(rng, [codes, offsets, np.zeros(n // 8, np.uint32)])


def col_decimal_prices(rng, n_bytes):
    """Fixed-point decimal measure column (prices in cents, lognormal)
    + small-int quantities — the classic fact-table pair."""
    n = n_bytes // 4
    cents = np.minimum(rng.lognormal(7.5, 1.0, n // 2), 2**31 - 1).astype(np.uint32)
    qty = rng.integers(1, 100, n // 2).astype(np.uint32)
    return _interleave(rng, [cents, qty])


WORKLOADS = {
    "605.mcf_s": ("C", spec_mcf),
    "600.perlbench_s": ("C", spec_perlbench),
    "620.omnetpp_s": ("C", spec_omnetpp),
    "631.deepsjeng_s": ("C", spec_deepsjeng),
    "parsec_fluidanimate": ("C", parsec_fluidanimate),
    "parsec_freqmine": ("C", parsec_freqmine),
    "java_trianglecount": ("Java", java_trianglecount),
    "java_svm": ("Java", java_svm),
    "java_matrixfactorization": ("Java", java_matrixfactorization),
    "col_int_keys": ("Column", col_int_keys),
    "col_dict_codes": ("Column", col_dict_codes),
    "col_decimal_prices": ("Column", col_decimal_prices),
}


def _stable_seed(name: str, seed: int) -> int:
    # NOT hash(): Python string hashing is salted per process, which made
    # every run generate different "dumps" and CR numbers unreproducible.
    return (seed ^ zlib.crc32(name.encode())) % (1 << 31)


def generate(name: str, n_bytes: int = 4 << 20, seed: int = 0) -> np.ndarray:
    kind, fn = WORKLOADS[name]
    return fn(np.random.default_rng(_stable_seed(name, seed)), n_bytes)
