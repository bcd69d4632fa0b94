"""Registries binding workloads to codecs under one measurement protocol.

Copy of :mod:`repro.eval.registry` for the PyTorch port (numpy only); cells
additionally name the device they ran on and its power limit.

A *workload* is a named generator of a word stream with a documented value
structure.  ``kind`` groups families the way the paper's figures do — C,
Java and Column synthetic dumps, ML for live model tensors — plus ``Dump``
for real memory images registered dynamically by
the reference's ingestion path (``dump:<name>`` families from ELF cores, tensor
files, or live captures).  A *codec* is anything exposing the four-method
``fit/encode/decode/size_bits`` protocol (:mod:`repro_torch.eval.codecs`).

Both registries are plain dicts with validation — the point is that
``repro_torch.eval.run`` and every benchmark iterate the *same* tables, so a new
family or codec added here shows up everywhere (CLI, bench_compression,
bench_throughput, tests) with roundtrip verification for free.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named word-stream generator.

    ``generate(n_bytes, seed)`` must be deterministic across processes for
    a fixed seed (regression-tested) and return a numpy array whose raw
    bytes are the workload; ``word_bits`` is the natural word size of the
    stream (16 for bf16 tensor families, else 32).
    """

    name: str
    kind: str                     # "C" | "Java" | "Column" | "ML" | "Dump"
    generate: Callable[[int, int], np.ndarray]  # (n_bytes, seed) -> array
    word_bits: int = 32
    description: str = ""


class WorkloadRegistry:
    def __init__(self, workloads: Iterable[Workload] = ()):
        self._workloads: dict[str, Workload] = {}
        for w in workloads:
            self.register(w)

    def register(self, workload: Workload) -> Workload:
        if workload.name in self._workloads:
            raise ValueError(f"workload {workload.name!r} already registered")
        if workload.word_bits not in (16, 32):
            raise ValueError(f"{workload.name}: word_bits must be 16 or 32")
        self._workloads[workload.name] = workload
        return workload

    def get(self, name: str) -> Workload:
        if name not in self._workloads:
            raise KeyError(
                f"unknown workload {name!r}; known: {sorted(self._workloads)}"
            )
        return self._workloads[name]

    def names(self) -> list[str]:
        return list(self._workloads)

    def kinds(self) -> list[str]:
        return sorted({w.kind for w in self._workloads.values()})

    def select(self, suite: str) -> list[Workload]:
        """``all`` or a comma list of kinds and/or workload names.

        Kinds match case-insensitively (``dump`` selects every registered
        ``dump:<name>`` family); anything that is not a kind must be an
        exact workload name.
        """
        if suite == "all":
            return list(self._workloads.values())
        out: list[Workload] = []
        for tok in suite.split(","):
            tok = tok.strip()
            if not tok:
                continue
            by_kind = [w for w in self._workloads.values() if w.kind.lower() == tok.lower()]
            if by_kind:
                out.extend(w for w in by_kind if w not in out)
            else:
                w = self.get(tok)
                if w not in out:
                    out.append(w)
        if not out:
            raise KeyError(f"suite {suite!r} matched nothing")
        return out

    def __iter__(self):
        return iter(self._workloads.values())

    def __len__(self) -> int:
        return len(self._workloads)


class CodecRegistry:
    """Name -> codec-adapter factory.  Factories take ``word_bits`` so one
    registered codec serves both 16- and 32-bit word streams."""

    def __init__(self):
        self._factories: dict[str, Callable[[int], object]] = {}

    def register(self, name: str, factory: Callable[[int], object]):
        if name in self._factories:
            raise ValueError(f"codec {name!r} already registered")
        self._factories[name] = factory

    def make(self, name: str, word_bits: int):
        if name not in self._factories:
            raise KeyError(f"unknown codec {name!r}; known: {sorted(self._factories)}")
        return self._factories[name](word_bits)

    def names(self) -> list[str]:
        return list(self._factories)


@dataclasses.dataclass
class EvalCell:
    """One (workload, codec) measurement."""

    workload: str
    kind: str
    codec: str
    n_bytes: int
    word_bits: int
    compression_ratio: float
    bits_per_word: float
    fit_s: float
    encode_s: float
    decode_s: float
    encode_mb_s: float
    lossless: bool
    exact_frac: float
    verified: bool
    error: str = ""
    mismatched_words: int = 0
    dropped_words: int = 0
    device: str = ""          # torch.cuda.get_device_name() or "cpu"
    power_limit: str = ""     # nvidia-smi power.limit of that card

    def to_json(self) -> dict:
        return dataclasses.asdict(self)
