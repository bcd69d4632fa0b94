"""Deterministic, index-based, shardable token pipeline.

Copy of :mod:`repro.data.pipeline` for the PyTorch port (numpy only), so
both packages draw the same token batches.

Fault-tolerance property: ``batch_at(step, host, n_hosts)`` is a pure
function of its arguments (counter-based Philox RNG), so

  * resume after a crash needs no pipeline state — the trainer just asks
    for step N again (bit-exact);
  * a straggler/restarted host seeks to any step in O(1);
  * elastic re-scaling re-parameterises (host, n_hosts) without replay.

The synthetic stream is drawn from a fixed random bigram table (a function
of ``seed`` only), so small LMs measurably learn it — loss decreases —
while everything stays reproducible offline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    bigram_sharpness: float = 0.8   # prob of following the table


def _bigram_table(cfg: PipelineConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed ^ 0xB16A)
    return rng.integers(0, cfg.vocab_size, cfg.vocab_size, dtype=np.int32)


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.table = _bigram_table(cfg)

    def batch_at(self, step: int, host: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        counter = np.uint64(step) * np.uint64(n_hosts) + np.uint64(host)
        rng = np.random.default_rng(np.random.Philox(key=cfg.seed, counter=[0, 0, 0, int(counter)]))
        B, S = cfg.batch_per_host, cfg.seq_len
        toks = np.empty((B, S), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
        follow = rng.random((B, S)) < cfg.bigram_sharpness
        noise = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        for t in range(1, S):
            toks[:, t] = np.where(follow[:, t], self.table[toks[:, t - 1]], noise[:, t])
        return {"tokens": toks}
