"""The port's measurement harness: the paper's suite, the FR sweep, throughput.

* :mod:`repro_torch.eval.registry` — workload/codec registries and cells;
* :mod:`repro_torch.eval.workloads` — the dump families and ``ml_kvcache_bf16``;
* :mod:`repro_torch.eval.codecs` — the ``gbdi``, ``bdi`` and ``fr`` adapters;
* :mod:`repro_torch.eval.run` — ``evaluate``, ``sweep``, ``throughput``, the
  reporting helpers and the CLI (``python -m repro_torch.eval.run``).
"""
from repro_torch.eval.registry import (  # noqa: F401
    CodecRegistry,
    EvalCell,
    Workload,
    WorkloadRegistry,
)

# repro_torch.eval.run is the CLI module; not imported here so runpy does
# not see it pre-imported.
