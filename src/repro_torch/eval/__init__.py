"""The port's measurement harness for the GBDI-FR main path.

* :mod:`repro_torch.eval.registry` — workload/codec registries and cells;
* :mod:`repro_torch.eval.workloads` — the main-path workload families;
* :mod:`repro_torch.eval.codecs` — the ``FRCodec`` adapter;
* :mod:`repro_torch.eval.run` — ``evaluate_cell``, ``measure_throughput`` and
  the CLI (``python -m repro_torch.eval.run``).
"""
from repro_torch.eval.registry import (  # noqa: F401
    CodecRegistry,
    EvalCell,
    Workload,
    WorkloadRegistry,
)

# repro_torch.eval.run is the CLI module; not imported here so runpy does
# not see it pre-imported.
