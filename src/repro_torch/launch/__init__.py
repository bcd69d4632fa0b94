"""Entry points of the PyTorch port.

* :mod:`repro_torch.launch.serve` — the batched continuous-batching serving
  engine over a model (``python -m repro_torch.launch.serve``).

Counterpart of :mod:`repro.launch`; its training, mesh and lowering tools
are not ported yet.
"""
