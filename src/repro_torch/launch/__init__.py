"""Entry points of the PyTorch port.

* :mod:`repro_torch.launch.serve` — the batched continuous-batching serving
  engine over a model (``python -m repro_torch.launch.serve``);
* :mod:`repro_torch.launch.train` — the fault-tolerant trainer with
  GBDI-compressed checkpoints (``python -m repro_torch.launch.train``).

Counterpart of :mod:`repro.launch`; its mesh, spec and lowering tools are
not ported yet.
"""
