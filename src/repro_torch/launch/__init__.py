"""Entry points and launch tools of the PyTorch port.

* :mod:`repro_torch.launch.serve` - the batched continuous-batching serving
  engine over a model (``python -m repro_torch.launch.serve``);
* :mod:`repro_torch.launch.train` - the fault-tolerant trainer with
  GBDI-compressed checkpoints (``python -m repro_torch.launch.train``);
* :mod:`repro_torch.launch.mesh` - the production mesh axes and the H100
  roofline constants;
* :mod:`repro_torch.launch.specs` - fake-tensor stand-ins for every model
  input (the reference's ``jax.eval_shape`` trees);
* :mod:`repro_torch.launch.op_stats` - FLOPs, HBM bytes and collective wire
  bytes of an eager program, op by op: the counterpart of
  :mod:`repro.launch.hlo_stats`, which walks compiled HLO;
* :mod:`repro_torch.launch.dryrun` - the per-cell count and roofline record
  of every (arch x shape x mesh) (``python -m repro_torch.launch.dryrun``).

Counterpart of :mod:`repro.launch`.
"""
