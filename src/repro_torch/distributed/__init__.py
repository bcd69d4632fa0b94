"""Cross-pod gradient exchange over ``torch.distributed`` (counterpart of
:mod:`repro.distributed`; its ``sharding`` rule table is not ported yet)."""
