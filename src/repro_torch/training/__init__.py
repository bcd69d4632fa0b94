"""The train step and the fault-tolerant trainer (counterpart of :mod:`repro.training`)."""
