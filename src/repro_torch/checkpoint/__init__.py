"""GBDI-compressed, atomic checkpoints (counterpart of :mod:`repro.checkpoint`)."""
