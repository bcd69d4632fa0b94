"""GBDI-FR page kernels (encode, decode, decode attention over compressed
pages): hand-written CUDA for Hopper plus their plain versions.

Kernel sources live in ``csrc/`` and are built on first use (see
:mod:`repro_torch.kernels._build`); nothing is compiled at import.
"""
