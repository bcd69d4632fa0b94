"""GBDI-FR format core on tensors: code space, base fitting, plain codec."""
from repro_torch.core.format import BaseTable, as_base_table  # noqa: F401
from repro_torch.core.gbdi_fr import FRConfig, fit_fr_bases, fr_decode, fr_encode  # noqa: F401
from repro_torch.core.kmeans import fit_bases, fit_bases_host  # noqa: F401

__all__ = [
    "BaseTable",
    "FRConfig",
    "as_base_table",
    "fit_bases",
    "fit_bases_host",
    "fit_fr_bases",
    "fr_decode",
    "fr_encode",
]
