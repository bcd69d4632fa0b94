"""Entry point for ``python -m repro_torch.analysis`` (port of
``src/repro/analysis/__main__.py``)."""
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
