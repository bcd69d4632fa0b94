"""Shared test plumbing: src-layout path, hypothesis fallback, slow marker."""
import os
import pathlib
import sys

import pytest

# src layout: make `import repro` work for plain `pytest` (no PYTHONPATH,
# no editable install) — e.g. fresh containers and IDE runners.
_SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    try:
        import repro  # noqa: F401
    except ModuleNotFoundError:
        sys.path.insert(0, _SRC)

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # Hermetic containers can't `pip install -e .[test]`; run the
    # property suites on the deterministic fallback instead of dying at
    # collection with ModuleNotFoundError.
    from repro._compat import hypothesis_fallback

    hypothesis_fallback.install()


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked @pytest.mark.slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running case (interpret-mode Pallas sweeps, "
        "full-size property suites); skipped unless --runslow or RUN_SLOW=1")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the CUDA kernels); skips inside "
        "the test where torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW") == "1":
        return
    skip_slow = pytest.mark.skip(reason="slow; pass --runslow or RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
