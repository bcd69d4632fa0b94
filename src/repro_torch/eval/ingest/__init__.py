"""Real-dump workload ingestion: memory images -> registry families.

Copy of :mod:`repro.eval.ingest` for the PyTorch port (numpy and the standard
library; ``capture_pytree`` also takes torch tensors).  The container format,
``DUMP_PREFIX``, ``DUMP_KIND``, ``$REPRO_DUMP_DIR`` and ``experiments/dumps``
are the reference's, so either package loads a container the other wrote.

The synthetic families in :mod:`repro_torch.eval.workloads` reproduce documented
*value structure*; this package feeds the eval subsystem the real thing.
Any supported input — an ELF core dump, a ``.npy``/``.npz``/raw-binary
tensor file, a pickled parameter tree, or a live capture — normalises into
one on-disk container (:class:`DumpImage`, a ``.npz``) and registers as a
dynamic ``dump:<name>`` family usable by every ``repro_torch.eval.run`` mode
(default eval, ``--sweep``, ``--throughput``) and benchmark.

CLI::

  PYTHONPATH=src python -m repro_torch.eval.ingest core.1234 --dump-dir experiments/dumps
  PYTHONPATH=src python -m repro_torch.eval.ingest weights.npy params.pkl
  PYTHONPATH=src python -m repro_torch.eval.ingest --list
  PYTHONPATH=src python -m repro_torch.eval.run --suite dump   # evaluate what you ingested

``docs/INGEST.md`` describes the pipeline and its safety notes.
"""
from repro_torch.eval.ingest.capture import capture_process, capture_pytree
from repro_torch.eval.ingest.chunker import (
    DEFAULT_DUMP_DIR,
    DUMP_KIND,
    DUMP_PREFIX,
    default_dump_dir,
    dump_workload,
    sample_stream,
    scan_dump_dir,
)
from repro_torch.eval.ingest.container import DumpImage, Segment, load_meta
from repro_torch.eval.ingest.elf import is_elf, read_elf_core
from repro_torch.eval.ingest.tensors import (
    read_npy,
    read_npz,
    read_pytree_pickle,
    read_raw,
    read_tensor_file,
)

__all__ = [
    "DEFAULT_DUMP_DIR",
    "DUMP_KIND",
    "DUMP_PREFIX",
    "DumpImage",
    "Segment",
    "capture_process",
    "capture_pytree",
    "default_dump_dir",
    "dump_workload",
    "is_elf",
    "load_meta",
    "read_elf_core",
    "read_npy",
    "read_npz",
    "read_pytree_pickle",
    "read_raw",
    "read_tensor_file",
    "sample_stream",
    "scan_dump_dir",
]
