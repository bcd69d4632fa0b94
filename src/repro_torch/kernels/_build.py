"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/lib<name>.so`` under the
checkout, then loaded with :mod:`ctypes`.  No PyTorch headers are involved,
so a build takes seconds.  A library is rebuilt when any source in ``csrc/``
is newer than it.  :func:`compile_kernels` starts one ``nvcc`` per source at
once and returns what ``-Xptxas -v`` reported (registers, shared memory,
spills) for each, and keeps that report beside the library, where
:func:`ptxas_logs` reads it back.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("gbdi_encode", "gbdi_decode", "gbdi_paged_attn")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def ptxas_log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.ptxas.txt"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def compile_kernels(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every named kernel in parallel; returns ptxas output by name.

    Raises with the compiler's output when any build fails.  Each library
    is written to a temporary name and moved into place, so concurrent
    builds never load a half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
            ptxas_log_path(name).write_text(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def ptxas_logs(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """What ``-Xptxas -v`` reported when each library was built, building
    those that are missing, stale or have no saved report."""
    todo = tuple(n for n in names if _stale(n) or not ptxas_log_path(n).exists())
    if todo:
        compile_kernels(todo)
    return {n: ptxas_log_path(n).read_text() for n in names}


@functools.lru_cache(maxsize=len(KERNELS))
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing or stale."""
    if _stale(name):
        compile_kernels((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ctypes.POINTER(ctypes.c_int)]
    smem.restype = ctypes.c_longlong
    return lib


def int_array(values: list[int]) -> "ctypes.Array[ctypes.c_int]":
    return (ctypes.c_int * len(values))(*values)


def ptr_array(values: list[int]) -> "ctypes.Array[ctypes.c_longlong]":
    return (ctypes.c_longlong * len(values))(*values)


__all__ = ["BUILD_DIR", "CSRC", "KERNELS", "compile_kernels", "int_array",
           "library_path", "load", "nvcc", "ptr_array", "ptxas_log_path", "ptxas_logs"]
