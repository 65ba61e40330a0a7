"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into a shared library that `ctypes`
loads. `KERNELS` names them all, read from ``csrc/``: a new ``.cu`` file
there is a new kernel, with no list to edit. Libraries are built at
first use, from the sources in the package only, into
``build/kernels/`` beside the package (a directory the repository's
.gitignore lists), keyed by a hash of the source and the flags, so a
changed source is rebuilt. `build_kernels` starts one ``nvcc`` per
source, all at once. Nothing is built when a module is imported: a
CPU-only host never needs ``nvcc``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
KERNELS = tuple(sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_kernels(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named source (by default every kernel) that has no
    current library, one ``nvcc`` process each, all started together.
    → {name: compiler log}
    (``-Xptxas=-v`` prints registers, shared memory and spills). Raises
    with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_kernels([name])
            lib = _LIBS[name] = ctypes.CDLL(library_path(name))
        return lib


def _counters():
    from gsrs_tpu_torch.ops import ell_kernel, gather, scoring, topk
    from gsrs_tpu_torch.train import fused_adam

    return (scoring.LAUNCHES, ell_kernel.LAUNCHES, fused_adam.LAUNCHES, topk.LAUNCHES,
            gather.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by kernel name (each wrapper
    adds one where it launches its kernel, and nowhere else; a CUDA
    graph's replay adds what its capture counted, `add_launches`)."""
    return {k: n for c in _counters() for k, n in c.items()}


def add_launches(made: Dict[str, int]) -> None:
    """Count ``made`` ({kernel: launches}, a `launches_since` of a CUDA
    graph's capture) once more: a replay launches what the capture did,
    and runs no wrapper."""
    for c in _counters():
        for k in c:
            c[k] += made.get(k, 0)


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches each kernel made since `launch_counts` returned
    ``before``."""
    return {k: n - before[k] for k, n in launch_counts().items()}
