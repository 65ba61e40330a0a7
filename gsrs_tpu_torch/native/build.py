"""Build and load the native sampler (g++ → shared library → ctypes).

``sampling.cpp`` exposes a plain C interface; numpy arrays pass as
pointers. The library is built at first use, from the source in the
package only, into ``build/native/`` beside the package (a directory the
repository's .gitignore lists), keyed by a hash of the source and the
flags, as `gsrs_tpu_torch.kernels` builds the CUDA kernels. Nothing is
built when the module is imported. Without a host compiler
`load_native_sampler` returns None and callers take the Python sampler,
the JAX package's dispatch."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "sampling.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional["NativeSampler"] = None
_FAILED = False

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


class NativeSampler:
    """The C interface of ``sampling.cpp``: a global mt19937_64 seeded by
    `seed`, and the reference's two sampling entry points."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.gsrs_seed.argtypes = [ctypes.c_uint64]
        lib.gsrs_seed.restype = None
        lib.gsrs_sample_negative.restype = ctypes.c_int64
        lib.gsrs_sample_negative.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                             _I32P, _I32P, ctypes.c_int64, _I64P]
        lib.gsrs_sample_negative_by_user.restype = ctypes.c_int64
        lib.gsrs_sample_negative_by_user.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64,
                                                     _I32P, _I32P, ctypes.c_int64, _I64P]

    def seed(self, seed: int) -> None:
        self._lib.gsrs_seed(ctypes.c_uint64(seed))

    def sample_negative(self, user_num: int, item_num: int, train_num: int,
                        indptr: np.ndarray, indices: np.ndarray, neg_num: int = 1) -> np.ndarray:
        """(rows, 2 + neg_num) int64 rows [user, pos, neg…], round-robin
        over the users, train_num // user_num rows each (users with no
        positive, or no possible negative, are skipped)."""
        indptr = np.ascontiguousarray(indptr, dtype=np.int32)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        max_rows = (train_num // max(user_num, 1)) * user_num
        out = np.empty((max(max_rows, 1), 2 + neg_num), dtype=np.int64)
        rows = self._lib.gsrs_sample_negative(
            user_num, item_num, train_num, indptr.ctypes.data_as(_I32P),
            indices.ctypes.data_as(_I32P), neg_num, out.ctypes.data_as(_I64P))
        return out[:rows]

    def sample_negative_by_user(self, users: np.ndarray, item_num: int, indptr: np.ndarray,
                                indices: np.ndarray, neg_num: int = 1) -> np.ndarray:
        """One row [user, pos, neg…] per listed user that has a positive
        and a possible negative."""
        users = np.ascontiguousarray(users, dtype=np.int64)
        indptr = np.ascontiguousarray(indptr, dtype=np.int32)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        if users.size and (users.min() < 0 or users.max() >= indptr.size - 1):
            raise ValueError(f"user ids out of range [0, {indptr.size - 1})")
        out = np.empty((max(len(users), 1), 2 + neg_num), dtype=np.int64)
        rows = self._lib.gsrs_sample_negative_by_user(
            users.ctypes.data_as(_I64P), len(users), item_num, indptr.ctypes.data_as(_I32P),
            indices.ctypes.data_as(_I32P), neg_num, out.ctypes.data_as(_I64P))
        return out[:rows]


def library_path() -> str:
    """Where the library built from ``sampling.cpp`` lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsampling_{digest}.so")


def build() -> str:
    """Compile ``sampling.cpp`` unless its library is current → its path.
    Raises `subprocess.CalledProcessError` (with g++'s output) or
    `FileNotFoundError` (no g++)."""
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    return out


def load_native_sampler() -> Optional[NativeSampler]:
    """The native sampler, built once; None when the host has no working
    g++ (callers then take the Python sampler)."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is None and not _FAILED:
            try:
                _LIB = NativeSampler(ctypes.CDLL(build()))
            except (OSError, subprocess.CalledProcessError):
                _FAILED = True
        return _LIB
