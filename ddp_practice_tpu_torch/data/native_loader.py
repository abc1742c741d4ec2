"""ctypes binding for the native (C++) batch gather (counterpart of
ddp_practice_tpu/data/native_loader.py, over the port's own copy of the
source, `csrc/dataloader.cpp`, with the same ABI v3 C interface).

The library is built with the host compiler (`g++`, or `$CXX`) on first
use into `build/ddp_practice_tpu_torch/`, named by a hash of the source,
the compiler, the flags and the machine's architecture, so an edited
source rebuilds and an unchanged one loads at once; it never writes
beside the source. It is a host library: the CUDA
kernels' build (ops/cuda_build.py) does not list it.

`make_gather(dataset)` returns the native gather, or None when the
library cannot be built or loaded; `require()` raises instead, with the
compiler's message (data/loader.py: backend "native" raises, "auto" falls
back to the numpy gather, which gives the same bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ddp_practice_tpu_torch.data.datasets import Dataset

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "ddp_practice_tpu_torch"
# no -march=native: the build directory may travel to another machine
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")
ABI_VERSION = 3   # dl_version() in csrc/dataloader.cpp

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None    # why the library is unavailable


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """The library's path, keyed by the source, the compiler, the flags
    and the machine's architecture."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (_compiler(), platform.machine()) + CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdataloader-{digest[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source into `path` (atomic publish); raises with the
    compiler's output on failure."""
    cxx = shutil.which(_compiler())
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler {_compiler()!r} on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{_compiler()} failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, path)


def _load() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    lib.dl_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int32]
    lib.dl_gather.restype = ctypes.c_int32
    lib.dl_version.restype = ctypes.c_int32
    if lib.dl_version() != ABI_VERSION:
        raise RuntimeError(f"{path.name}: ABI {lib.dl_version()}, want "
                           f"{ABI_VERSION}")
    return lib


def require() -> ctypes.CDLL:
    """The loaded library, built on first use; raises (with the reason,
    remembered for the process) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = str(e)
        if _lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        return _lib


def available() -> bool:
    try:
        require()
    except RuntimeError:
        return False
    return True


class NativeGather:
    """Callable gather backed by the C++ library.

    Wraps the dataset's own storage zero-copy in its own dtype: fp32
    arrays stay fp32, uint8 stays uint8, and a memmapped corpus is wrapped
    at its mapped address, so the C++ memcpy streams pages from disk
    through the OS page cache. References are held for the handle's
    lifetime. Negative indices wrap as numpy's do; an index out of range
    raises IndexError, as numpy's fancy indexing does."""

    def __init__(self, lib: ctypes.CDLL, dataset: Dataset):
        self._lib = lib
        self._images = np.ascontiguousarray(dataset.images)
        self._labels = np.ascontiguousarray(dataset.labels, dtype=np.int32)
        self._sample_shape = self._images.shape[1:]
        self._handle = lib.dl_create(
            self._images.ctypes.data_as(ctypes.c_void_p),
            self._labels.ctypes.data_as(ctypes.c_void_p),
            len(self._images), int(np.prod(self._sample_shape)),
            self._images.dtype.itemsize)

    def __call__(self, indices: np.ndarray):
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out_images = np.empty((len(idx),) + self._sample_shape,
                              self._images.dtype)
        out_labels = np.empty((len(idx),), np.int32)
        status = self._lib.dl_gather(
            self._handle, idx.ctypes.data_as(ctypes.c_void_p), len(idx),
            out_images.ctypes.data_as(ctypes.c_void_p),
            out_labels.ctypes.data_as(ctypes.c_void_p), 0)
        if status != 0:
            raise IndexError(f"native gather: index out of range for a "
                             f"dataset of {len(self._images)} samples")
        return out_images, out_labels

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.dl_destroy(handle)


def make_gather(dataset: Dataset) -> Optional[Callable]:
    """The native gather over `dataset`, or None when the library is
    unavailable (the caller falls back to numpy)."""
    try:
        return NativeGather(require(), dataset)
    except RuntimeError:
        return None
