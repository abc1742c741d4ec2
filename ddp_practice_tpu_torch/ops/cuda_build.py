"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for sm_90a into a shared library loaded with ctypes (no PyTorch
headers, so a build takes seconds, not minutes). Libraries go into
`build/ddp_practice_tpu_torch/` at the repository root, named by a hash
of the source and the flags, so an edited source rebuilds on first use
and an unchanged one loads at once. `build()` starts one nvcc per source
together and waits for all of them.

Nothing here runs at import time: the CPU test suite imports every
module on a machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ddp_practice_tpu_torch"
# every source under csrc/ (`build(SOURCES)` compiles them together)
SOURCES = ("decode_attention", "flash_attention", "fused_encoder")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}      # name -> ctypes.CDLL
ptxas_info: dict = {}   # name -> what ptxas reported (registers, smem)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names) -> dict:
    """Compile every named source that has no up-to-date library, all
    nvcc processes at once. Returns {name: library path}; raises with
    nvcc's stderr if any compile fails."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{err}{out}")
            continue
        ptxas_info[n] = err
        os.replace(tmp, todo[n])   # atomic publish
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"kernel {name!r} needs a CUDA device and none is present"
        )
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
