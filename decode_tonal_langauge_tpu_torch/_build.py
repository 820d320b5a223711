"""Build the port's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled for
``sm_90a`` into a shared library under ``build/kernels/`` beside the
package (a directory ``.gitignore`` lists), then loaded with ``ctypes``.
The library's file name carries a hash of the source, the headers of
``csrc/`` (``step_tiles.cuh``: the recurrent step tiles the LSTM and GRU
steps share) and the flags, so an edited source or header is rebuilt and
a stale library is never loaded. Nothing is
built at import: the CPU tests import every module where no ``nvcc``
exists.

It is also the one boundary between Python and the kernels: a kernel
module states its entry points' argument types as a table
(:func:`library`), passes :func:`stream` as the launch's stream, and
hands each launch's return code to :func:`launched`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, Iterable, Mapping, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("iir_df2t", "lstm_step", "gru_step", "nadam_step")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The argument types of the entry points' signature tables.
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# nvcc's output per source from the last build in this process (ptxas
# prints each kernel's registers, shared memory and spills).
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from source at first use"
        )
    return path


def _paths(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every source whose library is missing: one ``nvcc`` per
    source, all started together. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, out = _paths(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _, out = _paths(name)
            if not out.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(out))
            _LIBS[name] = lib
        return lib


def library(name: str, entry_points: Mapping[str, Sequence[type]]) -> Callable[[], ctypes.CDLL]:
    """A function returning the library of ``csrc/<name>.cu``, built and
    loaded at its first call, each entry point of ``entry_points`` typed
    with those argument types and an ``int`` result (every entry point of
    ``csrc/`` returns one: a ``cudaError_t``, a tile or a limit)."""

    @lru_cache(maxsize=1)
    def bound() -> ctypes.CDLL:
        lib = load(name)
        for entry, argtypes in entry_points.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = list(argtypes), I32
        return lib

    return bound


def stream(t: torch.Tensor) -> int:
    """The current raw CUDA stream of ``t``'s device: a launch's stream."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def launched(err: int, what: str, detail: str, *args) -> None:
    """Raise if a launch returned a CUDA error: ``what`` names the kernel
    and the launch, ``detail.format(*args)`` the call's sizes (formatted
    only on failure)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err} "
                           f"({detail.format(*args)})")
