# SPDX-License-Identifier: CECILL-2.1
"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source ``csrc/<stem>.cu`` builds at first use into its own
``build/kernels/lib<stem>-<hash>.so`` beside the package, keyed by a hash
of the source, of every ``csrc`` header it includes (``#include "..."``,
followed through headers) and of the flags, and written with an atomic
``os.replace``.
Each source exports ``const char* <stem>_error_string(int)`` and C
functions that return ``cudaGetLastError()`` after their launch; a build
failure or a non-zero code raises. Builds of different sources may run in
parallel threads (``subprocess`` releases the interpreter lock).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_LOG", "check_tensor", "load", "raise_on", "source_digest"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: compiler output of each source's last build in this process, by stem
#: (registers, shared memory, spills); absent when the library was cached
BUILD_LOG: dict[str, str] = {}
_LOCKS: dict[str, threading.Lock] = {}
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)
_LOCKS_GUARD = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def source_digest(stem: str) -> str:
    """Hash of ``csrc/<stem>.cu``, the ``csrc`` files it includes (and
    those include), and the flags: the key of the built library."""
    h = hashlib.sha256()
    todo, seen = [f"{stem}.cu"], set()
    while todo:
        name = todo.pop()
        path = CSRC / name
        if name in seen or not path.is_file():  # a system or toolkit header
            continue
        seen.add(name)
        data = path.read_bytes()
        h.update(name.encode() + b"\0" + data)
        todo += _INCLUDE.findall(data.decode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(stem: str) -> ctypes.CDLL:
    """Compile ``csrc/<stem>.cu`` (once per :func:`source_digest`) and load it."""
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(stem, threading.Lock())
    with lock:
        src = CSRC / f"{stem}.cu"
        so = BUILD_DIR / f"lib{stem}-{source_digest(stem)}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            BUILD_LOG[stem] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{BUILD_LOG[stem]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    err = getattr(lib, f"{stem}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def raise_on(lib, stem: str, rc: int, what: str) -> None:
    """Raise if a launch returned a non-zero CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{stem}_error_string")(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def check_tensor(t, kernel: str, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )
