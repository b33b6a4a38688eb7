# SPDX-License-Identifier: CECILL-2.1
"""ctypes bindings for the native I/O runtime (native/dipio.cpp; the port's
counterpart of ``barc4dip_tpu/io/native.py``, over the same C++ source).

The shared library is built with g++ at first use into ``build/native/``
beside the package (keyed by a hash of the source, written with an atomic
rename) and loaded lazily. It is a host codec, off unless
``BARC4DIP_TORCH_NATIVE_IO`` is truthy; where no toolchain is present the
readers use the pure-Python codecs, ``native_available()`` reports the
state and ``load_error()`` the compiler's words.

Provides:
- :class:`NativeEdfFile` — EDF container reads via pread (no Python parsing
  on the hot path);
- :class:`NativeTiffFile` — baseline TIFF reads (uncompressed grayscale
  strips, 8/16/32-bit, both byte orders, multi-page);
- :class:`AsyncStackLoader` — background-thread prefetch of a list of
  EDF/TIFF files (dispatch by magic bytes), overlapping disk I/O with
  device compute;
- :func:`read_edf_native` / :func:`read_tiff_native` — drop-in fast paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "native_available",
    "native_io_requested",
    "load_error",
    "NativeEdfFile",
    "NativeTiffFile",
    "AsyncStackLoader",
    "read_edf_native",
    "read_tiff_native",
]

_DTYPES = {
    0: np.dtype("<i1"), 1: np.dtype("<u1"),
    2: np.dtype("<i2"), 3: np.dtype("<u2"),
    4: np.dtype("<i4"), 5: np.dtype("<u4"),
    6: np.dtype("<i8"), 7: np.dtype("<u8"),
    8: np.dtype("<f4"), 9: np.dtype("<f8"),
}

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dipio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_load_error: str | None = None


def _load():
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        src = SOURCE
        if not src.exists():
            _load_error = f"native source not found: {src}"
            return None
        digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"libdipio-{digest}.so"
        if not so.exists():
            # link to a private temp name and rename atomically: writing the
            # shared path in place would truncate an inode another process
            # may have dlopen'd (SIGBUS on its next call) or hand a
            # concurrent loader a half-written file
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
            try:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            except Exception as exc:
                stderr = getattr(exc, "stderr", b"") or b""
                detail = stderr.decode("utf-8", "replace").strip()
                _load_error = "native build failed: " + (
                    f"{exc}\n{detail}" if detail else str(exc)
                )
                tmp.unlink(missing_ok=True)
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            _load_error = f"native load failed: {exc}"
            return None

        lib.dipio_last_error.restype = ctypes.c_char_p
        lib.dipio_edf_open.restype = ctypes.c_void_p
        lib.dipio_edf_open.argtypes = [ctypes.c_char_p]
        lib.dipio_edf_num_frames.argtypes = [ctypes.c_void_p]
        lib.dipio_edf_frame_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dipio_edf_read_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
        ]
        lib.dipio_edf_close.argtypes = [ctypes.c_void_p]
        lib.dipio_tiff_open.restype = ctypes.c_void_p
        lib.dipio_tiff_open.argtypes = [ctypes.c_char_p]
        lib.dipio_tiff_num_frames.argtypes = [ctypes.c_void_p]
        lib.dipio_tiff_frame_info.argtypes = lib.dipio_edf_frame_info.argtypes
        lib.dipio_tiff_read_frame.argtypes = lib.dipio_edf_read_frame.argtypes
        lib.dipio_tiff_close.argtypes = [ctypes.c_void_p]
        lib.dipio_prefetch_open.restype = ctypes.c_void_p
        lib.dipio_prefetch_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int
        ]
        lib.dipio_prefetch_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dipio_prefetch_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native runtime built and loaded successfully."""
    return _load() is not None


def load_error() -> str | None:
    """Why the runtime did not build or load (the compiler's stderr
    included), or ``None``."""
    _load()
    return _load_error


def native_io_requested() -> bool:
    """True when BARC4DIP_TORCH_NATIVE_IO is truthy AND the runtime loads —
    the single routing gate shared by the EDF and TIFF readers."""
    if os.environ.get("BARC4DIP_TORCH_NATIVE_IO", "").strip().lower() not in (
        "1", "true", "yes", "on",
    ):
        return False
    return native_available()


def _err(lib) -> str:
    return lib.dipio_last_error().decode("utf-8", "replace")


class _NativeFrameFile:
    """Shared frame-container reader over the native codecs."""

    _prefix = ""  # "edf" or "tiff"

    def __init__(self, path: str | Path):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native I/O unavailable: {_load_error}")
        self._lib = lib
        self._fn = {
            name: getattr(lib, f"dipio_{self._prefix}_{name}")
            for name in ("open", "num_frames", "frame_info", "read_frame", "close")
        }
        self._handle = self._fn["open"](str(path).encode())
        if not self._handle:
            raise OSError(f"dipio: {_err(lib)} ({path})")
        self.path = Path(path)

    def _live_handle(self):
        if self._handle is None:
            raise RuntimeError(f"{type(self).__name__} is closed")
        return self._handle

    @property
    def NumImages(self) -> int:  # noqa: N802 - legacy API name
        return int(self._fn["num_frames"](self._live_handle()))

    def GetNumImages(self) -> int:  # noqa: N802
        return self.NumImages

    def GetData(self, index: int) -> np.ndarray:  # noqa: N802
        lib = self._lib
        handle = self._live_handle()
        d1 = ctypes.c_int64()
        d2 = ctypes.c_int64()
        dt = ctypes.c_int()
        le = ctypes.c_int()
        nb = ctypes.c_int64()
        if self._fn["frame_info"](
            handle, index, ctypes.byref(d1), ctypes.byref(d2),
            ctypes.byref(dt), ctypes.byref(le), ctypes.byref(nb),
        ) != 0:
            raise IndexError(_err(lib))
        dtype = _DTYPES[dt.value]
        if not le.value:
            dtype = dtype.newbyteorder(">")
        out = np.empty((d2.value, d1.value), dtype=dtype)
        if self._fn["read_frame"](
            handle, index, out.ctypes.data_as(ctypes.c_void_p), nb.value
        ) != 0:
            raise OSError(f"dipio: {_err(lib)}")
        return out

    def close(self) -> None:
        if self._handle:
            self._fn["close"](self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativeEdfFile(_NativeFrameFile):
    """EDF container reader backed by the native codec."""

    _prefix = "edf"


class NativeTiffFile(_NativeFrameFile):
    """Baseline TIFF reader backed by the native codec (uncompressed
    grayscale strips; 8/16/32-bit; both byte orders; pages are frames)."""

    _prefix = "tiff"


class AsyncStackLoader:
    """Iterate frames of many single-frame EDF/TIFF files (format detected
    per file by magic bytes) with background prefetch (``window`` files
    ahead on ``n_threads`` reader threads).

    Usage::

        for frame in AsyncStackLoader(paths):
            pinned = torch.from_numpy(frame).pin_memory()   # overlaps with next reads

    Frames arrive in native byte order whatever the file's.
    """

    def __init__(self, paths, *, n_threads: int = 4, window: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native I/O unavailable: {_load_error}")
        self._lib = lib
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.dipio_prefetch_open(arr, len(self._paths), n_threads, window)
        if not self._handle:
            raise OSError(f"dipio: {_err(lib)} (prefetcher open failed)")
        self._n = len(self._paths)
        self._consumed = 0
        # generous per-frame capacity guess; grows on demand
        self._cap = 1 << 20

    def __iter__(self):
        return self

    def __len__(self) -> int:
        return self._n

    def __next__(self) -> np.ndarray:
        if self._consumed >= self._n:
            self.close()
            raise StopIteration
        if self._handle is None:
            # a closed loader must fail as a Python error, not hand the C
            # side a NULL pointer
            raise RuntimeError("AsyncStackLoader is closed")
        lib = self._lib
        d1 = ctypes.c_int64()
        d2 = ctypes.c_int64()
        dt = ctypes.c_int()
        while True:
            buf = np.empty(self._cap, dtype=np.uint8)
            rc = lib.dipio_prefetch_next(
                self._handle, buf.ctypes.data_as(ctypes.c_void_p), self._cap,
                ctypes.byref(d1), ctypes.byref(d2), ctypes.byref(dt),
            )
            if rc == 0:
                break
            if rc == 2:  # buffer too small: the call reported the geometry
                need = d1.value * d2.value * _DTYPES[dt.value].itemsize
                self._cap = max(int(need), self._cap)
                continue
            msg = _err(lib)
            self.close()
            if rc == 1:
                raise StopIteration
            raise OSError(f"dipio: {msg}")
        self._consumed += 1
        dtype = _DTYPES[dt.value]
        nbytes = d1.value * d2.value * dtype.itemsize
        # the buffer is fresh per call: the reshaped view owns it, no second
        # copy needed on this hot path
        return buf[:nbytes].view(dtype).reshape(d2.value, d1.value)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dipio_prefetch_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def read_edf_native(path: str | Path, *, index: int = 0, dtype=np.float32) -> np.ndarray:
    """Read one frame through the native codec (uncompressed EDF only)."""
    f = NativeEdfFile(path)
    try:
        return np.asarray(f.GetData(index), dtype=dtype)
    finally:
        f.close()


def read_tiff_native(path: str | Path, *, index: int = 0, dtype=None) -> np.ndarray:
    """Read one page through the native codec (baseline uncompressed
    grayscale TIFF); ``dtype=None`` keeps the stored dtype."""
    f = NativeTiffFile(path)
    try:
        data = f.GetData(index)
        return data if dtype is None else np.asarray(data, dtype=dtype)
    finally:
        f.close()
