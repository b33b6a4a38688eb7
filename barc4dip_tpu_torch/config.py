# SPDX-License-Identifier: CECILL-2.1
"""Device and precision policy of the PyTorch port.

- Work runs on an explicit ``device``. The default, ``None``, means the
  card: without one it raises, and never runs on the CPU unasked. Pass
  ``device="cpu"`` for the CPU. A tensor input computes on its own device.
- The compute dtype follows the input: float64 stays float64, every other
  dtype (uint16 detector frames included) computes in float32, as
  ``barc4dip_tpu/metrics/stack_fused.py::_to_compute`` does. Integer
  frames may be uint8, int8, int16, uint16, int32, uint32 or int64 (numpy
  arrays or tensors); uint64 raises ``TypeError``.
- TF32 is off. It keeps about three decimal digits, and the metric value
  gate compares against a float reference at rtol 1e-4.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

__all__ = [
    "MIN_TILE_PX",
    "SATURATION_VALUE",
    "device_array",
    "device_arrays",
    "device_cache",
    "device_constant",
    "holding_cached",
    "resolve_device",
    "to_compute",
    "upload",
]

MIN_TILE_PX: int = 128
SATURATION_VALUE: float = 65535.0

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# torch's unsigned 16/32-bit types support few operations: they are read as
# the signed type of the same width, widened, and masked back
_UNSIGNED = {torch.uint16: (torch.int16, torch.int32), torch.uint32: (torch.int32, torch.int64)}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device. ``None`` means cuda, and raises
    ``RuntimeError`` where no card is available: the CPU is never chosen
    unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (torch.cuda.is_available() is False) and "
                'none was asked for: pass device="cpu" to run on the CPU'
            )
        return torch.device("cuda")
    return torch.device(device)


def to_compute(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its compute dtype, on its own device."""
    if x.dtype in (torch.float32, torch.float64):
        return x
    if x.dtype == torch.uint64:
        raise TypeError("uint64 frames are not supported; pass uint32 or a float dtype")
    if x.dtype in _UNSIGNED:
        signed, wide = _UNSIGNED[x.dtype]
        x = x.view(signed).to(wide) & ((1 << (8 * x.element_size())) - 1)
    return x.to(torch.float32)


def upload(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host frames -> device tensor in their compute dtype.

    The bytes travel in the frames' own dtype, from pinned memory without
    blocking on a card; the cast happens on the device. Frames in the other
    byte order (``EdfFile.GetData`` of a big-endian file, a big-endian HDF5
    dataset) are swapped on the host first: torch takes native byte order
    only."""
    with annotate("upload"):
        frames = np.ascontiguousarray(frames)
        if not frames.dtype.isnative:
            frames = frames.astype(frames.dtype.newbyteorder("="))
        t = torch.from_numpy(frames)
        if device.type == "cuda":
            with annotate("upload.pin"):
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        else:
            t = t.to(device)
        return to_compute(t)


def device_array(x, device=None) -> torch.Tensor:
    """A numpy array or a tensor as a tensor in its compute dtype: a tensor
    stays on its own device, an array is uploaded to ``device``. Complex
    values (complex64, complex128) pass through as they are, for the signal
    layer's transforms and correlations."""
    if isinstance(x, torch.Tensor):
        return x if x.is_complex() else to_compute(x)
    arr = np.asarray(x)
    device = resolve_device(device)
    if arr.dtype.kind == "c":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return upload(arr, device)


def device_arrays(*xs, device=None) -> tuple[torch.Tensor, ...]:
    """:func:`device_array` of several inputs on one device: that of the
    first tensor among them, else ``device``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            device = x.device
            break
    device = resolve_device(device)
    return tuple(device_array(x, device).to(device) for x in xs)


_HOLDERS: list[list] = []  # the open holding_cached() lists, innermost last


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for the builders of device tensors
    that the metric step reads (plans, constants). Inside
    :func:`holding_cached`, whatever the builder returns is also kept by the
    innermost holder: a CUDA graph captured there reads those tensors at
    fixed addresses, and holds them for as long as it lives, whatever the
    cache drops."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            out = cached(*args)
            if _HOLDERS:
                _HOLDERS[-1].append(out)
            return out

        call.cache_clear, call.cache_info = cached.cache_clear, cached.cache_info
        return call
    return wrap


@contextlib.contextmanager
def holding_cached():
    """Yields a list that keeps every :func:`device_cache` result handed
    out inside the block."""
    held: list = []
    _HOLDERS.append(held)
    try:
        yield held
    finally:
        _HOLDERS.pop()


@device_cache(256)
def _constant(raw: bytes, np_dtype: str, shape: tuple, dtype, device) -> torch.Tensor:
    host = np.frombuffer(raw, np.dtype(np_dtype)).reshape(shape).copy()
    return torch.as_tensor(host, dtype=dtype, device=device)


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype, device=device)`` of a small
    host constant (quantile levels, radial axes, tile indices, ROI offsets),
    built once for each (values, dtype, device) and shared by every later
    call. A host array copied to the card each call would make the host wait
    for the card, and a CUDA graph cannot hold such a copy. The tensor is
    shared: read it, never write it."""
    arr = np.asarray(values)
    return _constant(arr.tobytes(), arr.dtype.str, arr.shape, dtype, torch.device(device))


# last: the utils package imports this module
from .utils.profiling import annotate  # noqa: E402
