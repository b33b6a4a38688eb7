# SPDX-License-Identifier: CECILL-2.1
"""Device and precision policy of the PyTorch port.

- Work runs on an explicit ``device``; the default is ``cuda`` when a card
  is present, else the CPU. A tensor input computes on its own device.
- The compute dtype follows the input: float64 stays float64, every other
  dtype (uint16 detector frames included) computes in float32, as
  ``barc4dip_tpu/metrics/stack_fused.py::_to_compute`` does. Integer
  frames may be uint8, int8, int16, uint16, int32, uint32 or int64 (numpy
  arrays or tensors); uint64 raises ``TypeError``.
- TF32 is off. It keeps about three decimal digits, and the metric value
  gate compares against a float reference at rtol 1e-4.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MIN_TILE_PX",
    "resolve_device",
    "to_compute",
    "upload",
]

MIN_TILE_PX: int = 128

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# torch's unsigned 16/32-bit types support few operations: they are read as
# the signed type of the same width, widened, and masked back
_UNSIGNED = {torch.uint16: (torch.int16, torch.int32), torch.uint32: (torch.int32, torch.int64)}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means cuda when available."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
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
    blocking on a card; the cast happens on the device."""
    t = torch.from_numpy(np.ascontiguousarray(frames))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return to_compute(t)
