# SPDX-License-Identifier: CECILL-2.1
"""Device and precision policy of the PyTorch port.

- Work runs on an explicit ``device``; the default is ``cuda`` when a card
  is present, else the CPU.
- The compute dtype follows the input: float64 stays float64, every other
  dtype (uint16 detector frames included) computes in float32, as
  ``barc4dip_tpu/metrics/stack_fused.py::_to_compute`` does.
- TF32 is off. It keeps about three decimal digits, and the metric value
  gate compares against a float reference at rtol 1e-4.
"""
from __future__ import annotations

import torch

__all__ = [
    "MIN_TILE_PX",
    "resolve_device",
    "to_compute",
]

MIN_TILE_PX: int = 128

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means cuda when available."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def to_compute(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in (torch.float32, torch.float64):
        return x
    return x.to(torch.float32)
