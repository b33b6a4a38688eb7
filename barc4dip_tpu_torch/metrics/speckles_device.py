# SPDX-License-Identifier: CECILL-2.1
"""Full-frame plus tiles speckle metrics for a batch of frames (counterpart
of ``barc4dip_tpu/metrics/speckles_device.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import annotate
from .common import subtile_grids_to_3x3_device, tiled_scalar_fields_device
from .estimators import (
    amplitude_core,
    bandwidth_core,
    distribution_moments_core,
    grain_core,
)

__all__ = ["int_value_hint", "speckle_device_fn"]


def int_value_hint(dtype):
    """(lo, hi) integer-value range of a float image converted from an
    integer numpy or torch ``dtype`` (uint16 detector frames), or None."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point or dtype.is_complex or dtype == torch.bool:
            return None
        info = torch.iinfo(dtype)
    elif np.issubdtype(np.dtype(dtype), np.integer):
        info = np.iinfo(dtype)
    else:
        return None
    if info.max - info.min < (1 << 24) and abs(int(info.min)) < (1 << 24):
        return (int(info.min), int(info.max))
    return None


def speckle_device_fn(groups: frozenset, mode: str, sat: float | None, eps: float):
    """The metric step for one static configuration: ``fn(imgs,
    int_range=None)`` maps (..., H, W) frames to {"full": {group: {field:
    (...)}}, "tiles": {"group/field": {"mean", ["std"]}: (..., 3, 3)}}.

    Grain and bandwidth each run their own forward FFT, as in the JAX
    program."""

    cores = {
        "amplitude": lambda img, int_range: amplitude_core(img, integer_range=int_range),
        "grain": lambda img, int_range: grain_core(img, with_map=False),
        "stats": lambda img, int_range: distribution_moments_core(img, saturation_value=sat, eps=eps),
        "bandwidth": lambda img, int_range: bandwidth_core(img),
    }
    chosen = [(g, f"group.{g}", core) for g, core in cores.items() if g in groups]

    def scalars(img, int_range):
        vals: dict = {}
        for g, span, core in chosen:
            with annotate(span):
                vals[g] = core(img, int_range)
        return vals

    def fn(img, int_range=None):
        out: dict = {"full": scalars(img, int_range)}

        def tile_fn(tile):
            return {
                f"{g}/{k}": v
                for g, d in scalars(tile, int_range).items()
                for k, v in d.items()
            }

        if mode == "subtiles_9x9":
            grids = tiled_scalar_fields_device(img, n=9, compute_fn=tile_fn)
            out["tiles"] = subtile_grids_to_3x3_device(grids)
        elif mode == "tiles_3x3":
            grids = tiled_scalar_fields_device(img, n=3, compute_fn=tile_fn)
            out["tiles"] = {k: {"mean": v} for k, v in grids.items()}
        return out

    return fn
