# SPDX-License-Identifier: CECILL-2.1
"""End-to-end analysis pipelines (counterpart of
``barc4dip_tpu/models/pipeline.py``): dense XST wavefront sensing over a
scan, and flat-field plus speckle-stack analysis.

Not ported yet, and raising ``NotImplementedError``: the file-driven entry
points (``run_files``, ``run_edf_files``, ``run_hdf5``; ROADMAP.md Queue 1
item 7), ``SharpnessScanPipeline`` (item 8) and ``full_step_fn`` (item 5).
"""
from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
import torch

from ..metrics.speckles import speckle_stack_stats
from ..preprocessing.normalize import flat_field_correction

__all__ = ["SpeckleStackPipeline", "WavefrontScanPipeline"]


def _file_io_not_ported(name: str):
    return NotImplementedError(
        f"{name}: reading frames from files is not ported yet (ROADMAP.md, Queue 1 item 7)"
    )


class WavefrontScanPipeline:
    """Dense XST wavefront sensing over a scan (see :mod:`..signal.xst`).

    Configured once with the tracking grid and the optics geometry; each
    call takes a (T, H, W) stack (or a 2D frame) plus a reference speckle
    image and returns per-frame displacement fields, slopes and integrated
    wavefront/phase maps.
    """

    def __init__(
        self,
        *,
        pixel_size: float,
        distance: float,
        wavelength: float | None = None,
        tile_size: int = 33,
        step: int = 16,
        search_radius: int = 10,
        subpixel: bool = True,
        method: str = "auto",
        mesh=None,
    ):
        if pixel_size <= 0 or distance <= 0:
            raise ValueError("pixel_size and distance must be positive.")
        self.pixel_size = float(pixel_size)
        self.distance = float(distance)
        self.wavelength = None if wavelength is None else float(wavelength)
        self.tile_size = int(tile_size)
        self.step = int(step)
        self.search_radius = int(search_radius)
        self.subpixel = bool(subpixel)
        self.method = str(method)
        self.mesh = mesh

    def __call__(self, stack, reference=None, *, verbose: bool = False) -> dict:
        from ..signal.xst import (
            track_displacement_field,
            track_displacement_stack,
            wavefront_from_displacements,
        )

        kw = dict(
            tile_size=self.tile_size, step=self.step,
            search_radius=self.search_radius, subpixel=self.subpixel,
            method=self.method,
        )
        arr = stack if hasattr(stack, "ndim") else np.asarray(stack)
        if arr.ndim == 2:
            if reference is None:
                raise ValueError(
                    "a single 2D frame needs an explicit reference image "
                    "(tracking a frame against itself measures nothing)"
                )
            field = track_displacement_field(arr, reference, **kw)
        else:
            field = track_displacement_stack(arr, reference, mesh=self.mesh, **kw)
        wf = wavefront_from_displacements(
            field,
            pixel_size=self.pixel_size,
            distance=self.distance,
            wavelength=self.wavelength,
        )
        out = {**field, **wf}
        out["meta"] = {
            **field["meta"],
            **wf["meta"],
            "kind": "wavefront_scan",
            "units": {
                **field["meta"].get("units", {}),
                **wf["meta"].get("units", {}),
            },
        }
        return out

    def run_files(self, paths, reference_path=None, *, verbose: bool = False) -> dict:
        raise _file_io_not_ported("WavefrontScanPipeline.run_files")


class SpeckleStackPipeline:
    """Flat-field + speckle-stack analysis as a single configured pipeline.

    Parameters mirror :func:`..metrics.speckle_stack_stats`, whose options
    that are not ported yet raise there.
    """

    def __init__(
        self,
        *,
        metrics: str | Sequence[str] = "all",
        tiles: bool = True,
        tracking_method: str = "template",
        tracking_backend: str = "skimage",
        subpixel: bool = True,
        frame_chunk: int = 4,
        mesh=None,
        display_origin: Literal["upper", "lower"] = "lower",
        tracking_search_radius: float | None = None,
    ):
        self.metrics = metrics
        self.tiles = tiles
        self.tracking_method = tracking_method
        self.tracking_backend = tracking_backend
        self.subpixel = subpixel
        self.frame_chunk = frame_chunk
        self.mesh = mesh
        self.display_origin = display_origin
        self.tracking_search_radius = tracking_search_radius

    def __call__(
        self,
        stack,
        *,
        flats=None,
        darks=None,
        verbose: bool = False,
        checkpoint_dir=None,
    ) -> dict:
        if flats is not None or darks is not None:
            stack = flat_field_correction(stack, flats=flats, darks=darks)
        return speckle_stack_stats(
            stack if isinstance(stack, (np.ndarray, torch.Tensor)) else np.asarray(stack),
            metrics=self.metrics,
            tiles=self.tiles,
            tracking_method=self.tracking_method,
            tracking_backend=self.tracking_backend,
            subpixel=self.subpixel,
            frame_chunk=self.frame_chunk,
            mesh=self.mesh,
            display_origin=self.display_origin,
            verbose=verbose,
            checkpoint_dir=checkpoint_dir,
            tracking_search_radius=self.tracking_search_radius,
        )

    def run_edf_files(self, paths, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        raise _file_io_not_ported("SpeckleStackPipeline.run_edf_files")

    def run_files(self, paths, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        raise _file_io_not_ported("SpeckleStackPipeline.run_files")

    def run_hdf5(self, path, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        raise _file_io_not_ported("SpeckleStackPipeline.run_hdf5")
