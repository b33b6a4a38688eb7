# SPDX-License-Identifier: CECILL-2.1
"""End-to-end analysis pipelines (counterpart of
``barc4dip_tpu/models/pipeline.py``): dense XST wavefront sensing over a
scan, the sharpness focus scan, flat-field plus speckle-stack analysis, and
``full_step_fn``, the flagship per-chunk step as one function on tensors.

Each pipeline takes ``device`` once, in its constructor (``None``: the card,
and an error without one; ``"cpu"`` for the CPU), and hands it to every call
it makes. The file-driven entry points (``run_files``, ``run_edf_files``,
``run_hdf5``) stream frames from disk chunk by chunk through
:class:`_FrameSequence` / :class:`_NdarrayView`. ``mesh``
(:func:`..parallel.frame_mesh`) spreads the frames over the mesh's devices.
"""
from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
import torch

from ..metrics.common import normalize_groups
from ..metrics.estimators import amplitude_core, distribution_moments_core, grain_core
from ..metrics.sharpness import _ALL_SHARPNESS_GROUPS, sharpness_stack_stats
from ..metrics.speckles import speckle_stack_stats
from ..metrics.tracking_batch import _extract_tiles
from ..ops import ncc as ncc_ops
from ..ops import phasecorr as pc_ops
from ..preprocessing.normalize import flat_field_correction

__all__ = [
    "SharpnessScanPipeline",
    "SpeckleStackPipeline",
    "WavefrontScanPipeline",
    "full_step_fn",
]


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
        device=None,
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
        self.device = device

    def __call__(self, stack, reference=None, *, verbose: bool = False) -> dict:
        from ..signal.xst import (
            track_displacement_field,
            track_displacement_stack,
            wavefront_from_displacements,
        )

        kw = dict(
            tile_size=self.tile_size, step=self.step,
            search_radius=self.search_radius, subpixel=self.subpixel,
            method=self.method, device=self.device,
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
        """Wavefront scan from single-frame EDF/TIFF files (frames load
        lazily per tracking call; the first file is the reference where no
        ``reference_path`` is given)."""
        from ..io import read_image

        seq = _NdarrayView(_FrameSequence(list(paths)))
        ref = None if reference_path is None else read_image(reference_path, verbose=False)
        return self(seq, ref, verbose=verbose)


class SharpnessScanPipeline:
    """Focus-scan workflow: run sharpness metrics over a scan stack and
    pick the best-focus frame by a chosen focus operator."""

    def __init__(
        self,
        *,
        metrics: str | Sequence[str] = "gradient,laplacian",
        focus_metric: tuple[str, str] = ("gradient", "tenengrad"),
        tiles: bool = False,
        frame_chunk: int = 8,
        mesh=None,
        device=None,
    ):
        self.metrics = metrics
        self.focus_metric = focus_metric
        self.tiles = tiles
        self.frame_chunk = frame_chunk
        self.mesh = mesh
        self.device = device

    def __call__(self, stack, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        # the focus operator is checked before the scan runs: a focus group
        # outside the selected metrics would fail only afterwards, and lose
        # the results
        group, key = self.focus_metric
        selected = normalize_groups(
            self.metrics, all_groups=_ALL_SHARPNESS_GROUPS,
            context="sharpness", param_name="metrics",
        )
        if group not in selected:
            raise ValueError(
                f"focus_metric group {group!r} is not among the selected "
                f"metrics {sorted(selected)}"
            )
        out = sharpness_stack_stats(
            stack if isinstance(stack, (np.ndarray, torch.Tensor)) else np.asarray(stack),
            metrics=self.metrics,
            tiles=self.tiles,
            frame_chunk=self.frame_chunk,
            mesh=self.mesh,
            verbose=verbose,
            checkpoint_dir=checkpoint_dir,
            device=self.device,
        )
        series = np.asarray(out["full"][group][key], dtype=float)
        degenerate = bool(np.all(np.isnan(series)))
        out["meta"]["focus"] = {
            "metric": f"{group}.{key}",
            "best_frame": None if degenerate else int(np.nanargmax(series)),
            "series_min": float("nan") if degenerate else float(np.nanmin(series)),
            "series_max": float("nan") if degenerate else float(np.nanmax(series)),
        }
        return out

    def run_files(self, paths, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        """Out-of-core focus scan from a sequence of single-frame EDF/TIFF
        files (frames load per chunk on demand; formats may be mixed)."""
        return self(
            _NdarrayView(_FrameSequence(paths)), verbose=verbose, checkpoint_dir=checkpoint_dir
        )


class SpeckleStackPipeline:
    """Flat-field + speckle-stack analysis as a single configured pipeline.

    Parameters mirror :func:`..metrics.speckle_stack_stats`; ``mesh``
    shards the frame axis there. ``device`` is where numpy stacks, file
    frames (without a mesh) and the flat-field run.
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
        device=None,
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
        self.device = device

    def _stats(self, stack, *, verbose: bool, checkpoint_dir) -> dict:
        return speckle_stack_stats(
            stack,
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
            device=self.device,
        )

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
            stack = flat_field_correction(stack, flats=flats, darks=darks, device=self.device)
        return self._stats(
            stack if isinstance(stack, (np.ndarray, torch.Tensor)) else np.asarray(stack),
            verbose=verbose, checkpoint_dir=checkpoint_dir,
        )

    def run_edf_files(self, paths, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        """Backwards-compatible alias of :meth:`run_files`."""
        return self.run_files(paths, verbose=verbose, checkpoint_dir=checkpoint_dir)

    def run_files(self, paths, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        """Out-of-core stack analysis from a sequence of single-frame
        EDF/TIFF files (one frame per file, the standard beamline scan
        layout; formats may be mixed)."""
        return self._stats(
            _NdarrayView(_FrameSequence(paths)), verbose=verbose, checkpoint_dir=checkpoint_dir
        )

    def run_hdf5(self, path, *, verbose: bool = False, checkpoint_dir=None) -> dict:
        """Out-of-core stack analysis straight from an ESRF-style HDF5 file.

        The chunk loops only ever slice ``stack[c0:c1]`` / ``stack[t]``, so
        the h5py dataset streams chunk by chunk from disk: stacks larger
        than host RAM process in bounded memory (pair with
        ``checkpoint_dir`` for resumable runs). The dataset's own dtype
        reaches the loop (uint16 stays uint16).
        """
        from ..io.h5 import DATASET_PATH, _h5py

        # No context manager: the returned dict can hold lazy map leaves
        # that re-read frames when first read, so the file outlives this
        # call (the handle closes when the last leaf is dropped).
        f = _h5py().File(path, "r")
        try:
            dset = f[DATASET_PATH]
            if dset.ndim != 3:
                raise ValueError(
                    f"expected a 3D (T, H, W) dataset at {DATASET_PATH}; "
                    f"got shape {dset.shape}"
                )
            return self._stats(_NdarrayView(dset), verbose=verbose, checkpoint_dir=checkpoint_dir)
        except Exception:
            f.close()
            raise


class _FrameSequence:
    """Lazy (T, H, W) frame source over a list of single-frame EDF/TIFF
    files (dispatch by extension, file by file).

    Frames load on demand through :func:`..io.read_edf` / ``read_tiff``
    (both go through the native C++ codec when BARC4DIP_TORCH_NATIVE_IO=1)
    and are cast to ``dtype``, float32 by default whatever the files hold,
    so scan series of any length process in bounded memory. At most one
    frame is cached.
    """

    def __init__(self, paths, *, dtype=np.float32):
        from ..io import read_edf, read_tiff

        self._paths = [str(p) for p in paths]
        if not self._paths:
            raise ValueError("empty frame path list")

        def _read(p: str) -> np.ndarray:
            if p.lower().endswith((".tif", ".tiff")):
                return np.asarray(read_tiff(p), dtype=dtype)
            return read_edf(p, dtype=dtype)

        self._read = _read
        first = self._read(self._paths[0])
        if first.ndim != 2:
            raise ValueError(f"expected 2D frames; got {first.shape}")
        self._frame_shape = first.shape
        self._dtype = first.dtype
        self._cache = {0: first}

    @property
    def shape(self):
        return (len(self._paths), *self._frame_shape)

    @property
    def dtype(self):
        return self._dtype

    def _frame(self, t: int) -> np.ndarray:
        if t not in self._cache:
            self._cache.clear()  # keep at most one cached frame
            self._cache[t] = self._read(self._paths[t])
        return self._cache[t]

    def __getitem__(self, key):
        if isinstance(key, tuple):
            t, rest = key[0], key[1:]
            if isinstance(t, (int, np.integer)):
                frame = self._frame(int(t))
                return frame[rest] if rest else frame
            if rest:  # cropping while chunking: apply to each frame
                if isinstance(t, slice):
                    idx = range(*t.indices(len(self._paths)))
                    return np.stack([self._frame(i)[rest] for i in idx])
                raise TypeError(f"unsupported index {key!r}")
            key = t  # (slice,) over frames: fall through
        if isinstance(key, slice):
            idx = range(*key.indices(len(self._paths)))
            return np.stack([self._frame(t) for t in idx])
        if isinstance(key, (int, np.integer)):
            return self._frame(int(key))
        raise TypeError(f"unsupported index {key!r}")


class _NdarrayView(np.ndarray):
    """Minimal ndarray subclass over a lazily sliced frame source (a
    :class:`_FrameSequence`, an h5py dataset), so it passes the aggregators'
    isinstance checks while every data access goes through the source's own
    slicing. Its own buffer is empty: only ``shape``, ``ndim``, ``dtype``
    and ``stack[c0:c1]`` / ``stack[t]`` mean anything."""

    def __new__(cls, source):
        obj = super().__new__(cls, shape=(0,), dtype=source.dtype)
        obj._source = source
        return obj

    @property
    def shape(self):  # type: ignore[override]
        return tuple(self._source.shape)

    @property
    def ndim(self):  # type: ignore[override]
        return len(self._source.shape)

    @property
    def dtype(self):  # type: ignore[override]
        return np.dtype(self._source.dtype)

    def __getitem__(self, key):
        return np.asarray(self._source[key])


def full_step_fn(roi_side: int, roi_starts: np.ndarray):
    """The flagship per-chunk step as one function on tensors:

        (frames (B, H, W), prevs (B, H, W), flat (H, W), dark (H, W),
         tpl0 (9, s, s)) -> {amplitude, grain, stats: {field: (B,)},
                             dy_abs, dx_abs, dy_inc, dx_inc: (B, 9)}

    Flat-field (a denominator flat - dark <= 0 reads 1), amplitude, grain
    (no map) and distribution moments of each corrected frame, then its
    NCC tracking against the 9 raw frame-0 templates (abs) and the 9 tiles
    of its corrected predecessor (inc): the valid NCC maps of each bank
    through one ``cuda_fftp.corr_from_rfft`` call (kernel K1a on CUDA), their
    argmax and the Newton subpixel step."""
    s = int(roi_side)
    starts = np.asarray(roi_starts, np.int64).reshape(-1, 2)
    centers_y = (starts[:, 0] + (s - 1) / 2.0).astype(np.float32)
    centers_x = (starts[:, 1] + (s - 1) / 2.0).astype(np.float32)

    def step(frames, prevs, flat, dark, tpl0):
        den = flat - dark
        den = torch.where(den <= 0, 1.0, den)
        corrected = (frames - dark) / den
        prev_c = (prevs - dark) / den
        out = {
            "amplitude": amplitude_core(corrected),
            "grain": grain_core(corrected, with_map=False),
            "stats": distribution_moments_core(corrected),
        }
        prep = ncc_ops.zncc_prepare_image(corrected, s, s)

        def peaks(templates):
            corr = ncc_ops.ncc_valid_from_prepared(prep, templates)
            i, j = pc_ops.argmax2d(corr)
            di, dj = pc_ops.subpixel_taylor(corr, i, j)
            return i.to(corr.dtype) + di, j.to(corr.dtype) + dj

        half = (s - 1) / 2.0
        cy = torch.as_tensor(centers_y, device=corrected.device).to(corrected.dtype)
        cx = torch.as_tensor(centers_x, device=corrected.device).to(corrected.dtype)
        for kind, templates in (("abs", tpl0), ("inc", _extract_tiles(prev_c, starts, s))):
            py, px = peaks(templates)
            out[f"dy_{kind}"] = py + half - cy
            out[f"dx_{kind}"] = px + half - cx
        return out

    return step
