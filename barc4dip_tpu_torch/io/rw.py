# SPDX-License-Identifier: CECILL-2.1
"""Top-level image I/O: one reader and one writer, routed by extension
(counterpart of ``barc4dip_tpu/io/rw.py``).

Behavioural contract follows reference io/rw.py:66-189 — readable formats
are TIFF/EDF/HDF5 (this package adds .edf.gz/.edf.bz2 and the wrapped
detector containers .cbf/.spe via the EDF reader), writable formats
are TIFF/HDF5, and asking to write EDF is refused rather than silently
routed elsewhere. ``image_number`` only ever applies to a single HDF5
file; ``mean=True`` collapses a loaded stack to its average frame.
"""
from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

import numpy as np

from ..utils.time import elapsed_time, now
from .edf import read_edf
from .h5 import read_h5, save_h5
from .tiff import read_tiff, save_tiff

__all__ = ["read_image", "write_image"]

# extension (lowercase, no dot) -> reader callable; HDF5 is the only
# format whose reader understands frame selection
_READERS = {
    "tif": read_tiff,
    "tiff": read_tiff,
    "edf": read_edf,
    # wrapped detector containers the EDF reader dispatches by magic
    # (Pilatus mini-CBF, WinView SPE; beyond the reference's dispatcher,
    # whose vendored parser only reached these through direct EdfFile use)
    "cbf": read_edf,
    "spe": read_edf,
    "h5": read_h5,
    "hdf5": read_h5,
}

_WRITERS = {
    "tif": save_tiff,
    "tiff": save_tiff,
    "h5": save_h5,
    "hdf5": save_h5,
}

_H5_EXTS = {"h5", "hdf5"}


def _extension_of(path: str, override: str | None) -> str:
    """Lowercased extension, honouring an explicit override and the
    double-suffix compressed-EDF spellings."""
    if override:
        return override.lower().lstrip(".")
    lowered = Path(path).name.lower()
    if lowered.endswith((".edf.gz", ".edf.bz2")):
        return "edf"
    suffix = Path(path).suffix
    if not suffix:
        raise ValueError(
            "Cannot infer file extension from path (no suffix). "
            "Provide file_extension explicitly."
        )
    return suffix.lower().lstrip(".")


def read_image(
    image_path: str | Sequence[str],
    *,
    file_extension: str | None = None,
    image_number: int | None = None,
    mean: bool = False,
    verbose: bool = False,
) -> np.ndarray:
    """Load one image or a (N, H, W) stack, dispatching on the extension.

    A sequence of paths loads as a stack (all files must share one
    format). ``image_number`` picks a single frame out of a 3D HDF5
    dataset; ``mean=True`` averages a loaded stack down to 2D.
    """
    t0 = now()

    single = isinstance(image_path, str)
    if single:
        ext = _extension_of(image_path, file_extension)
    else:
        if not isinstance(image_path, Sequence):
            raise TypeError(
                "image_path should be one path string or a sequence of them"
            )
        if len(image_path) == 0:
            raise ValueError("got an empty image_path sequence")
        if image_number is not None:
            raise ValueError("image_number applies only to a single-file image_path")
        per_file = {_extension_of(p, file_extension) for p in image_path}
        if len(per_file) > 1:
            raise ValueError(f"image_path mixes file extensions: {sorted(per_file)}")
        ext = per_file.pop()

    reader = _READERS.get(ext)
    if reader is None:
        raise ValueError(f"Unsupported input extension: '{ext}'")

    if ext in _H5_EXTS:
        data = reader(image_path, image_number=image_number)
    else:
        if image_number is not None:
            raise ValueError(
                "image_number applies only to single-file HDF5 stacks (.h5/.hdf5)."
            )
        data = reader(image_path)

    if mean and data.ndim == 3:
        data = data.mean(axis=0)
        if verbose:
            print("Collapsed 3D stack to mean image along axis 0.")

    if verbose:
        n_img, (h, w) = (1, data.shape) if data.ndim == 2 else (
            data.shape[0], data.shape[1:],
        )
        print(f"> {n_img} image(s) ({h} x {w}), {data.nbytes / 1024**3:.2f} Gb in memory")
        elapsed_time(t0)

    return data


def write_image(
    data: np.ndarray,
    output_path: str | Path,
    *,
    file_extension: str | None = None,
    verbose: bool = False,
    device=None,
) -> None:
    """Persist an image or stack; the extension picks the container.
    ``device`` is where a TIFF's uint16 conversion runs (see
    :func:`.tiff.save_tiff`)."""
    if not isinstance(data, np.ndarray):
        raise TypeError("expected a numpy.ndarray to write")

    target = Path(output_path)
    ext = _extension_of(str(target), file_extension)

    if ext == "edf":
        raise ValueError("Writing EDF is not supported (legacy read-only format).")
    writer = _WRITERS.get(ext)
    if writer is None:
        raise ValueError(f"Unsupported output extension: '{ext}'")

    if writer is save_tiff:
        save_tiff(data, target, device=device)
    else:
        writer(data, target)
    if verbose:
        print(f"Data written successfully to '{target}'")
