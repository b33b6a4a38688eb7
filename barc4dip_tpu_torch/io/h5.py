# SPDX-License-Identifier: CECILL-2.1
"""HDF5 image I/O for the ESRF beamline layout (counterpart of
``barc4dip_tpu/io/h5.py``).

Every file is expected to carry its pixels at ``entry_0000/measurement/
data`` (the convention the reference hardcodes, io/h5.py:62). Reading a
list of files builds a stack: 2D datasets stack along a new leading axis,
3D datasets concatenate along theirs — mixing the two is an error.
Writing creates NX-annotated groups with gzip-4 chunked compression and
never clobbers an existing file.

``h5py`` is imported where a file is opened, not with the module: the
package imports without it.
"""
from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

import numpy as np

__all__ = ["read_h5", "save_h5", "DATASET_PATH"]

DATASET_PATH = "entry_0000/measurement/data"


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("h5py is needed to read and write HDF5 files") from exc
    return h5py


def _resolve_frame(n_frames: int, image_number: int, path: str) -> int:
    """Python-style frame index resolution (negatives count from the end)."""
    idx = int(image_number)
    if idx < 0:
        idx += n_frames
    if not 0 <= idx < n_frames:
        raise ValueError(
            f"image_number={image_number} out of bounds for dataset "
            f"with {n_frames} frames in '{path}'"
        )
    return idx


def _load_one(p: str, image_number: int | None) -> np.ndarray:
    if not isinstance(p, str):
        raise TypeError("image_path entries must all be path strings")
    if not Path(p).exists():
        raise FileNotFoundError(f"no such HDF5 file: '{p}'")

    h5py = _h5py()
    try:
        with h5py.File(p, "r") as f:
            dset = f.get(DATASET_PATH)
            if dset is None:
                raise KeyError(f"missing dataset: '{DATASET_PATH}' in '{p}'")
            if image_number is None:
                arr = np.asarray(dset[()])
            elif dset.ndim != 3:
                raise ValueError(
                    f"image_number is only valid for 3D datasets (N, H, W); "
                    f"got shape {dset.shape} in '{p}'"
                )
            else:
                idx = _resolve_frame(int(dset.shape[0]), image_number, p)
                arr = np.asarray(dset[idx, :, :])
    except OSError as e:
        raise OSError(f"could not read HDF5 file '{p}'") from e

    if arr.ndim not in (2, 3):
        raise ValueError(
            f"Expected 2D or 3D dataset at '{DATASET_PATH}', "
            f"got shape {arr.shape} in '{p}'"
        )
    return arr


def _combine(arrays: list[np.ndarray], paths: Sequence[str]) -> np.ndarray:
    """Stack 2D frames / concatenate 3D blocks, enforcing consistent
    frame geometry across the files."""
    ndims = {a.ndim for a in arrays}
    if ndims == {2}:
        want = arrays[0].shape
        for p, a in zip(paths, arrays):
            if a.shape != want:
                raise ValueError(
                    f"Inconsistent image shapes in stack: expected {want}, "
                    f"got {a.shape} for '{p}'"
                )
        return np.stack(arrays, axis=0)
    if ndims == {3}:
        want = arrays[0].shape[1:]
        for p, a in zip(paths, arrays):
            if a.shape[1:] != want:
                raise ValueError(
                    f"Inconsistent stack shapes: expected (*, {want}), "
                    f"got {a.shape} for '{p}'"
                )
        return np.concatenate(arrays, axis=0)
    raise ValueError(
        f"files disagree on dataset dimensionality: ndims={sorted(ndims)}"
    )


def read_h5(
    image_path: str | Sequence[str], *, image_number: int | None = None
) -> np.ndarray:
    """Load pixels from one HDF5 file or assemble a stack from several.

    One path: the dataset as stored — (H, W) or (N, H, W) — or one frame
    of a 3D dataset when ``image_number`` is given (negatives allowed).
    Several paths: see the module docstring's stacking rules;
    ``image_number`` is rejected there.
    """
    if isinstance(image_path, str):
        return _load_one(image_path, image_number)

    if not isinstance(image_path, Sequence):
        raise TypeError("image_path should be one path string or a sequence of them")
    if image_number is not None:
        raise ValueError("image_number applies only to a single-file image_path")
    if len(image_path) == 0:
        raise ValueError("got an empty image_path sequence")

    return _combine([_load_one(p, None) for p in image_path], image_path)


def save_h5(data: np.ndarray, output_path: str | Path) -> None:
    """Write a 2D image or 3D stack into a fresh ESRF-layout HDF5 file.

    The dataset lands at ``entry_0000/measurement/data`` with NXentry /
    NXcollection attributes and gzip-4 chunking; a ``.h5`` suffix is
    appended when the path carries neither ``.h5`` nor ``.hdf5``.
    Existing files are never overwritten.
    """
    if not isinstance(data, np.ndarray):
        raise TypeError("expected a numpy.ndarray to write")
    if data.ndim not in (2, 3):
        raise ValueError(f"data must be 2D or 3D, got ndim={data.ndim}")

    out = Path(output_path)
    if not out.name:
        raise ValueError("output_path needs a file name component")
    parent = out.parent
    if not parent.exists():
        raise OSError(f"cannot write here - parent directory does not exist: {parent}")
    if not parent.is_dir():
        raise OSError(f"cannot write here - parent path is not a directory: {parent}")
    if out.suffix.lower() not in (".h5", ".hdf5"):
        out = out.with_suffix(".h5")
    if out.exists():
        raise OSError(f"refusing to overwrite - file already exists: {out}")

    h5py = _h5py()
    try:
        with h5py.File(out, "x") as f:
            entry = f.require_group("entry_0000")
            entry.attrs.setdefault("NX_class", "NXentry")
            measurement = entry.require_group("measurement")
            measurement.attrs.setdefault("NX_class", "NXcollection")
            measurement.create_dataset(
                "data", data=data,
                compression="gzip", compression_opts=4, chunks=True,
            )
    except OSError as e:
        raise OSError(f"could not write HDF5 file {out}") from e
