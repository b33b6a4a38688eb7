# SPDX-License-Identifier: CECILL-2.1
"""TIFF codec front-end (counterpart of ``barc4dip_tpu/io/tiff.py``).

Reading prefers the in-repo C++ codec (native/dipio.cpp, enabled with
BARC4DIP_TORCH_NATIVE_IO=1) for baseline uncompressed grayscale files; a
compressed or non-baseline file goes to Pillow. That is the format dispatch
of the host readers, as in the JAX package: it chooses no device and no
kernel. Writing converts to uint16 by default (detector convention, via
:func:`..utils.dtype.to_uint16`) or stores float32 verbatim with
``dtype="float32"``; a 3D stack becomes one numbered file per frame.

Pillow is imported where a file is decoded or written with it, not with the
module: the package and the native reader work without it.
"""
from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

import numpy as np

from ..utils.dtype import to_uint16

__all__ = ["read_tiff", "save_tiff"]


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "Pillow (PIL) is needed to decode this TIFF (compressed or non-baseline, or "
            "BARC4DIP_TORCH_NATIVE_IO is off) and to write TIFF files"
        ) from exc
    return Image


def _native_enabled() -> bool:
    from .native import native_io_requested

    return native_io_requested()


def _decode(path: str) -> np.ndarray:
    if _native_enabled():
        from .native import read_tiff_native

        try:
            return read_tiff_native(path)
        except OSError:
            pass  # compressed/non-baseline layout: Pillow handles it below
    with _pil_image().open(path) as img:
        return np.array(img)


def read_tiff(image_path: str | Sequence[str]) -> np.ndarray:
    """Decode one TIFF to (H, W), or a list of TIFFs to an (N, H, W) stack
    (every file must share the first file's frame shape)."""
    if isinstance(image_path, str):
        return _decode(image_path)
    if not isinstance(image_path, Sequence):
        raise TypeError("image_path should be one path string or a sequence of them")
    if len(image_path) == 0:
        raise ValueError("got an empty image_path sequence")

    frames: list[np.ndarray] = []
    for path in image_path:
        if not isinstance(path, str):
            raise TypeError("image_path entries must all be path strings")
        arr = _decode(path)
        if frames and arr.shape != frames[0].shape:
            raise ValueError(
                f"Inconsistent image shapes in stack: "
                f"expected {frames[0].shape}, got {arr.shape} for '{path}'"
            )
        frames.append(arr)
    return np.stack(frames, axis=0)


def save_tiff(data: np.ndarray, output_path: str | Path, *,
              dtype: str = "uint16", device=None) -> None:
    """Write a 2D image as one TIFF, or each frame of a 3D stack as
    ``<stem>_0000.tif``, ``<stem>_0001.tif``, ...

    ``dtype="uint16"`` (default) converts through :func:`to_uint16` (note
    its counts-vs-normalized heuristic contrast-STRETCHES data whose mean is
    below ~10 counts, which silently rescales e.g. constant calibration
    frames); data that is not uint16 already is converted on ``device``
    (``None``: the card, and an error without one). ``dtype="float32"``
    writes the values verbatim as a 32-bit float TIFF — lossless for
    darks/flats and analysis products."""
    if not isinstance(data, np.ndarray):
        raise TypeError("expected a numpy.ndarray to write")
    if data.ndim not in (2, 3):
        raise ValueError(f"data must be 2D or 3D, got ndim={data.ndim}")
    if dtype not in ("uint16", "float32"):
        raise ValueError("dtype must be 'uint16' or 'float32'")

    target = Path(output_path)
    if not target.name:
        raise ValueError("output_path needs a file name component")
    parent = target.parent
    if not parent.exists():
        raise OSError(f"cannot write here - parent directory does not exist: {parent}")
    if not parent.is_dir():
        raise OSError(f"cannot write here - parent path is not a directory: {parent}")

    suffix = target.suffix.lower()
    if suffix not in (".tif", ".tiff"):
        suffix = ".tif"
    out = (to_uint16(data, device=device) if dtype == "uint16"
           else np.asarray(data, dtype=np.float32))
    Image = _pil_image()

    def _write(frame: np.ndarray, where: Path) -> None:
        try:
            Image.fromarray(frame).save(where)
        except OSError as e:
            raise OSError(f"could not write TIFF file {where}") from e

    if data.ndim == 2:
        _write(out, target.with_suffix(suffix))
        return
    stem = target.with_suffix("")
    for i, frame in enumerate(out):
        _write(frame, stem.parent / f"{stem.name}_{i:04d}{suffix}")
