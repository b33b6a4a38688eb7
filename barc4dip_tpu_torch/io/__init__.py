# SPDX-License-Identifier: CECILL-2.1
"""Host-side image I/O: TIFF, EDF (legacy), ESRF-style HDF5 (counterpart of
``barc4dip_tpu/io``). numpy in and out; ``h5py`` and Pillow are imported
only where a call needs them."""
from . import uti_EdfFile  # legacy vendored-module path (compat shim)
from .edf import EdfFile, read_edf, save_edf
from .h5 import read_h5, save_h5
from .rw import read_image, write_image
from .tiff import read_tiff, save_tiff

__all__ = [
    "read_image",
    "write_image",
    "read_tiff",
    "save_tiff",
    "read_edf",
    "save_edf",
    "EdfFile",
    "read_h5",
    "save_h5",
]
