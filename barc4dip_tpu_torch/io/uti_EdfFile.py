# SPDX-License-Identifier: CECILL-2.1
"""Compatibility shim for the reference's vendored module path
(counterpart of ``barc4dip_tpu/io/uti_EdfFile.py``): user code commonly
imports ``EdfFile`` from ``barc4dip.io.uti_EdfFile``; the clean-room parser
with the same surface lives in :mod:`.edf`."""
from .edf import EdfFile

__all__ = ["EdfFile"]
