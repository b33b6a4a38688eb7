# SPDX-License-Identifier: CECILL-2.1
"""Tensor primitives of the speckle slice; ``cuda_fftp`` holds kernel K1."""
