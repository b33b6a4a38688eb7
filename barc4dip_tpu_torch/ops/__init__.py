# SPDX-License-Identifier: CECILL-2.1
"""Tensor primitives of the port. The hand-written kernels' wrappers:
``cuda_fftp`` (K1), ``cuda_median`` (K2), ``cuda_densetrack`` (K3), all
built by ``_nvcc``."""
