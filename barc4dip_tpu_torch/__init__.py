# SPDX-License-Identifier: CECILL-2.1
"""PyTorch/CUDA port of barc4dip_tpu.

The JAX package ``barc4dip_tpu`` is the reference; this package keeps its
module names and result dicts and runs on an NVIDIA GPU, with hand-written
CUDA kernels where the JAX package has Pallas kernels. It imports torch and
numpy, never jax.

Ported so far: ``speckle_stack_stats`` (all four metric groups, full frame
plus tiles, abs/inc template tracking) with kernel K1 (``ops/cuda_fftp.py``
+ ``csrc/fftp_corr.cu``), and the XST path: ``preprocessing`` (flat-field
with bad-pixel repair, kernel K2 in ``ops/cuda_median.py`` +
``csrc/median3x3.cu``), ``signal`` (dense tracking, kernel K3 in
``ops/cuda_densetrack.py`` + ``csrc/densetrack_sums.cu``), ``maths`` and
``models``. See ROADMAP.md.
"""
from . import config
from .metrics import speckle_stack_stats

__all__ = ["config", "speckle_stack_stats"]
