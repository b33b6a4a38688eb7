# SPDX-License-Identifier: CECILL-2.1
"""PyTorch/CUDA port of barc4dip_tpu.

The JAX package ``barc4dip_tpu`` is the reference; this package keeps its
module names and result dicts and runs on an NVIDIA GPU, with hand-written
CUDA kernels where the JAX package has Pallas kernels. It imports torch and
numpy, never jax.

Ported so far: the speckle API (``speckle_stats`` and its standalone
estimators, ``distribution_moments``, ``speckle_stack_stats`` with every
option but ``mesh``: lazy grain maps, tensor stacks, windowed and phase
tracking, checkpoints) with kernel K1 (``ops/cuda_fftp.py`` +
``csrc/fftp_corr.cu``), ``models.full_step_fn``, and the XST path:
``preprocessing`` (flat-field with bad-pixel repair, kernel K2 in
``ops/cuda_median.py`` + ``csrc/median3x3.cu``), ``signal`` (dense
tracking, kernel K3 in ``ops/cuda_densetrack.py`` +
``csrc/densetrack_sums.cu``), ``maths`` and ``models``. See ROADMAP.md.
"""
from . import config
from .metrics import distribution_moments, speckle_stack_stats, speckle_stats

__all__ = ["config", "distribution_moments", "speckle_stack_stats", "speckle_stats"]
