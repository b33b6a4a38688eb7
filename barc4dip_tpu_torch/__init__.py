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
``csrc/densetrack_sums.cu``), ``maths`` and ``models``; and the sharpness
API (``sharpness_stats``, ``sharpness_stack_stats``, the five standalone
estimators, ``models.SharpnessScanPipeline``), whose autocorrelation group
runs kernel K1a, with ``report.logbook_report``; and the way in and out:
``io`` (``read_image`` / ``write_image``, the EDF, TIFF and HDF5 readers and
writers, the native C++ codec of ``native/dipio.cpp``), the pipelines'
``run_files`` / ``run_edf_files`` / ``run_hdf5``, the console scripts
``barc4dip-cuda-speckles`` (``report/cli.py``) and ``barc4dip-cuda-batch``
(``report/batch_cli.py``), and ``utils/profiling.py``; and the signal layer
(``signal.fft``, ``signal.corr``, ``signal.tracking``, ``signal.summary``
with ``pull_centrosymmetric``; ``autocorr2d``, ``spectral_summary`` and
``template_matching`` run kernel K1a), ``maths.radial`` / ``maths.stats``,
the ``geometry`` helpers, and the metric extensions ``visibility_map``,
``fourier_ring_correlation``, ``psnr`` / ``ssim`` / ``ms_ssim``; and the
rest of preprocessing: ``preprocessing.deconvolve_psf`` (Wiener,
Richardson-Lucy, unsupervised Wiener), ``clahe``, ``correct_distortion`` /
``distortion_map`` and ``register_stack`` / ``shift_stack`` beside
``flat_field_correction``, with ``barc4dip-cuda-batch --register``. Kernel
K1 takes every H and W that are multiples of 128 up to 8192, as the TPU
kernel does. The namespaces ``geometry``, ``maths``, ``signal``,
``metrics`` and ``preprocessing`` export every name the JAX package's do.

Work runs on the card: ``device=None`` means cuda and raises where no card
is available; ``device="cpu"`` (``--device cpu``) asks for the CPU. See
ROADMAP.md for what is still to port.
"""
from . import config, geometry, maths, metrics, signal, utils
from .io import read_image, write_image
from .metrics import (
    distribution_moments,
    sharpness_stack_stats,
    sharpness_stats,
    speckle_stack_stats,
    speckle_stats,
)
from .report import logbook_report

__all__ = [
    "config",
    "distribution_moments",
    "geometry",
    "logbook_report",
    "maths",
    "metrics",
    "read_image",
    "sharpness_stack_stats",
    "sharpness_stats",
    "signal",
    "speckle_stack_stats",
    "speckle_stats",
    "utils",
    "write_image",
]
