# SPDX-License-Identifier: CECILL-2.1
"""PyTorch/CUDA port of barc4dip_tpu.

The JAX package ``barc4dip_tpu`` is the reference; this package keeps its
module names and result dicts and runs on an NVIDIA GPU, with hand-written
CUDA kernels where the JAX package has Pallas kernels. It imports torch and
numpy, never jax.

Every module of the JAX package is ported but the TPU workarounds
(``ops/mxufft.py``, ``ops/uploadcache.py``; ROADMAP "Not to port"): the
speckle API (``speckle_stats`` and its standalone
estimators, ``distribution_moments``, ``speckle_stack_stats`` with every
option: lazy grain maps, tensor stacks, windowed and phase tracking,
checkpoints, and ``mesh=``, frame-axis data parallelism over devices
through ``parallel``) with kernel K1 (``ops/cuda_fftp.py`` +
``csrc/fftp_corr.cu``), ``models.full_step_fn``, and the XST path:
``preprocessing`` (flat-field with bad-pixel repair, kernel K2 in
``ops/cuda_median.py`` + ``csrc/median3x3.cu``), ``signal`` (dense
tracking, kernel K3 in ``ops/cuda_densetrack.py`` +
``csrc/densetrack_sums.cu``), ``maths`` and ``models``; and the sharpness
API (``sharpness_stats``, ``sharpness_stack_stats``, the five standalone
estimators, ``models.SharpnessScanPipeline``), whose autocorrelation group
runs kernel K1a and whose eigenvalue group's dense solves run kernel K4
(``ops/cuda_symeig.py`` + ``csrc/symeig_tridiag.cu``), with
``report.logbook_report``; and the way in and out:
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
``flat_field_correction``, with ``barc4dip-cuda-batch --register``; and ``plotting``, host matplotlib,
imported on first use so that importing the package never imports
matplotlib. Kernel
K1 takes every H and W that are multiples of 128 up to 8192, as the TPU
kernel does. Every module exports every name of its JAX counterpart's
``__all__`` (``ops``, ``utils`` and ``config`` included), but the JAX
backend probes of ``config``; ``metrics.stack_fused`` keeps the stack
loop's per-stage record (``LAST_RUN_PERF``) and its compute probe
(``device_compute_probe``).

Work runs on the card: ``device=None`` means cuda and raises where no card
is available; ``device="cpu"`` (``--device cpu``) asks for the CPU.
"""
import importlib as _importlib

from . import config, geometry, maths, metrics, parallel, signal, utils
from ._version import __version__
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
    "__version__",
    "config",
    "distribution_moments",
    "geometry",
    "io",
    "logbook_report",
    "maths",
    "metrics",
    "models",
    "ops",
    "parallel",
    "plotting",
    "preprocessing",
    "read_image",
    "report",
    "sharpness_stack_stats",
    "sharpness_stats",
    "signal",
    "speckle_stack_stats",
    "speckle_stats",
    "utils",
    "write_image",
]


# imported on first use, as in the JAX package; plotting needs matplotlib,
# which a machine that only computes may lack
_LAZY_SUBMODULES = ("io", "models", "ops", "plotting", "preprocessing", "report")


def __getattr__(name: str):
    if name in _LAZY_SUBMODULES:
        return _importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
