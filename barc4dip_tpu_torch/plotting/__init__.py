# SPDX-License-Identifier: CECILL-2.1
"""Host-side matplotlib visualization (images, spectra, stacks, styles):
the port's own copy of ``barc4dip_tpu/plotting``. Every array argument may
be a numpy array, a CPU or CUDA tensor, or a lazy map
(:mod:`..utils.lazy`); each is brought to the host once, where the call
takes it."""
from .image import plt_histogram, plt_image, plt_tiles_metric
from .spectral import plt_radial_waterfall, plt_spectrum1d, plt_spectrum2d
from .stack import (
    plt_displacement,
    plt_displacement_field,
    plt_stack_metric,
    plt_tiles_metric_stack,
)
from .style import (
    close,
    igor_cmap,
    savefig,
    scan_cmap,
    show,
    srw_cmap,
    start_plotting,
)

__all__ = [
    "plt_image",
    "plt_tiles_metric",
    "plt_histogram",
    "plt_spectrum1d",
    "plt_radial_waterfall",
    "plt_spectrum2d",
    "plt_displacement",
    "plt_displacement_field",
    "plt_stack_metric",
    "plt_tiles_metric_stack",
    "start_plotting",
    "show",
    "savefig",
    "close",
    "srw_cmap",
    "igor_cmap",
    "scan_cmap",
]
