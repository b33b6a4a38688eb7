# SPDX-License-Identifier: CECILL-2.1
"""Translation tracking of a template ROI inside a full frame (counterpart
of ``barc4dip_tpu/signal/tracking.py``):

- string-keyed tracker registry dispatched by :func:`track_translation`;
- ``template_matching``: normalized cross-correlation peak + optional Taylor
  subpixel refinement, NumPy convention (+dy down, +dx right), returning
  ``(dy, dx, peak, snr)`` with ``snr = |peak| / median|corr|``;
- ``phase_correlation``: whitened cross-power spectrum of the z-scored frame
  vs the zero-embedded z-scored template.

Both the "opencv" and "skimage" template backends evaluate the same
zero-normalised cross-correlation (``ops/ncc.ncc_valid``): one FFT
correlation through kernel K1a on CUDA (``ops/cuda_fftp.corr_from_rfft``,
one image spectrum against one zero-padded template spectrum) plus
integral-image window sums. The phase paths run ``torch.fft`` and launch no
kernel; the "skimage" phase backend is the upsampled-DFT registration of
``ops/upsampled_dft.py`` (peak/snr returned as NaN). The Taylor subpixel step
defaults to the Newton solve; ``subpixel_convention="reference"`` gives the
swapped-component variant.

The functions return Python floats, pulled from the device in one transfer
a call. A numpy input computes on ``device`` (``None``: the card, and an
error without one), a tensor on its own device. The batched stack tracker
lives in :mod:`barc4dip_tpu_torch.metrics.stack_fused`.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..config import device_arrays
from ..ops import ncc as ncc_ops
from ..ops import phasecorr as pc_ops
from ..ops.upsampled_dft import phase_cross_correlation_upsampled

__all__ = ["track_translation", "template_matching", "phase_correlation"]

_Tracker = Callable[..., tuple[float, float, float, float]]
_TRACKERS: dict[str, _Tracker] = {}


def _centered_slices(H: int, W: int, h: int, w: int) -> tuple[slice, slice]:
    """Default reference position: the template centred in the image.

    Equivalent to geometry.roi_slices around the image centre for odd
    sizes, but also valid for EVEN templates (roi_slices enforces its own
    odd-symmetry invariant, which is not a tracker limitation:
    power-of-two templates are common)."""
    y0 = (H - h) // 2
    x0 = (W - w) // 2
    return slice(y0, y0 + h), slice(x0, x0 + w)


def _register(method: str) -> Callable[[_Tracker], _Tracker]:
    method_norm = method.strip().lower()

    def _decorator(fn: _Tracker) -> _Tracker:
        _TRACKERS[method_norm] = fn
        return fn

    return _decorator


def track_translation(
    template,
    image,
    *,
    slices_yx: tuple[slice, slice] | None = None,
    method: str = "phase",
    backend: str = "internal",
    subpixel: bool = True,
    eps: float = 1e-9,
    device=None,
) -> tuple[float, float, float, float]:
    """Dispatch a registered tracking method. Returns (dy, dx, peak, snr)."""
    method_norm = method.strip().lower()
    fn = _TRACKERS.get(method_norm)
    if fn is None:
        supported = ", ".join(sorted(_TRACKERS))
        raise ValueError(
            f"Unsupported tracking method: {method!r}. Supported: {supported}"
        )
    return fn(
        template, image, slices_yx=slices_yx, backend=backend, subpixel=subpixel, eps=eps,
        device=device,
    )


def _as_float2d_pair(template, image, device):
    """Template and image as 2-D tensors on one device, each in its compute
    dtype (float64 stays, everything else computes in float32)."""
    tpl, img = device_arrays(template, image, device=device)
    for a, name in ((tpl, "template"), (img, "image")):
        if a.dim() != 2:
            raise ValueError(f"{name} must be a 2D array.")
    if tpl.is_complex():
        tpl = tpl.real.to(torch.float32)
    if img.is_complex():
        img = img.real.to(torch.float32)
    return tpl, img


def _pull(*scalars) -> list[float]:
    """0-d tensors as Python floats in one transfer."""
    return torch.stack([s.to(scalars[0].dtype) for s in scalars]).tolist()


@_register("template")
def template_matching(
    template,
    image,
    *,
    slices_yx: tuple[slice, slice] | None = None,
    backend: str = "opencv",
    subpixel: bool = True,
    eps: float = 1e-9,
    subpixel_convention: str = "newton",
    device=None,
) -> tuple[float, float, float, float]:
    """Estimate (dy, dx) by normalized cross-correlation template matching.

    ``backend`` accepts "internal", "opencv" or "skimage" for API parity;
    all resolve to the same NCC map.
    """
    tpl, img = _as_float2d_pair(template, image, device)

    H, W = (int(s) for s in img.shape)
    h, w = (int(s) for s in tpl.shape)
    if h > H or w > W:
        raise ValueError(f"template shape {(h, w)} must fit inside image shape {(H, W)}")
    # "internal" (the dispatcher's default) resolves to the same NCC map as
    # the two reference backends: method="template" must work through
    # track_translation without an explicit backend
    if backend not in ("opencv", "skimage", "internal"):
        raise ValueError("backend must be 'internal', 'opencv' or 'skimage'.")

    if slices_yx is None:
        slices_yx = _centered_slices(H, W, h, w)
    sy_ref, sx_ref = slices_yx
    y0 = (sy_ref.start + sy_ref.stop - 1) / 2.0
    x0 = (sx_ref.start + sx_ref.stop - 1) / 2.0

    dtype = torch.promote_types(img.dtype, tpl.dtype)
    corr = ncc_ops.ncc_valid(img.to(dtype), tpl.to(dtype), eps=float(eps))
    i, j = pc_ops.argmax2d(corr)
    peak, snr = pc_ops.peak_quality(corr, i, j, eps=float(eps))
    py = i.to(corr.dtype)
    px = j.to(corr.dtype)
    if subpixel:
        di, dj = pc_ops.subpixel_taylor(corr, i, j, convention=str(subpixel_convention))
        py = py + di
        px = px + dj
    py, px, peak, snr = _pull(py, px, peak, snr)

    y_match = py + (h - 1) / 2.0
    x_match = px + (w - 1) / 2.0
    return float(y_match - y0), float(x_match - x0), float(peak), float(snr)


def _embedded_pair(img, tpl, slices_yx, eps: float):
    """The z-scored image and the z-scored template zero-embedded at
    ``slices_yx``. The template is rounded through float32 before the pad,
    also for a float64 image, as the JAX package does."""
    H, W = img.shape
    sy, sx = slices_yx
    img_z = pc_ops.zscore2d(img, eps=eps)
    tpl_z = pc_ops.zscore2d(tpl, eps=eps).to(torch.float32)
    tpl_pad = F.pad(tpl_z, (sx.start, W - sx.stop, sy.start, H - sy.stop)).to(img_z.dtype)
    return img_z, tpl_pad


@_register("phase")
def phase_correlation(
    template,
    image,
    *,
    slices_yx: tuple[slice, slice] | None = None,
    backend: str = "internal",
    subpixel: bool = True,
    eps: float = 1e-9,
    subpixel_convention: str = "newton",
    device=None,
) -> tuple[float, float, float, float]:
    """Estimate (dy, dx) by phase correlation of a template ROI vs a frame.

    backend="internal": whitened cross-power spectrum + optional Taylor
    refinement. backend="skimage": upsampled-DFT registration (upsample 10
    when ``subpixel``), peak/snr returned as NaN.
    """
    tpl, img = _as_float2d_pair(template, image, device)

    H, W = (int(s) for s in img.shape)
    h, w = (int(s) for s in tpl.shape)

    if slices_yx is None:
        slices_yx = _centered_slices(H, W, h, w)

    if backend == "skimage":
        img_z, tpl_pad = _embedded_pair(img, tpl, slices_yx, float(eps))
        dy, dx = phase_cross_correlation_upsampled(
            img_z, tpl_pad, upsample_factor=10 if subpixel else 1
        )
        dy, dx = _pull(dy, dx)
        return float(dy), float(dx), float("nan"), float("nan")

    if backend != "internal":
        raise ValueError("backend must be 'internal' or 'skimage'.")

    img_z, tpl_pad = _embedded_pair(img, tpl, slices_yx, float(eps))
    mag = pc_ops.phase_corr_surface(img_z, tpl_pad, eps=float(eps))
    i, j = pc_ops.argmax2d(mag)
    peak, snr = pc_ops.peak_quality(mag, i, j, eps=float(eps))
    dy = (i - H // 2).to(mag.dtype)
    dx = (j - W // 2).to(mag.dtype)
    if subpixel:
        di, dj = pc_ops.subpixel_taylor(mag, i, j, convention=str(subpixel_convention))
        dy = dy + di
        dx = dx + dj
    dy, dx, peak, snr = _pull(dy, dx, peak, snr)
    return float(dy), float(dx), float(peak), float(snr)
