# SPDX-License-Identifier: CECILL-2.1
"""Zero-normalised cross-correlation for template tracking (counterpart of
``barc4dip_tpu/ops/ncc.py``).

    ncc[u, v] = sum_w (I_w - mean(I_w)) (T - mean(T))
                / sqrt(sum_w (I_w - mean(I_w))^2 * sum (T - mean(T))^2)

The numerator is one circular FFT correlation per template; per-window
variance sums come from integral images. Images are z-scored first, which
leaves NCC unchanged and keeps float32 well-conditioned. The masked bank
call goes through kernel K1's NCC variant on CUDA
(``cuda_fftp.ncc_masked_peaks``, K1b); the valid and full-masked maps go
through its correlation (``cuda_fftp.corr_from_rfft``, K1a), as the JAX
package's go through ``pallas_fftp.corr_from_spectra``.

Images are (..., H, W) batches; templates (..., h, w). Where the JAX
functions take one image and one template (and are vmapped over banks),
these take the bank layout of ``cuda_fftp``: image spectra (H, Wh) or
(NF, H, Wh), template spectra (K, H, Wh) shared by every image or
(NF, K, H, Wh) one bank per image, maps (K, ...) or (NF, K, ...).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.profiling import annotate
from . import cuda_fftp
from .phasecorr import zscore2d

__all__ = [
    "ncc_bank_masked_from_preps",
    "ncc_bank_masked_peaks",
    "ncc_full_masked_from_preps",
    "ncc_valid",
    "ncc_valid_from_prepared",
    "ncc_valid_from_preps",
    "prep_template",
    "window_sums",
    "zncc_prepare_image",
]


def window_sums(image, h: int, w: int):
    """Sums over every (h, w) window (valid mode) from a zero-padded
    integral image: shape (..., H-h+1, W-w+1)."""
    ii = F.pad(image.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    return ii[..., h:, w:] - ii[..., :-h, w:] - ii[..., h:, :-w] + ii[..., :-h, :-w]


def zncc_prepare_image(image, h: int, w: int, *, eps: float = 1e-9):
    """Image-side quantities shared by every (h, w) template: the rfft2
    spectrum of the z-scored image (NaN-aware mean/std), window sums and
    window variance sums. The spectrum is made contiguous, as kernel K1 takes
    it: ``rfft2`` of a single 2-D image comes back strided on CUDA."""
    img = zscore2d(image, eps=eps)
    s1 = window_sums(img, h, w)
    s2 = window_sums(img * img, h, w)
    # sum over a window of (I - mean_w)^2 = S2 - S1^2/A; clamp tiny negatives
    var_sum = torch.clamp_min(s2 - (s1 * s1) / float(h * w), 0.0)
    return {
        "s1": s1, "var_sum": var_sum, "F": torch.fft.rfft2(img).contiguous(),
        "shape": tuple(image.shape[-2:]), "hw": (h, w),
    }


def prep_template(template, H: int, W: int):
    """A template's mean-removed spectrum, zero-padded to (H, W), and its
    energy: {"Ft": (..., H, W//2+1), "energy": (...)}."""
    h, w = template.shape[-2], template.shape[-1]
    t = template - template.mean(dim=(-2, -1), keepdim=True)
    return {
        "Ft": torch.fft.rfft2(F.pad(t, (0, W - w, 0, H - h))).contiguous(),
        "energy": (t * t).sum(dim=(-2, -1)),
    }


def _divide(corr, var_sum, energy, eps: float):
    """corr / sqrt(var * energy) in the bank layout, 0 where that is <= eps."""
    denom = torch.sqrt(var_sum.unsqueeze(-3) * energy[..., None, None])
    safe = denom > eps
    return torch.where(safe, corr / torch.where(safe, denom, 1.0), 0.0)


def ncc_valid_from_preps(img_prep, tpl_prep, *, eps: float = 1e-9):
    """NCC valid maps (..., H-h+1, W-w+1) of prepared images against
    prepared templates (bank layout, module docstring).

    The correlation runs through ``cuda_fftp.corr_from_rfft``: kernel K1a on
    CUDA for the sides it covers. The windowed search's windows have odd
    sides (s + 2r, s odd), which neither K1 nor the TPU kernel covers: they
    take the plain ``irfft2`` in both packages by design, and on CUDA they
    are counted in ``cuda_fftp.PLAIN_BY_SHAPE``."""
    H, W = img_prep["shape"]
    h, w = img_prep["hw"]
    corr = cuda_fftp.corr_from_rfft(img_prep["F"], tpl_prep["Ft"], s=(H, W))
    numer = corr[..., : H - h + 1, : W - w + 1]
    return _divide(numer, img_prep["var_sum"], tpl_prep["energy"], eps)


def ncc_full_masked_from_preps(img_prep, tpl_prep, *, eps: float = 1e-9):
    """Full-frame NCC maps (..., H, W) for peak finding: the valid cells
    carry :func:`ncc_valid_from_preps`'s values, the circular-wrap region
    (row >= Vh or column >= Vw) reads -inf. Returns (maps, (Vh, Vw))."""
    H, W = img_prep["shape"]
    h, w = img_prep["hw"]
    Vh, Vw = H - h + 1, W - w + 1
    corr = cuda_fftp.corr_from_rfft(img_prep["F"], tpl_prep["Ft"], s=(H, W))
    var_full = F.pad(img_prep["var_sum"], (0, w - 1, 0, h - 1))
    ncc = _divide(corr, var_full, tpl_prep["energy"], eps)
    dev = ncc.device
    valid = (torch.arange(H, device=dev) < Vh)[:, None] & (torch.arange(W, device=dev) < Vw)[None, :]
    return torch.where(valid, ncc, -math.inf), (Vh, Vw)


def ncc_bank_masked_from_preps(img_prep, tpl_bank, *, eps: float = 1e-9):
    """Masked full-frame NCC maps of a template bank: (maps, (Vh, Vw)).
    See :func:`ncc_bank_masked_peaks`."""
    maps, _iy, _ix, vb = ncc_bank_masked_peaks(img_prep, tpl_bank, eps=eps)
    return maps, vb


@annotate("k1.ncc")
def ncc_bank_masked_peaks(img_prep, tpl_bank, *, eps: float = 1e-9):
    """Full-frame NCC maps and integer peaks of a template bank against
    prepared images.

    The circular-wrap region (row >= Vh or column >= Vw, beyond the valid
    (H-h+1, W-w+1) window) reads -inf; degenerate denominators read 0.
    ``tpl_bank["Ft"]`` is (K, H, Wh), shared by every image, or
    (NF, K, H, Wh), one bank per image. Returns (maps, iy, ix, (Vh, Vw))
    with (iy, ix) the row-major first-occurrence argmax of each map."""
    H, W = img_prep["shape"]
    h, w = img_prep["hw"]
    Vh, Vw = H - h + 1, W - w + 1
    var_full = F.pad(img_prep["var_sum"], (0, w - 1, 0, h - 1))
    maps, iy, ix = cuda_fftp.ncc_masked_peaks(
        img_prep["F"], tpl_bank["Ft"], var_full, tpl_bank["energy"],
        valid_hw=(Vh, Vw), eps=eps, s=(H, W),
    )
    return maps, iy, ix, (Vh, Vw)


def ncc_valid_from_prepared(prep, template, *, eps: float = 1e-9):
    """NCC valid maps of raw templates, (K, h, w) or (NF, K, h, w), against
    prepared images."""
    H, W = prep["shape"]
    return ncc_valid_from_preps(prep, prep_template(template, int(H), int(W)), eps=eps)


def ncc_valid(image, template, *, eps: float = 1e-9):
    """NCC valid-mode map of one (h, w) template over one (H, W) image:
    shape (H-h+1, W-w+1)."""
    h, w = template.shape[-2], template.shape[-1]
    prep = zncc_prepare_image(image, int(h), int(w), eps=eps)
    return ncc_valid_from_prepared(prep, template[None], eps=eps)[0]
