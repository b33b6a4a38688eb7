# SPDX-License-Identifier: CECILL-2.1
"""Zero-normalised cross-correlation for template tracking (counterpart of
``barc4dip_tpu/ops/ncc.py``).

    ncc[u, v] = sum_w (I_w - mean(I_w)) (T - mean(T))
                / sqrt(sum_w (I_w - mean(I_w))^2 * sum (T - mean(T))^2)

The numerator is one circular FFT correlation per template; per-window
variance sums come from integral images. Images are z-scored first, which
leaves NCC unchanged and keeps float32 well-conditioned. The bank call goes
through kernel K1's NCC variant on CUDA (``cuda_fftp.ncc_masked_peaks``).

Images are (..., H, W) batches; templates (..., h, w).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_fftp
from .momentscore import nanmean2d, nanstd2d

__all__ = [
    "ncc_bank_masked_peaks",
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
    window variance sums."""
    m = nanmean2d(image)[..., None, None]
    s = nanstd2d(image)[..., None, None]
    img = (image - m) / (s + eps)
    s1 = window_sums(img, h, w)
    s2 = window_sums(img * img, h, w)
    # sum over a window of (I - mean_w)^2 = S2 - S1^2/A; clamp tiny negatives
    var_sum = torch.clamp_min(s2 - (s1 * s1) / float(h * w), 0.0)
    return {
        "s1": s1, "var_sum": var_sum, "F": torch.fft.rfft2(img),
        "shape": tuple(image.shape[-2:]), "hw": (h, w),
    }


def prep_template(template, H: int, W: int):
    """A template's mean-removed spectrum, zero-padded to (H, W), and its
    energy: {"Ft": (..., H, W//2+1), "energy": (...)}."""
    h, w = template.shape[-2], template.shape[-1]
    t = template - template.mean(dim=(-2, -1), keepdim=True)
    return {
        "Ft": torch.fft.rfft2(F.pad(t, (0, W - w, 0, H - h))),
        "energy": (t * t).sum(dim=(-2, -1)),
    }


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
