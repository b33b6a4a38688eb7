# SPDX-License-Identifier: CECILL-2.1
"""Port parity: each primitive of ``barc4dip_tpu_torch.ops`` against its JAX
counterpart on the same float64 inputs (CPU), at rtol 1e-9 unless stated.

The port's functions take (..., H, W) batches; the JAX ones one image at a
time, so several cases run a batch of two through the port and compare it
image by image.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barc4dip_tpu.ops import corrcore as j_corr
from barc4dip_tpu.ops import fftcore as j_fft
from barc4dip_tpu.ops import momentscore as j_mom
from barc4dip_tpu.ops import ncc as j_ncc
from barc4dip_tpu.ops import phasecorr as j_pc
from barc4dip_tpu.ops import quantile as j_q
from barc4dip_tpu.ops import radialcore as j_rad
from barc4dip_tpu.ops import widths as j_w
from barc4dip_tpu_torch.ops import corrcore as t_corr
from barc4dip_tpu_torch.ops import fftcore as t_fft
from barc4dip_tpu_torch.ops import momentscore as t_mom
from barc4dip_tpu_torch.ops import ncc as t_ncc
from barc4dip_tpu_torch.ops import phasecorr as t_pc
from barc4dip_tpu_torch.ops import quantile as t_q
from barc4dip_tpu_torch.ops import radialcore as t_rad
from barc4dip_tpu_torch.ops import widths as t_w
from tests.conftest import make_speckle

torch.set_num_threads(2)
RTOL = 1e-9


def close(got, ref, rtol=RTOL):
    """Equal finiteness, values within rtol of the reference's scale."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])  # same inf signs / NaNs
    if fin.any():
        np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol,
                                   atol=rtol * np.abs(ref[fin]).max())


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", [(96, 96), (80, 96), (75, 64)])
def test_autocorr2d_core(rng, shape):
    imgs = np.stack([make_speckle(rng, shape=shape, grain_px=4.0) for _ in range(2)])
    got = t_corr.autocorr2d_core(t(imgs)).numpy()
    for k in range(2):
        close(got[k], j_corr.autocorr2d_core(jnp.asarray(imgs[k])))


@pytest.mark.parametrize("shape", [(64, 64), (48, 63), (57, 40)])
def test_psd2d_core(rng, shape):
    img = rng.normal(size=shape)
    close(t_fft.psd2d_core(t(img)), j_fft.psd2d_core(jnp.asarray(img)))


def test_nanpercentiles_exact_with_nan_and_inf(rng):
    x = rng.normal(size=(2, 40, 50))
    x[0, :3, :7] = np.nan
    x[0, 10, 10] = np.inf
    x[0, 11, 11] = -np.inf
    x[1, 5, :] = np.inf
    ps = (0.0, 0.05, 25.0, 50.0, 99.95, 100.0)
    got = t_q.nanpercentiles_exact(t(x), ps).numpy()
    for k in range(2):
        ref = np.asarray(j_q.nanpercentiles_exact(jnp.asarray(x[k]), ps))
        np.testing.assert_array_equal(got[k], ref)


def test_nanpercentiles_exact_all_nan_and_integer_range(rng):
    ints = rng.integers(0, 65536, size=(30, 30)).astype(np.float32)
    ps = (0.05, 99.95)
    got = t_q.nanpercentiles_exact(t(ints), ps, integer_range=(0, 65535)).numpy()
    ref = np.asarray(j_q.nanpercentiles_exact(jnp.asarray(ints), ps, integer_range=(0, 65535)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, t_q.nanpercentiles_exact(t(ints), ps).numpy())
    nan = np.full((4, 4), np.nan)
    assert np.isnan(t_q.nanpercentiles_exact(t(nan), ps).numpy()).all()
    with pytest.raises(ValueError):
        t_q.nanpercentiles_exact(t(ints), ps, integer_range=(0, 1 << 25))


def _profiles(rng):
    n = 61
    x = np.arange(n) - 30.0
    base = np.exp(-(x / 6.0) ** 2)
    profs = np.stack([
        base + 0.01 * rng.normal(size=n),
        np.roll(base, 9),
        np.ones(n),                      # never crosses: edge fallback
        np.r_[base[:40], np.ones(21)],   # no right crossing
    ])
    return profs


def test_width_at_fraction_core(rng):
    profs = _profiles(rng)
    frac = 1.0 / np.e
    got, hit = t_w.width_at_fraction_core(t(profs), fraction=frac)
    centers = torch.tensor([30, 39, 5, 30])
    got_c, hit_c = t_w.width_at_fraction_core(t(profs), fraction=frac, center_index=centers)
    for k in range(len(profs)):
        ref, ref_hit = j_w.width_at_fraction_core(jnp.asarray(profs[k]), fraction=frac)
        close(got[k], ref)
        assert bool(hit[k]) == bool(ref_hit)
        ref, ref_hit = j_w.width_at_fraction_core(
            jnp.asarray(profs[k]), fraction=frac, center_index=int(centers[k])
        )
        close(got_c[k], ref)
        assert bool(hit_c[k]) == bool(ref_hit)


def test_distance_at_fraction_core(rng):
    profs = _profiles(rng)[:, 30:]
    profs = np.concatenate([profs, -profs[:1]])  # below threshold at the peak
    for peak in (0, 3):
        got, hit = t_w.distance_at_fraction_core(t(profs), fraction=0.5, peak_index=peak)
        for k in range(len(profs)):
            ref, ref_hit = j_w.distance_at_fraction_core(
                jnp.asarray(profs[k]), fraction=0.5, peak_index=peak
            )
            close(got[k], ref)
            assert bool(hit[k]) == bool(ref_hit)


@pytest.mark.parametrize("centrosymmetric", [False, True])
@pytest.mark.parametrize("shape", [(64, 64), (65, 65)])
def test_radial_mean_interpolated_core(rng, centrosymmetric, shape):
    maps = np.stack([
        np.asarray(j_corr.autocorr2d_core(jnp.asarray(make_speckle(rng, shape=shape, grain_px=4.0))))
        for _ in range(2)
    ])
    got, r = t_rad.radial_mean_interpolated_core(t(maps), centrosymmetric=centrosymmetric)
    for k in range(2):
        ref, ref_r = j_rad.radial_mean_interpolated_core(
            jnp.asarray(maps[k]), centrosymmetric=centrosymmetric
        )
        close(got[k], ref)
        close(r, ref_r)


def test_radial_mean_binned_core(rng):
    m = rng.normal(size=(64, 64))
    got, r = t_rad.radial_mean_binned_core(t(m), bin_size=1.5)
    ref, ref_r = j_rad.radial_mean_binned_core(jnp.asarray(m), bin_size=1.5)
    close(got, ref)
    close(r, ref_r)


def test_distribution_moments_core(rng):
    x = np.abs(rng.normal(1000.0, 300.0, size=(2, 50, 40)))
    x[0, 0, :5] = np.nan
    x[0, 1, 0] = np.inf
    x[0, 2, :3] = 0.0
    x[1, 3, :4] = 65535.0
    got = t_mom.distribution_moments_core(t(x), saturation_value=65535.0, eps=1e-6)
    for k in range(2):
        ref = j_mom.distribution_moments_core(jnp.asarray(x[k]), saturation_value=65535.0, eps=1e-6)
        for key, v in ref.items():
            close(got[key][k], v)
    const = np.full((8, 8), 3.0)
    got = t_mom.distribution_moments_core(t(const), saturation_value=None)
    ref = j_mom.distribution_moments_core(jnp.asarray(const), saturation_value=None)
    for key, v in ref.items():
        close(got[key], v)


def test_window_sums(rng):
    img = rng.normal(size=(40, 36))
    close(t_ncc.window_sums(t(img), 7, 5), j_ncc.window_sums(jnp.asarray(img), 7, 5))


def test_zncc_prepare_image(rng):
    imgs = rng.normal(5.0, 2.0, size=(2, 64, 48))
    imgs[1, 3, 4] = np.nan
    got = t_ncc.zncc_prepare_image(t(imgs), 9, 7)
    assert got["shape"] == (64, 48) and got["hw"] == (9, 7)
    for k in range(2):
        ref = j_ncc.zncc_prepare_image(jnp.asarray(imgs[k]), 9, 7)
        close(got["s1"][k], ref["s1"])
        close(got["var_sum"][k], ref["var_sum"])
        if k == 0:  # the spectrum of an image holding NaN is not defined
            close(got["F"][k].real, jnp.real(ref["F"]))
            close(got["F"][k].imag, jnp.imag(ref["F"]))


@pytest.mark.parametrize("convention", ["newton", "reference"])
def test_subpixel_taylor(rng, convention):
    maps = rng.normal(size=(5, 30, 30))
    ii = torch.tensor([12, 0, 29, 19, 8])
    jj = torch.tensor([7, 4, 10, 20, 19])
    for bounds in (None, (20, 20)):
        di, dj = t_pc.subpixel_taylor(t(maps), ii, jj, convention=convention, bounds=bounds)
        for k in range(5):
            rdi, rdj = j_pc.subpixel_taylor(
                jnp.asarray(maps[k]), int(ii[k]), int(jj[k]), convention=convention, bounds=bounds
            )
            close(di[k], rdi)
            close(dj[k], rdj)
    with pytest.raises(ValueError):
        t_pc.subpixel_taylor(t(maps), ii, jj, convention="swap")


def test_argmax2d_first_occurrence(rng):
    m = rng.normal(size=(3, 20, 25))
    m[0, 4, 7] = m[0, 4, 9] = m[0, 11, 2] = 50.0   # ties: first in row-major order
    m[1, 6, 3] = np.nan                            # NaN ranks highest
    m[1, 9, 1] = np.nan
    m[2, :, :] = -np.inf
    i, j = t_pc.argmax2d(t(m))
    for k in range(3):
        ri, rj = j_pc.argmax2d(jnp.asarray(m[k]))
        assert (int(i[k]), int(j[k])) == (int(ri), int(rj))
    assert (int(i[0]), int(j[0])) == (4, 7)


def _ncc_case(rng, H=64, W=56, h=9, w=7):
    imgs = np.stack([make_speckle(rng, shape=(H, W), grain_px=3.0) for _ in range(2)])
    tpls = np.stack([imgs[0, 5 : 5 + h, 8 : 8 + w], imgs[1, 20 : 20 + h, 3 : 3 + w], np.ones((h, w))])
    return imgs, tpls


def test_ncc_valid_and_masked_maps(rng):
    """The valid and full-masked NCC maps (through cuda_fftp.corr_from_rfft)
    against the JAX functions, template by template, in both bank layouts;
    the flat template's zero-energy maps read 0."""
    imgs, tpls = _ncc_case(rng)
    h, w = tpls.shape[-2:]
    prep = t_ncc.zncc_prepare_image(t(imgs), h, w)
    shared = t_ncc.prep_template(t(tpls), 64, 56)
    per_image = t_ncc.prep_template(t(np.stack([tpls, tpls[::-1]])), 64, 56)
    valid = {"shared": t_ncc.ncc_valid_from_preps(prep, shared),
             "per_image": t_ncc.ncc_valid_from_prepared(prep, t(np.stack([tpls, tpls[::-1]])))}
    masked, vb = t_ncc.ncc_full_masked_from_preps(prep, per_image)
    bank, bvb = t_ncc.ncc_bank_masked_from_preps(prep, shared)
    assert vb == bvb == (64 - h + 1, 56 - w + 1)
    for f in range(2):
        jprep = j_ncc.zncc_prepare_image(jnp.asarray(imgs[f]), h, w)
        for k in range(3):
            own = k if f == 0 else 2 - k  # image 1's bank is reversed
            for layout, kk in (("shared", k), ("per_image", own)):
                jt = j_ncc.prep_template(jnp.asarray(tpls[kk]), 64, 56)
                close(valid[layout][f, k], j_ncc.ncc_valid_from_preps(jprep, jt))
            jt = j_ncc.prep_template(jnp.asarray(tpls[own]), 64, 56)
            close(masked[f, k], j_ncc.ncc_full_masked_from_preps(jprep, jt)[0])
            close(bank[f, k], j_ncc.ncc_full_masked_from_preps(
                jprep, j_ncc.prep_template(jnp.asarray(tpls[k]), 64, 56))[0])
        close(t_ncc.ncc_valid(t(imgs[f]), t(tpls[f])),
              j_ncc.ncc_valid(jnp.asarray(imgs[f]), jnp.asarray(tpls[f])))
    assert float(valid["shared"][:, 2].abs().max()) == 0.0


def test_phase_corr_surface_zscore_and_peak_quality(rng):
    """``zscore2d`` (one frame holding a NaN), the phase-correlation
    surface, ``argmax2d`` and ``peak_quality`` against the JAX package.

    The whitening ``prod / (|prod| + eps)`` and the inverse transform are
    held apart, because whitening is ill-conditioned where ``|prod|`` is
    round-off: a z-scored image has a DC bin of ~1e-13, so ``|prod|`` there
    is ~1e-7 against >= 1 elsewhere, and whitening scales the FFT library's
    round-off in that bin up to order 1e-4 of a unit bin.

    - On the same spectra (numpy's, given to both sides) both packages
      whiten identical numbers and only the inverse differs: rtol 1e-9.
      The JAX side is the package's own formula (``phasecorr.py``, the rfft2
      branch of ``phase_corr_surface``), which has no entry point that takes
      spectra.
    - End to end each package transforms with its own FFT library. The
      inverse is linear, so a difference ``d_k`` between the two whitened
      spectra in bin k moves every pixel of the surface by at most
      ``m_k * |d_k| / (H * W)``, where ``m_k`` is 1 for a bin of the
      half-spectrum that is its own Hermitian mirror (columns 0 and W/2)
      and 2 otherwise, and ``abs`` does not widen it. The test measures
      ``d_k`` over the ill-conditioned bins (``|prod| < 1e3 * eps``; here
      the DC bin alone) and allows their sum, beside rtol 1e-9 of the peak
      for every other bin. ``peak`` is held to the same bound; ``snr =
      |peak| / (median + eps)`` to its first-order propagation through the
      numerator and the denominator.
    """
    eps = 1e-9
    H, W = 48, 64
    imgs = np.stack([make_speckle(rng, shape=(H, W), grain_px=3.0) for _ in range(2)])
    imgs[1, 2, 3] = np.nan
    z = t_pc.zscore2d(t(imgs))
    for k in range(2):
        close(z[k], j_pc.zscore2d(jnp.asarray(imgs[k])))
    z0 = z[0].numpy()
    tpl = np.zeros((H, W))
    tpl[10:30, 20:44] = imgs[0, 12:32, 18:42]

    # the same spectra through both inverses
    Fi, Ft = np.fft.rfft2(z0), np.fft.rfft2(tpl)
    got = t_pc.phase_corr_from_spectra(t(Fi), t(Ft), s=(H, W), eps=eps)
    jprod = jnp.asarray(Fi) * jnp.conj(jnp.asarray(Ft))
    want = jnp.abs(jnp.fft.fftshift(
        jnp.fft.irfft2(jprod / (jnp.abs(jprod) + eps), s=(H, W)), axes=(-2, -1)))
    close(got, want)

    # end to end, each side on its own FFT
    surf = t_pc.phase_corr_surface(z[:1], t(tpl)[None], eps=eps)[0].numpy()
    ref = np.asarray(j_pc.phase_corr_surface(jnp.asarray(z0), jnp.asarray(tpl), eps=eps))
    tprod = (torch.fft.rfft2(z[0]) * torch.fft.rfft2(t(tpl)).conj()).numpy()
    jprod = np.asarray(jnp.fft.rfft2(jnp.asarray(z0)) * jnp.conj(jnp.fft.rfft2(jnp.asarray(tpl))))
    ill = (np.abs(tprod) < 1e3 * eps) | (np.abs(jprod) < 1e3 * eps)
    assert 1 <= ill.sum() <= 2 and ill[0, 0]
    d = np.abs(tprod / (np.abs(tprod) + eps) - jprod / (np.abs(jprod) + eps))
    mult = np.full(ill.shape, 2.0)
    mult[:, [0, W // 2]] = 1.0
    atol = float((mult * d)[ill].sum()) / (H * W) + RTOL * float(ref.max())
    assert atol < 1e-5 * ref.max()  # the bound stays far below the surface's scale
    np.testing.assert_allclose(surf, ref, rtol=0, atol=atol)

    i, j = t_pc.argmax2d(torch.from_numpy(surf))
    assert (int(i), int(j)) == tuple(int(v) for v in j_pc.argmax2d(jnp.asarray(ref)))
    peak, snr = t_pc.peak_quality(torch.from_numpy(surf), i, j, eps=eps)
    rpeak, rsnr = (float(v) for v in j_pc.peak_quality(jnp.asarray(ref), int(i), int(j), eps=eps))
    assert abs(float(peak) - rpeak) <= atol
    background = rpeak / rsnr  # median|corr| + eps
    assert abs(float(snr) - rsnr) <= rsnr * (atol / rpeak + atol / background) * (1 + 1e-6)


@pytest.mark.parametrize("shape", [(96, 96), (80, 100)])
def test_grain_core_with_map(rng, shape):
    from barc4dip_tpu.metrics import estimators as j_est
    from barc4dip_tpu_torch.metrics import estimators as t_est

    imgs = np.stack([make_speckle(rng, shape=shape, grain_px=4.0) for _ in range(2)])
    got = t_est.grain_core(t(imgs))
    maps = t_est.grain_map_core(t(imgs))
    assert torch.equal(maps, got["autocorr"])
    for k in range(2):
        ref = j_est.grain_core(jnp.asarray(imgs[k]))
        for key in ("lx", "ly", "leq", "r", "autocorr"):
            close(got[key][k], ref[key])
        close(got["xlag"], ref["xlag"])
        close(got["ylag"], ref["ylag"])
        close(maps[k], j_est.grain_map_core(jnp.asarray(imgs[k])))
    assert set(t_est.grain_core(t(imgs), with_map=False)) == {"lx", "ly", "leq", "r"}
