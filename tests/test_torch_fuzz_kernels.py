# SPDX-License-Identifier: CECILL-2.1
"""The randomized cases of ``tests/test_fuzz_kernels.py`` on the port's
tensor cores, on the CPU: widths, quantiles, the half pull of
centro-symmetric maps, radial bins, moments, the 3x3 median, the Taylor
subpixel step and NCC, each against ``tests/reference_impl.py`` or
NumPy/SciPy at the JAX tests' seeds and tolerances."""
import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.maths import distance_at_fraction_from_peak, width_at_fraction
from barc4dip_tpu_torch.ops.quantile import nanpercentiles_exact
from tests.reference_impl import distance_at_fraction as ref_dist
from tests.reference_impl import width_at_fraction as ref_width

CPU = dict(device="cpu")


def _adversarial_profiles(rng, n):
    yield np.zeros(n) + 1.0                          # constant
    yield np.linspace(0, 1, n)                        # monotone ramp
    yield np.linspace(1, 0, n)                        # reverse ramp
    p = np.zeros(n); p[0] = 1.0
    yield p                                           # peak at edge
    p = np.zeros(n); p[-1] = 1.0
    yield p                                           # peak at other edge
    yield rng.normal(size=n)                          # signed noise
    yield np.abs(rng.normal(size=n)) + 1e-9           # positive noise
    p = rng.normal(size=n); p[n // 2] = 100.0
    yield p                                           # spike
    yield np.repeat(rng.normal(size=max(1, n // 4)), 4)[:n]  # plateaus/ties
    p = -np.abs(rng.normal(size=n))
    yield p                                           # all-negative


@pytest.mark.parametrize("n", [5, 16, 33, 128])
@pytest.mark.parametrize("fraction", [0.1, 1 / np.e, 0.5, 0.9])
def test_width_at_fraction_fuzz(rng, n, fraction):
    for k, p in enumerate(_adversarial_profiles(rng, n)):
        got = width_at_fraction(p, fraction=fraction, **CPU)
        want = ref_width(p, fraction)
        assert got[1] == want[1], (k, p[:6])
        assert got[0] == pytest.approx(want[0], rel=1e-9, abs=1e-12), (k, p[:6])


@pytest.mark.parametrize("n", [5, 16, 128])
@pytest.mark.parametrize("fraction", [0.2, 1 / np.e, 0.8])
def test_distance_at_fraction_fuzz(rng, n, fraction):
    for k, p in enumerate(_adversarial_profiles(rng, n)):
        for peak_index in (0, n // 2, n - 1):
            got = distance_at_fraction_from_peak(p, fraction=fraction, peak_index=peak_index, **CPU)
            want = ref_dist(p, fraction, peak_index)
            assert got[1] == want[1], (k, peak_index)
            assert got[0] == pytest.approx(want[0], rel=1e-9, abs=1e-12), (k, peak_index)


def test_quantile_fuzz(rng):
    for trial in range(20):
        n = int(rng.integers(2, 5000))
        kind = trial % 4
        if kind == 0:
            x = rng.normal(size=n) * 10.0 ** float(rng.integers(-3, 6))
        elif kind == 1:
            x = rng.integers(-5, 5, size=n).astype(float)  # heavy ties
        elif kind == 2:
            x = np.full(n, float(rng.normal()))            # constant
        else:
            x = rng.normal(size=n)
            x[rng.random(size=n) < 0.3] = np.nan           # many NaNs
            if np.all(np.isnan(x)):
                x[0] = 1.0
        ps = tuple(sorted(rng.uniform(0, 100, size=3)))
        got = nanpercentiles_exact(torch.from_numpy(x), ps).numpy()
        want = np.nanpercentile(x, list(ps))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                   err_msg=f"trial {trial} n={n} kind={kind}")


def test_pull_centrosymmetric_fuzz(rng):
    """Half-pull reconstruction matches a full pull to dtype eps for PSD and
    autocorr of real input, across random (odd/even, rectangular) shapes."""
    from barc4dip_tpu_torch.signal import autocorr2d, psd2d, pull_centrosymmetric

    for trial in range(12):
        ny = int(rng.integers(16, 97))
        nx = int(rng.integers(16, 97))
        img = rng.normal(size=(ny, nx)) * 10.0 ** float(rng.integers(-2, 4))
        for dev_map, _, _ in (psd2d(img, **CPU), autocorr2d(img, **CPU)):
            full = dev_map.numpy()
            half = pull_centrosymmetric(dev_map)
            tol = 500 * np.finfo(full.dtype).eps * max(np.abs(full).max(), 1e-30)
            np.testing.assert_allclose(half, full, rtol=0, atol=tol,
                                       err_msg=f"trial {trial} shape=({ny},{nx})")


def test_radial_mean_binned_fuzz(rng):
    """Annular binning matches the plain bincount formulation on random
    rectangular/odd/even shapes, including NaN-free adversarial content."""
    from barc4dip_tpu_torch.maths import radial_mean_binned

    for trial in range(10):
        ny = int(rng.integers(8, 70))
        nx = int(rng.integers(8, 70))
        kind = trial % 3
        if kind == 0:
            z = rng.normal(size=(ny, nx))
        elif kind == 1:
            z = np.full((ny, nx), 3.25)
        else:
            z = np.zeros((ny, nx)); z[ny // 2, nx // 2] = 1.0

        got, r = radial_mean_binned(z, **CPU)

        yy = np.arange(ny) - ny // 2
        xx = np.arange(nx) - nx // 2
        R = np.hypot(yy[:, None], xx[None, :])
        r_max = min(np.max(np.abs(yy)), np.max(np.abs(xx)))
        nb = int(np.floor(r_max / 1.0)) + 1
        ids = np.floor(R / 1.0).astype(int)  # reference floor-bin convention
        sel = ids < nb
        sums = np.bincount(ids[sel], weights=z[sel], minlength=nb)
        cnts = np.bincount(ids[sel], minlength=nb)
        want = np.divide(sums, cnts, out=np.full(nb, np.nan), where=cnts > 0)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-12, equal_nan=True,
                                   err_msg=f"trial {trial} shape=({ny},{nx})")


def test_distribution_moments_fuzz(rng):
    """Moments agree with float64 NumPy/SciPy on adversarial inputs: NaN
    padding, constants, extreme magnitudes, saturation."""
    from scipy.stats import describe

    from barc4dip_tpu_torch.metrics import distribution_moments

    for trial in range(10):
        n = int(rng.integers(64, 400))
        m = int(rng.integers(64, 400))
        kind = trial % 5
        x = rng.normal(size=(n, m)) * 10.0 ** float(rng.integers(-3, 5)) + 10.0
        if kind == 1:
            x[rng.random(size=x.shape) < 0.25] = np.nan
        elif kind == 2:
            x = np.full((n, m), 17.5)
        elif kind == 3:
            x = np.clip(np.abs(x) * 1e3, 0, 65535.0)  # saturated tail
        elif kind == 4:
            x = np.abs(x)
            x[0, 0] = 0.0

        got = distribution_moments(x, verbose=False, **CPU)
        flat = x[np.isfinite(x)].astype(np.float64)
        assert got["mean"] == pytest.approx(flat.mean(), rel=1e-9)
        assert got["std"] == pytest.approx(flat.std(ddof=0), rel=1e-9, abs=1e-12)
        if flat.std() > 0:
            d = describe(flat)
            assert got["skewness"] == pytest.approx(d.skewness, rel=1e-6, abs=1e-9)
            assert got["kurtosis"] == pytest.approx(d.kurtosis, rel=1e-6, abs=1e-9)
        assert got["frac_sat"] == pytest.approx(float(np.mean(flat >= 65535.0)))


def test_median_filter_fuzz(rng):
    """3x3 rank median matches scipy (reflect mode) on random shapes."""
    from scipy.ndimage import median_filter

    from barc4dip_tpu_torch.ops.rank import median_filter2d

    for trial in range(8):
        ny = int(rng.integers(5, 60))
        nx = int(rng.integers(5, 60))
        z = rng.normal(size=(ny, nx))
        if trial % 3 == 1:
            z = rng.integers(0, 7, size=(ny, nx)).astype(float)  # heavy ties
        got = median_filter2d(torch.from_numpy(z), size=3).numpy()
        want = median_filter(z, size=3, mode="reflect")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=f"trial {trial} ({ny},{nx})")


def test_subpixel_taylor_quadratic_fuzz(rng):
    """The 3x3 Taylor/Newton refinement recovers the analytic optimum of a
    separable quadratic peak exactly (within float tolerance)."""
    from barc4dip_tpu_torch.ops import phasecorr as pc

    for trial in range(12):
        dy = float(rng.uniform(-0.45, 0.45))
        dx = float(rng.uniform(-0.45, 0.45))
        n = 15
        yy = np.arange(n)[:, None] - n // 2
        xx = np.arange(n)[None, :] - n // 2
        corr = torch.from_numpy(1.0 - (yy - dy) ** 2 - (xx - dx) ** 2 + 0.1 * (yy - dy) * (xx - dx))
        i, j = pc.argmax2d(corr)
        di, dj = pc.subpixel_taylor(corr, i, j, convention="newton")
        assert float(i) + float(di) == pytest.approx(n // 2 + dy, abs=5e-6), trial
        assert float(j) + float(dj) == pytest.approx(n // 2 + dx, abs=5e-6), trial


def test_ncc_affine_invariance_fuzz(rng):
    """NCC is invariant to affine rescaling of image and template (the
    property the reference's TM_CCOEFF_NORMED backend relies on)."""
    from barc4dip_tpu_torch.ops.ncc import ncc_valid

    for trial in range(8):
        H = int(rng.integers(40, 90))
        W = int(rng.integers(40, 90))
        s = int(rng.integers(7, 20))
        img = rng.normal(size=(H, W))
        y0 = int(rng.integers(0, H - s)); x0 = int(rng.integers(0, W - s))
        tpl = img[y0:y0+s, x0:x0+s] + 0.01 * rng.normal(size=(s, s))

        base = ncc_valid(torch.from_numpy(img), torch.from_numpy(tpl)).numpy()
        a = 10.0 ** float(rng.integers(-2, 3))
        b = float(rng.normal()) * 100.0
        scaled = ncc_valid(torch.from_numpy(a * img + b), torch.from_numpy(0.5 * a * tpl - b)).numpy()
        np.testing.assert_allclose(scaled, base, rtol=0, atol=5e-6, err_msg=f"trial {trial}")
        # the peak must be at the template's source position
        pk = np.unravel_index(np.argmax(base), base.shape)
        assert pk == (y0, x0), f"trial {trial}: peak {pk} != ({y0},{x0})"
