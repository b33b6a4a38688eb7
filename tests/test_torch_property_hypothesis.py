# SPDX-License-Identifier: CECILL-2.1
"""The tensor-core cases of ``tests/test_property_hypothesis.py`` on the
port, on the CPU: generated inputs with shrinking (arbitrary shapes,
tie-heavy and NaN-laden payloads, extreme magnitudes) through the port's
widths, distances, quantiles, 3x3 median, moments, Taylor subpixel step,
PSD / autocorrelation invariants and the cross-correlation shift theorem,
against ``tests/reference_impl.py`` and NumPy/SciPy at the JAX tests'
settings and tolerances."""
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from tests.reference_impl import distance_at_fraction as ref_dist  # noqa: E402
from tests.reference_impl import width_at_fraction as ref_width  # noqa: E402

COMMON = dict(
    max_examples=25,
    deadline=None,
    derandomize=True,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)
CPU = dict(device="cpu")

finite = st.floats(min_value=-1e12, max_value=1e12, allow_nan=False, allow_infinity=False)


@st.composite
def profile_1d(draw, min_n=3, max_n=64):
    n = draw(st.integers(min_n, max_n))
    kind = draw(st.integers(0, 3))
    if kind == 0:  # free-form floats
        return np.asarray(draw(st.lists(finite, min_size=n, max_size=n)))
    if kind == 1:  # tie-heavy small integers
        vals = draw(st.lists(st.integers(-3, 3), min_size=n, max_size=n))
        return np.asarray(vals, dtype=float)
    if kind == 2:  # constant
        return np.full(n, draw(finite))
    # smooth bump with generated width/offset (the geometric common case)
    c = draw(st.floats(0.0, 1.0))
    w = draw(st.floats(0.05, 2.0))
    x = np.linspace(-1, 1, n)
    return np.exp(-(((x - (2 * c - 1)) / w) ** 2))


@given(p=profile_1d(), fraction=st.floats(0.05, 0.95))
@settings(**COMMON)
def test_width_at_fraction_matches_reference(p, fraction):
    from barc4dip_tpu_torch.maths import width_at_fraction

    got_v, got_edge = width_at_fraction(p, fraction=fraction, **CPU)
    want_v, want_edge = ref_width(p, fraction)
    assert got_edge == want_edge
    assert got_v == pytest.approx(want_v, rel=1e-9, abs=1e-12)


@given(p=profile_1d(), fraction=st.floats(0.05, 0.95), data=st.data())
@settings(**COMMON)
def test_distance_at_fraction_matches_reference(p, fraction, data):
    from barc4dip_tpu_torch.maths import distance_at_fraction_from_peak

    peak_index = data.draw(st.integers(0, p.size - 1))
    got_v, got_edge = distance_at_fraction_from_peak(p, fraction=fraction, peak_index=peak_index, **CPU)
    want_v, want_edge = ref_dist(p, fraction, peak_index)
    assert got_edge == want_edge
    assert got_v == pytest.approx(want_v, rel=1e-9, abs=1e-12)


@given(
    xs=st.lists(st.one_of(finite, st.just(np.nan)), min_size=2, max_size=400),
    ps=st.lists(st.floats(0.0, 100.0), min_size=1, max_size=4),
)
@settings(**COMMON)
def test_nanpercentiles_exact_matches_numpy(xs, ps):
    from barc4dip_tpu_torch.ops.quantile import nanpercentiles_exact

    x = np.asarray(xs, dtype=float)
    if not np.any(np.isfinite(x)):
        x[0] = 0.0  # all-NaN percentile is undefined in both implementations
    ps = tuple(sorted(ps))
    got = nanpercentiles_exact(torch.from_numpy(x), ps).numpy()
    want = np.nanpercentile(x, list(ps))
    scale = max(np.nanmax(np.abs(x)), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * scale)


@given(
    ny=st.integers(3, 24),
    nx=st.integers(3, 24),
    seed=st.integers(0, 2**31 - 1),
    ties=st.booleans(),
)
@settings(**COMMON)
def test_median_filter_matches_scipy(ny, nx, seed, ties):
    from scipy.ndimage import median_filter

    from barc4dip_tpu_torch.ops.rank import median_filter2d

    rng = np.random.default_rng(seed)
    z = rng.integers(0, 4, size=(ny, nx)).astype(float) if ties else rng.normal(size=(ny, nx))
    got = median_filter2d(torch.from_numpy(z), size=3).numpy()
    want = median_filter(z, size=3, mode="reflect")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@given(
    n=st.integers(8, 60),
    m=st.integers(8, 60),
    seed=st.integers(0, 2**31 - 1),
    nan_frac=st.floats(0.0, 0.5),
    scale_exp=st.integers(-6, 8),
)
@settings(**COMMON)
def test_distribution_moments_match_numpy(n, m, seed, nan_frac, scale_exp):
    from barc4dip_tpu_torch.metrics import distribution_moments

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)) * 10.0**scale_exp + 3.0
    x[rng.random(size=x.shape) < nan_frac] = np.nan
    if not np.any(np.isfinite(x)):
        x[0, 0] = 1.0
    got = distribution_moments(x, verbose=False, **CPU)
    flat = x[np.isfinite(x)].astype(np.float64)
    assert got["mean"] == pytest.approx(flat.mean(), rel=1e-9)
    assert got["std"] == pytest.approx(flat.std(ddof=0), rel=1e-9, abs=1e-12)
    assert got["variance"] == pytest.approx(flat.var(ddof=0), rel=1e-9, abs=1e-12)


@given(
    dy=st.floats(-0.45, 0.45),
    dx=st.floats(-0.45, 0.45),
    curv_y=st.floats(0.2, 5.0),
    curv_x=st.floats(0.2, 5.0),
    cross=st.floats(-0.3, 0.3),
)
@settings(**COMMON)
def test_subpixel_taylor_recovers_quadratic_optimum(dy, dx, curv_y, curv_x, cross):
    from barc4dip_tpu_torch.ops import phasecorr as pc

    n = 11
    yy = np.arange(n)[:, None] - n // 2
    xx = np.arange(n)[None, :] - n // 2
    # keep the Hessian negative definite so the analytic optimum is (dy, dx)
    hypothesis.assume(cross * cross < curv_y * curv_x)
    corr = torch.from_numpy(
        1.0 - curv_y * (yy - dy) ** 2 - curv_x * (xx - dx) ** 2 + cross * (yy - dy) * (xx - dx)
    )
    i, j = pc.argmax2d(corr)
    di, dj = pc.subpixel_taylor(corr, i, j, convention="newton")
    assert float(i) + float(di) == pytest.approx(n // 2 + dy, abs=1e-5)
    assert float(j) + float(dj) == pytest.approx(n // 2 + dx, abs=1e-5)


@given(
    ny=st.integers(8, 48),
    nx=st.integers(8, 48),
    seed=st.integers(0, 2**31 - 1),
    dx=st.floats(0.1, 10.0),
    dy=st.floats(0.1, 10.0),
)
@settings(**COMMON)
def test_psd_parseval_and_autocorr_invariants(ny, nx, seed, dx, dy):
    """Parseval for the unscaled PSD of mean-kept input; the autocorrelation
    of a real field peaks at zero lag with value 1 and never exceeds it."""
    from barc4dip_tpu_torch.signal import autocorr2d, psd2d

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ny, nx))

    P, _, _ = psd2d(x, dx=dx, dy=dy, scale=False, **CPU)
    np.testing.assert_allclose(P.numpy().sum(), ny * nx * np.sum(x * x), rtol=1e-8, atol=1e-6)

    ac, xl, yl = autocorr2d(x, **CPU)
    ac = ac.numpy()
    iy0, ix0 = ny // 2, nx // 2
    assert float(xl[ix0]) == 0.0 and float(yl[iy0]) == 0.0
    assert ac[iy0, ix0] == pytest.approx(1.0, abs=1e-9)  # peak-normalized
    assert np.nanmax(np.abs(ac)) <= 1.0 + 1e-9
    assert np.unravel_index(np.argmax(ac), ac.shape) == (iy0, ix0)


@given(
    n=st.integers(16, 96),
    shift=st.integers(-5, 5),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**COMMON)
def test_xcorr_shift_theorem(n, shift, seed):
    """Circular cross-correlation of a signal with its roll peaks at the
    roll distance (centered lag axis)."""
    from barc4dip_tpu_torch.signal import xcorr1d

    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = np.roll(a, shift)
    corr, lags = xcorr1d(b, a, normalize="peak", **CPU)
    k = int(np.argmax(np.abs(np.asarray(corr))))
    assert float(lags[k]) == float(shift)
