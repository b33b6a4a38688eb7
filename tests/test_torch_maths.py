# SPDX-License-Identifier: CECILL-2.1
"""Port parity: the public ``barc4dip_tpu_torch.maths`` radial means and
peak widths against the JAX package's on the same seeded numpy input (CPU,
``device="cpu"``).

Tolerances: float64 maps against JAX x64 at rtol 1e-9 of the curve's peak,
float32 and integer maps (both compute in float32) at 2e-5; radius axes at
1e-12; widths within 1e-9 (float64 profiles) or 1e-4 (float32) of JAX's,
the ``hit_edge`` flags equal.
"""
import numpy as np
import pytest
import torch

from barc4dip_tpu import maths as j_maths
from barc4dip_tpu_torch import maths as t_maths
from tests.test_torch_ops import close, t

torch.set_num_threads(2)
F64, F32 = 1e-9, 2e-5
CPU = {"device": "cpu"}


@pytest.mark.parametrize("shape", [(64, 64), (65, 63), (40, 60)])
@pytest.mark.parametrize("kw", [{}, dict(r_max=20.0, bin_size=2.5), dict(bin_size=0.37),
                                dict(r_max=45.0)])
def test_radial_mean_binned(rng, shape, kw):
    z = rng.normal(size=shape) + 3
    radial, r = t_maths.radial_mean_binned(z, **kw, **CPU)
    rj, rrj = j_maths.radial_mean_binned(z, **kw)
    assert isinstance(radial, torch.Tensor) and radial.dtype == torch.float64
    close(radial, rj, F64)  # empty bins beyond the corners are NaN in both
    close(r, rrj, 1e-12)
    close(t_maths.radial_mean_binned(z.astype(np.float32), **kw, **CPU)[0],
          j_maths.radial_mean_binned(z.astype(np.float32), **kw)[0], F32)


@pytest.mark.parametrize("shape", [(64, 64), (65, 65), (50, 70)])
@pytest.mark.parametrize("kw", [{}, dict(r_max=20.0, nr=11), dict(ntheta=90, fill_value=7.5),
                                dict(r_max=60.0, fill_value=-1.0), dict(nr=40, ntheta=17)])
def test_radial_mean_interpolated(rng, shape, kw):
    z = rng.normal(size=shape) + 3
    radial, r = t_maths.radial_mean_interpolated(z, **kw, **CPU)
    rj, rrj = j_maths.radial_mean_interpolated(z, **kw)
    close(radial, rj, F64)
    close(r, rrj, 1e-12)
    close(t_maths.radial_mean_interpolated(z.astype(np.float32), **kw, **CPU)[0],
          j_maths.radial_mean_interpolated(z.astype(np.float32), **kw)[0], F32)


def test_radial_means_of_integer_and_tensor_maps(rng):
    z = rng.integers(0, 4000, size=(48, 52)).astype(np.uint16)
    for fn in ("radial_mean_binned", "radial_mean_interpolated"):
        got, _ = getattr(t_maths, fn)(z, **CPU)
        assert got.dtype == torch.float32
        close(got, getattr(j_maths, fn)(z.astype(np.float32))[0], F32)
        same, _ = getattr(t_maths, fn)(torch.from_numpy(z.astype(np.int32)))  # computes where it lives
        assert torch.equal(same, got)


@pytest.mark.parametrize("fn", ["radial_mean_binned", "radial_mean_interpolated"])
def test_radial_validation_matches_jax(fn):
    bad = np.ones((16, 16))
    bad[3, 3] = np.nan
    cases = [((bad,), {}), ((np.ones((2, 8, 8)),), {}), ((np.ones((8, 8)),), dict(r_max=-1.0))]
    cases.append(((np.ones((8, 8)),), dict(bin_size=0.0) if fn.endswith("binned") else dict(nr=1)))
    if fn.endswith("interpolated"):
        cases.append(((np.ones((8, 8)),), dict(ntheta=3)))
    for args, kw in cases:
        with pytest.raises(ValueError) as want:
            getattr(j_maths, fn)(*args, **kw)
        with pytest.raises(ValueError) as got:
            getattr(t_maths, fn)(*args, **kw, **CPU)
        assert str(got.value) == str(want.value)
    inf = torch.ones(8, 8)
    inf[2, 2] = torch.inf
    with pytest.raises(ValueError, match="non-finite"):  # a tensor: one reduction on its device
        getattr(t_maths, fn)(inf)


def _profiles(rng):
    x = np.arange(101) - 50.0
    yield np.exp(-0.5 * (x / 7.0) ** 2)
    yield np.exp(-0.5 * (x / 7.0) ** 2)[50:]
    yield np.ones(20)  # never crosses
    yield np.array([0.0, 0.1, 1.0, 0.9, 0.95, 0.2, 0.0])
    yield np.array([1.0, 0.2, 0.2, 0.2])
    for _ in range(6):
        yield np.abs(rng.normal(size=37)) + 0.05


@pytest.mark.parametrize("fraction", [1.0 / np.e, 0.5, 0.1])
def test_width_at_fraction(rng, fraction):
    for p in _profiles(rng):
        for center in (None, 0, 3, len(p) - 1, 500, -2):
            got = t_maths.width_at_fraction(p, fraction=fraction, center_index=center, **CPU)
            want = j_maths.width_at_fraction(p, fraction=fraction, center_index=center)
            assert type(got[0]) is float and type(got[1]) is bool
            assert got[1] == want[1] and abs(got[0] - want[0]) <= 1e-9, (p, center, got, want)
        got32 = t_maths.width_at_fraction(p.astype(np.float32), fraction=fraction, **CPU)
        want32 = j_maths.width_at_fraction(p.astype(np.float32), fraction=fraction)
        assert got32[1] == want32[1] and abs(got32[0] - want32[0]) <= 1e-4


@pytest.mark.parametrize("fraction", [1.0 / np.e, 0.5, 0.1])
def test_distance_at_fraction_from_peak(rng, fraction):
    for p in _profiles(rng):
        for peak in (0, 2, len(p) - 1, 500, -2):
            got = t_maths.distance_at_fraction_from_peak(p, fraction=fraction, peak_index=peak, **CPU)
            want = j_maths.distance_at_fraction_from_peak(p, fraction=fraction, peak_index=peak)
            assert type(got[0]) is float and type(got[1]) is bool
            assert got[1] == want[1] and abs(got[0] - want[0]) <= 1e-9, (p, peak, got, want)
    ints = np.array([9, 7, 4, 2, 1], np.int16)
    assert t_maths.distance_at_fraction_from_peak(t(ints), fraction=0.5) == \
        j_maths.distance_at_fraction_from_peak(ints.astype(np.float32), fraction=0.5)


@pytest.mark.parametrize("fn", ["width_at_fraction", "distance_at_fraction_from_peak"])
def test_width_validation_matches_jax(fn):
    for args, kw in (((np.zeros((2, 5)),), {}), ((np.zeros(0),), {}),
                     ((np.ones(5),), dict(fraction=0.0)), ((np.ones(5),), dict(fraction=1.0))):
        with pytest.raises(ValueError) as want:
            getattr(j_maths, fn)(*args, **kw)
        with pytest.raises(ValueError) as got:
            getattr(t_maths, fn)(*args, **kw, **CPU)
        assert str(got.value) == str(want.value)
