# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``barc4dip_tpu_torch.signal.corr`` and the correlation cores
of ``ops.corrcore`` against the JAX package's on the same seeded numpy input
(CPU, ``device="cpu"``).

Tolerances: float64 input against JAX x64 at rtol 1e-9 of the map's peak;
float32 and integer input (both compute in float32) at 2e-5 of the peak;
host lag axes exactly equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barc4dip_tpu.ops import corrcore as j_core
from barc4dip_tpu.signal import corr as j_corr
from barc4dip_tpu_torch.ops import corrcore as t_core
from barc4dip_tpu_torch.signal import corr as t_corr
from tests.conftest import make_speckle
from tests.test_torch_ops import close, t

torch.set_num_threads(2)
F64, F32 = 1e-9, 2e-5
CPU = {"device": "cpu"}


@pytest.mark.parametrize("shape", [(64, 64), (63, 65)])
@pytest.mark.parametrize("remove_mean", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("normalize", ["none", "peak"])
def test_xcorr2d_grid(rng, shape, remove_mean, standardize, normalize):
    a = rng.normal(size=shape) * 7 + 3
    b = rng.normal(size=shape) * 2 - 1
    kw = dict(remove_mean=remove_mean, standardize=standardize, normalize=normalize)
    corr, xlag, ylag = t_corr.xcorr2d(a, b, **kw, **CPU)
    cj, xj, yj = j_corr.xcorr2d(a, b, **kw)
    assert not corr.is_complex() and corr.dtype == torch.float64
    close(corr, cj, F64)
    np.testing.assert_array_equal(xlag, xj)
    np.testing.assert_array_equal(ylag, yj)
    got32, _, _ = t_corr.xcorr2d(a.astype(np.float32), b.astype(np.float32), **kw, **CPU)
    assert got32.dtype == torch.float32
    close(got32, cj, F32)


@pytest.mark.parametrize("shape", [(64, 64), (63, 65)])
@pytest.mark.parametrize("remove_mean", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("normalize", ["none", "peak"])
def test_autocorr2d_grid(rng, shape, remove_mean, standardize, normalize):
    a = make_speckle(rng, shape=shape, grain_px=4.0) * 100 + 5
    kw = dict(remove_mean=remove_mean, standardize=standardize, normalize=normalize)
    corr, xlag, ylag = t_corr.autocorr2d(a, dx=0.5, dy=2.0, **kw, **CPU)
    cj, xj, yj = j_corr.autocorr2d(a, dx=0.5, dy=2.0, **kw)
    close(corr, cj, F64)
    np.testing.assert_array_equal(xlag, xj)
    np.testing.assert_array_equal(ylag, yj)
    u16 = a.astype(np.uint16)
    close(t_corr.autocorr2d(u16, **kw, **CPU)[0], j_corr.autocorr2d(u16.astype(np.float32), **kw)[0], F32)


def test_autocorr2d_is_real_and_peaked(speckle):
    ac, _, _ = t_corr.autocorr2d(speckle, **CPU)
    assert not ac.is_complex()
    iy, ix = np.unravel_index(int(ac.argmax()), ac.shape)
    assert (iy, ix) == (speckle.shape[0] // 2, speckle.shape[1] // 2)
    assert float(ac[iy, ix]) == pytest.approx(1.0)


@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("normalize", ["none", "peak"])
def test_autocorr2d_complex_goes_through_xcorr_and_is_real(rng, standardize, normalize):
    a = rng.normal(size=(48, 40)) + 1j * rng.normal(size=(48, 40)) + (2 - 1j)
    kw = dict(standardize=standardize, normalize=normalize)
    corr, _, _ = t_corr.autocorr2d(a, **kw, **CPU)
    assert not corr.is_complex() and corr.dtype == torch.float64
    close(corr, j_corr.autocorr2d(a, **kw)[0], F64)
    x2, _, _ = t_corr.xcorr2d(a, a.real, **kw, **CPU)  # one complex, one real input
    assert x2.is_complex()
    want = np.asarray(j_corr.xcorr2d(a, a.real, **kw)[0])
    np.testing.assert_allclose(x2.numpy(), want, rtol=0, atol=F64 * np.abs(want).max())


@pytest.mark.parametrize("n", [100, 101])
@pytest.mark.parametrize("remove_mean", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("normalize", ["none", "peak"])
def test_xcorr1d_grid(rng, n, remove_mean, standardize, normalize):
    """The 1-D reductions (mean, std, peak) run over the last axis only."""
    a = rng.normal(size=n) * 3 + 10
    b = np.roll(a, 7) + rng.normal(size=n) * 0.1
    kw = dict(remove_mean=remove_mean, standardize=standardize, normalize=normalize)
    corr, xlag = t_corr.xcorr1d(a, b, dx=0.5, **kw, **CPU)
    cj, xj = j_corr.xcorr1d(a, b, dx=0.5, **kw)
    assert corr.shape == (n,)
    close(corr, cj, F64)
    np.testing.assert_array_equal(xlag, xj)
    ac, alag = t_corr.autocorr1d(a, x=np.arange(n) * 0.25, **kw, **CPU)
    aj, alj = j_corr.autocorr1d(a, x=np.arange(n) * 0.25, **kw)
    close(ac, aj, F64)
    np.testing.assert_array_equal(alag, alj)
    close(t_corr.xcorr1d(a.astype(np.float32), b.astype(np.float32), **kw, **CPU)[0], cj, F32)
    ai = (a * 100).astype(np.int32)
    close(t_corr.autocorr1d(ai, **kw, **CPU)[0], j_corr.autocorr1d(ai.astype(np.float32), **kw)[0], F32)


def test_xcorr1d_peak_lag_and_complex(rng):
    a = rng.normal(size=101)
    corr, xlag = t_corr.xcorr1d(a, np.roll(a, 7), **CPU)
    assert xlag[int(corr.argmax())] == -7  # circular shift of 7: peak at lag -7
    assert float(corr.abs().max()) == pytest.approx(1.0)
    c = a + 1j * rng.normal(size=101)
    got, _ = t_corr.xcorr1d(c, np.roll(c, 3), standardize=True, **CPU)
    want = np.asarray(j_corr.xcorr1d(c, np.roll(c, 3), standardize=True)[0])
    assert got.is_complex()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64 * np.abs(want).max())


def test_cores_reduce_per_signal_over_leading_axes(rng):
    """A batch through the cores equals the JAX cores signal by signal."""
    a = rng.normal(size=(3, 50)) * np.array([[1.0], [5.0], [0.2]]) + 4
    b = rng.normal(size=(3, 50))
    got = t_core.xcorr1d_core(t(a), t(b), standardize=True)
    for k in range(3):
        close(got[k], j_core.xcorr1d_core(jnp.asarray(a[k]), jnp.asarray(b[k]), standardize=True))
    a2 = rng.normal(size=(2, 24, 31)) * np.array([1.0, 9.0])[:, None, None]
    b2 = rng.normal(size=(2, 24, 31))
    got = t_core.xcorr2d_core(t(a2), t(b2), standardize=True)
    for k in range(2):
        close(got[k], j_core.xcorr2d_core(jnp.asarray(a2[k]), jnp.asarray(b2[k]), standardize=True))
    const = torch.full((2, 16), 3.0, dtype=torch.float64)  # zero std: left as it is
    assert torch.equal(t_core._precondition(const, False, True, (-1,)), const)


def test_tensor_inputs_share_a_device_with_numpy_ones(rng):
    a = rng.normal(size=(16, 32))
    corr, xlag, ylag = t_corr.xcorr2d(t(a), a, dx=0.5, dy=2.0)  # the tensor names the device
    np.testing.assert_allclose(xlag, (np.arange(32) - 16) * 0.5)
    np.testing.assert_allclose(ylag, (np.arange(16) - 8) * 2.0)
    close(corr, t_corr.autocorr2d(a, **CPU)[0], 1e-12)


@pytest.mark.parametrize("fn, args, kw", [
    ("xcorr2d", (np.zeros((8, 8)), np.zeros((8, 8))), dict(normalize="bogus")),
    ("autocorr2d", (np.zeros((8, 8)),), dict(normalize="bogus")),
    ("xcorr1d", (np.zeros(8), np.zeros(8)), dict(normalize="bogus")),
    ("xcorr1d", (np.zeros(8), np.zeros(9)), {}),
    ("xcorr1d", (np.zeros((2, 8)), np.zeros(8)), {}),
    ("autocorr1d", (np.zeros((2, 8)),), {}),
    ("xcorr2d", (np.zeros((8, 8)), np.zeros((8, 9))), {}),
    ("xcorr2d", (np.zeros(8), np.zeros(8)), {}),
    ("autocorr2d", (np.zeros(8),), {}),
    ("autocorr2d", (np.zeros((8, 8)),), dict(dx=-1.0)),
])
def test_validation_messages_match_jax(fn, args, kw):
    with pytest.raises(ValueError) as want:
        getattr(j_corr, fn)(*args, **kw)
    with pytest.raises(ValueError) as got:
        getattr(t_corr, fn)(*args, **kw, **CPU)
    assert str(got.value) == str(want.value)
