# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``barc4dip_tpu_torch.signal.fft`` and the shifted FFT / PSD
primitives of ``ops.fftcore`` against the JAX package's on the same seeded
numpy input (CPU, ``device="cpu"``).

Tolerances: float64 input against JAX x64 at rtol 1e-9 of the map's peak;
float32 and integer input (both compute in float32) at 2e-5 of the peak;
host frequency axes exactly equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from barc4dip_tpu.ops import fftcore as j_core
from barc4dip_tpu.signal import fft as j_fft
from barc4dip_tpu_torch.ops import fftcore as t_core
from barc4dip_tpu_torch.signal import fft as t_fft
from tests.test_torch_ops import close, t

torch.set_num_threads(2)
F64, F32 = 1e-9, 2e-5
CPU = {"device": "cpu"}


def cclose(got, ref, rtol):
    """Complex tensors: real and imaginary parts within rtol of the peak."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("n", [8, 9, 250, 251])
def test_freq_axis1d_equals_jax(n):
    np.testing.assert_array_equal(t_fft.freq_axis1d(n=n, dx=0.5), j_fft.freq_axis1d(n=n, dx=0.5))
    x = np.linspace(0.0, 10.0, n, endpoint=False)
    np.testing.assert_array_equal(t_fft.freq_axis1d(n=n, x=x), j_fft.freq_axis1d(n=n, x=x))


def test_freq_axes2d_equals_jax():
    x, y = np.arange(33) * 0.25, np.arange(40) * 2.0
    for kw in (dict(dx=2.0, dy=3.0), dict(x=x, y=y)):
        got = t_fft.freq_axes2d(shape=(40, 33), **kw)
        want = j_fft.freq_axes2d(shape=(40, 33), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_freq_axis_errors_match_jax():
    for fn, kw in (
        (lambda m: m.freq_axis1d, dict(n=10, x=np.arange(10.0), dx=2.0)),
        (lambda m: m.freq_axis1d, dict(n=0)),
        (lambda m: m.freq_axis1d, dict(n=10, dx=-1.0)),
        (lambda m: m.freq_axes2d, dict(shape=(0, 4))),
        (lambda m: m.freq_axes2d, dict(shape=(4, 4), x=np.arange(4.0))),
        (lambda m: m.freq_axes2d, dict(shape=(4, 4), x=np.arange(5.0), y=np.arange(4.0))),
    ):
        with pytest.raises(ValueError) as want:
            fn(j_fft)(**kw)
        with pytest.raises(ValueError) as got:
            fn(t_fft)(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [100, 101])
@pytest.mark.parametrize("kind", ["float64", "float32", "complex128", "int16"])
def test_fft1d_and_roundtrip(rng, n, kind):
    s = rng.normal(size=n) * 50
    if kind.startswith("complex"):
        s = s + 1j * rng.normal(size=n)
    s = s.astype(kind)
    tol = F64 if kind in ("float64", "complex128") else F32
    F, fx = t_fft.fft1d(s, dx=0.5, **CPU)
    Fj, fxj = j_fft.fft1d(s, dx=0.5)
    np.testing.assert_array_equal(fx, fxj)
    cclose(F, Fj, tol)
    assert F.dtype == (torch.complex128 if tol == F64 else torch.complex64)
    back = t_fft.ifft1d(F)
    cclose(back, np.asarray(j_fft.ifft1d(Fj)), tol)
    cclose(back, s.astype(complex), tol)
    # a numpy spectrum goes to the named device
    cclose(t_fft.ifft1d(F.numpy(), **CPU), np.asarray(s, complex), tol)


@pytest.mark.parametrize("shape", [(64, 64), (63, 64), (65, 33)])
@pytest.mark.parametrize("kind", ["float64", "float32", "complex64", "uint16"])
def test_fft2d_and_roundtrip(rng, shape, kind):
    img = rng.normal(size=shape) * 100 + 500
    if kind.startswith("complex"):
        img = img + 1j * rng.normal(size=shape)
    img = img.astype(kind)
    tol = F64 if kind == "float64" else F32
    F, fx, fy = t_fft.fft2d(img, dx=2.0, dy=3.0, **CPU)
    Fj, fxj, fyj = j_fft.fft2d(img, dx=2.0, dy=3.0)
    np.testing.assert_array_equal(fx, fxj)
    np.testing.assert_array_equal(fy, fyj)
    cclose(F, Fj, tol)
    back = t_fft.ifft2d(F)
    cclose(back, np.asarray(j_fft.ifft2d(Fj)), tol)
    cclose(back, img.astype(complex), tol)


@pytest.mark.parametrize("shape", [(64, 64), (63, 65), (64, 63)])
@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("kind", ["float64", "float32", "complex128", "uint16"])
def test_psd2d(rng, shape, scale, kind):
    img = rng.normal(size=shape) * 100 + 500
    if kind.startswith("complex"):
        img = img + 1j * rng.normal(size=shape) * 100
    img = img.astype(kind)
    tol = F64 if kind in ("float64", "complex128") else F32
    P, fx, fy = t_fft.psd2d(img, dx=1.5, dy=0.5, scale=scale, **CPU)
    Pj, fxj, fyj = j_fft.psd2d(img, dx=1.5, dy=0.5, scale=scale)
    assert not P.is_complex()
    assert P.dtype == (torch.float64 if tol == F64 else torch.float32)
    np.testing.assert_array_equal(fx, fxj)
    np.testing.assert_array_equal(fy, fyj)
    close(P, Pj, tol)


@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("kind", ["float64", "float32", "complex128", "int32"])
def test_psd1d(rng, n, scale, kind):
    s = rng.normal(size=n) * 30
    if kind.startswith("complex"):
        s = s + 1j * rng.normal(size=n)
    s = s.astype(kind)
    tol = F64 if kind in ("float64", "complex128") else F32
    x = np.arange(n) * 0.25
    P, fx = t_fft.psd1d(s, x=x, scale=scale, **CPU)
    Pj, fxj = j_fft.psd1d(s, x=x, scale=scale)
    np.testing.assert_array_equal(fx, fxj)
    close(P, Pj, tol)
    ref = np.abs(np.fft.fftshift(np.fft.fft(s.astype(complex)))) ** 2 * (0.25 / n if scale else 1.0)
    close(P, ref, tol)


def test_tensor_input_stays_on_its_device_and_dtype(rng):
    img = t(rng.normal(size=(32, 48)))
    P, _, _ = t_fft.psd2d(img)  # no device named: a tensor computes where it lives
    assert P.device == img.device and P.dtype == torch.float64
    F, _, _ = t_fft.fft2d(img.to(torch.int32))
    assert F.dtype == torch.complex64


@pytest.mark.parametrize("fn, arg", [
    ("fft1d", np.zeros((4, 4))), ("ifft1d", np.zeros((4, 4))), ("psd1d", np.zeros((4, 4))),
    ("fft2d", np.zeros(4)), ("ifft2d", np.zeros(4)), ("psd2d", np.zeros((2, 4, 4))),
])
def test_dimension_errors_match_jax(fn, arg):
    with pytest.raises(ValueError) as want:
        getattr(j_fft, fn)(arg)
    with pytest.raises(ValueError) as got:
        getattr(t_fft, fn)(arg, **CPU)
    assert str(got.value) == str(want.value)


# -- ops.fftcore ----------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 17])
def test_core_shifted_freqs_and_mirror(rng, n):
    close(t_core.shifted_freqs(n, 0.5, dtype=torch.float64), j_core.shifted_freqs(n, 0.5))
    assert t_core.shifted_freqs(n, 0.5, dtype=torch.float32).dtype == torch.float32
    s = rng.normal(size=(3, n))
    Ph = np.abs(np.fft.rfft(s, axis=-1)) ** 2
    got = t_core._mirror_half_spectrum_1d(t(Ph), n).numpy()
    np.testing.assert_allclose(got, np.abs(np.fft.fft(s, axis=-1)) ** 2, rtol=1e-9, atol=1e-9)
    close(got[1], j_core._mirror_half_spectrum_1d(jnp.asarray(Ph[1]), n))


@pytest.mark.parametrize("shape", [(3, 32), (2, 3, 31)])
def test_core_1d_transforms_batch_over_leading_axes(rng, shape):
    s = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    F = t_core.fft1_shifted(t(s))
    cclose(F, np.fft.fftshift(np.fft.fft(s, axis=-1), axes=-1), F64)
    cclose(F, j_core.fft1_shifted(jnp.asarray(s)), F64)
    cclose(t_core.ifft1_shifted(F), s, F64)
    close(t_core.psd1d_core(t(s.real), step=0.5), j_core.psd1d_core(jnp.asarray(s.real), step=0.5))
    close(t_core.psd1d_core(t(s), scale=False), j_core.psd1d_core(jnp.asarray(s), scale=False))


@pytest.mark.parametrize("shape", [(2, 24, 32), (2, 25, 31)])
def test_core_2d_transforms_batch_over_leading_axes(rng, shape):
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    F = t_core.fft2_shifted(t(a))
    cclose(F, j_core.fft2_shifted(jnp.asarray(a)), F64)
    cclose(t_core.ifft2_shifted(F), a, F64)
    cclose(t_core.ifft2_shifted(F), j_core.ifft2_shifted(jnp.asarray(F.numpy())), F64)
    close(t_core.psd2d_core(t(a), step_x=0.5, step_y=2.0),
          j_core.psd2d_core(jnp.asarray(a), step_x=0.5, step_y=2.0))
