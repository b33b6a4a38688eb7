# SPDX-License-Identifier: CECILL-2.1
"""PSF deconvolution, CLAHE and distortion correction: the port
(``barc4dip_tpu_torch/preprocessing``) against the JAX package on the same
seeded numpy inputs, with the cases of tests/test_preprocessing.py.

Tolerances:

- ``deconvolve_psf``: float32 on both sides, relative to the JAX result's
  max|x|: 2e-5 for Wiener and the unsupervised Wiener (one or 31 FFT round
  trips), 1e-4 for Richardson-Lucy (50 iterations of two FFT convolutions
  each, whose float32 round-off compounds through the multiplicative
  update).
- ``clahe``: at most 1 code apart and at most 1e-3 of the pixels differing,
  float input within 0.02. The port takes its float32 cumulative sums and
  its blend's fused multiply-adds in the order XLA's CPU backend gives the
  JAX package, and agrees exactly here; a backend that orders them
  otherwise rounds a value near a .5 boundary one code apart.
- ``correct_distortion``: float32 gathers of four weighted corners, at 1e-6
  of the image's max|x|; float64 at 1e-12.
- Validation errors: the same type and message (the array types named are
  each package's own).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import barc4dip_tpu.preprocessing as jpre
import barc4dip_tpu_torch.preprocessing as tpre
from tests.conftest import make_speckle

torch.set_num_threads(2)
CPU = dict(device="cpu")  # the port runs on the CPU only where it is asked to
DECONV_RTOL = {"wiener": 2e-5, "rl": 1e-4, "uw": 2e-5}


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _blurred(seed=5, shape=(96, 80), sigma=1.5):
    rng = np.random.default_rng(seed)
    sharp = make_speckle(rng, shape=shape, grain_px=4.0).astype(np.float32)
    sharp /= sharp.max()
    return gaussian_filter(sharp, sigma).astype(np.float32)


def test_namespace_matches_the_jax_package():
    assert sorted(tpre.__all__) == sorted(jpre.__all__)
    for name in jpre.__all__:
        assert callable(getattr(tpre, name))


@pytest.mark.parametrize("method", ["wiener", "rl", "uw"])
def test_deconvolve_2d(method):
    img = _blurred() * 1000.0
    want = jpre.deconvolve_psf(img, sigma=1.5, method=method)
    got = tpre.deconvolve_psf(img, sigma=1.5, method=method, **CPU)
    assert isinstance(got, np.ndarray)
    _close(got, want, DECONV_RTOL[method])


@pytest.mark.parametrize("method", ["wiener", "rl", "uw"])
def test_deconvolve_stack_anisotropic_tensor_in(method):
    """A stack in chunks of 2 (the last one short), an anisotropic PSF and
    ``clip=False``; the tensor result equals the numpy one."""
    img = _blurred(seed=6, shape=(64, 72), sigma=2.0)
    stack = np.stack([img, img * 1.7, np.flipud(img)])
    kw = dict(sigma=(2.0, 1.0), method=method, clip=False, frame_chunk=2)
    want = jpre.deconvolve_psf(stack, **kw)
    got = tpre.deconvolve_psf(torch.from_numpy(stack), **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _close(got.numpy(), want, DECONV_RTOL[method])
    np.testing.assert_array_equal(got.numpy(), tpre.deconvolve_psf(stack, **kw, **CPU))


def test_deconvolve_rl_filter_epsilon_and_balance():
    img = _blurred(seed=7) * 50.0
    for kw in (dict(method="rl", num_iter=20, filter_epsilon=1e-3),
               dict(method="wiener", balance=0.1)):
        want = jpre.deconvolve_psf(img, sigma=1.2, **kw)
        got = tpre.deconvolve_psf(img, sigma=1.2, **kw, **CPU)
        _close(got, want, DECONV_RTOL[kw["method"]])


@pytest.mark.parametrize("method", ["wiener", "rl", "uw"])
def test_deconvolve_zero_image_and_uint16(method):
    """An all-zero frame restores to zeros; uint16 frames are cast to
    float32 as the JAX package casts them."""
    zero = np.zeros((40, 48), np.uint16)
    got = tpre.deconvolve_psf(zero, sigma=1.0, method=method, **CPU)
    assert got.dtype == np.float32 and not got.any()
    frame = (_blurred(seed=8, shape=(40, 48)) * 4000.0).astype(np.uint16)
    want = jpre.deconvolve_psf(frame, sigma=1.0, method=method)
    _close(tpre.deconvolve_psf(frame, sigma=1.0, method=method, **CPU), want, DECONV_RTOL[method])


def test_deconvolution_restores_blur_like_the_jax_package():
    """The restoration-power case of tests/test_preprocessing.py on the port."""
    rng = np.random.default_rng(5)
    sharp = make_speckle(rng, shape=(128, 128), grain_px=4.0).astype(np.float32)
    sharp /= sharp.max()
    blurred = gaussian_filter(sharp, 1.5).astype(np.float32)
    for method in ("wiener", "rl", "uw"):
        restored = tpre.deconvolve_psf(blurred, sigma=1.5, method=method, **CPU)
        assert np.mean((restored - sharp) ** 2) < 0.8 * np.mean((blurred - sharp) ** 2), method


@pytest.mark.parametrize(
    "kw, err",
    [(dict(sigma=-1.0), ValueError), (dict(sigma=1.0, method="bogus"), ValueError),
     (dict(sigma=(1.0, 2.0, 3.0)), ValueError), (dict(sigma=float("nan")), ValueError),
     (dict(sigma=1.0, pad_mode="edge"), ValueError), (dict(sigma=1.0, method="rl", num_iter=0), ValueError)],
)
def test_deconvolution_validation(kw, err):
    img = np.ones((32, 32), np.float32)
    with pytest.raises(err) as jerr:
        jpre.deconvolve_psf(img, **kw)
    with pytest.raises(err, match=str(jerr.value).replace("(", r"\(").replace(")", r"\)")):
        tpre.deconvolve_psf(img, **kw, **CPU)


def test_deconvolution_type_and_rank_errors():
    with pytest.raises(TypeError, match="expects a numpy.ndarray or torch.Tensor"):
        tpre.deconvolve_psf([[1.0]], sigma=1.0, **CPU)
    with pytest.raises(TypeError, match="expects a numpy.ndarray or jax.Array"):
        jpre.deconvolve_psf([[1.0]], sigma=1.0)
    with pytest.raises(ValueError, match="got ndim=1"):
        tpre.deconvolve_psf(np.ones(8, np.float32), sigma=1.0, **CPU)


def _clahe_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


@pytest.mark.parametrize(
    "shape, grid, clip",
    [((128, 128), (8, 8), 4.0), ((100, 90), (4, 5), 3.0), ((64, 64), (4, 4), 2.0)],
)
def test_clahe_uint16(shape, grid, clip):
    rng = np.random.default_rng(7)
    img = rng.normal(30000, 500, size=shape).astype(np.uint16)
    want = jpre.clahe(img, clip_limit=clip, tile_grid_size=grid)
    got = tpre.clahe(img, clip_limit=clip, tile_grid_size=grid, **CPU)
    _clahe_close(got, want)
    tensor = tpre.clahe(torch.from_numpy(img), clip_limit=clip, tile_grid_size=grid)
    assert tensor.dtype == torch.uint16
    np.testing.assert_array_equal(tensor.numpy(), got)


def test_clahe_uint8_and_float():
    rng = np.random.default_rng(8)
    img = rng.integers(80, 160, size=(64, 64)).astype(np.uint8)
    got = tpre.clahe(img, clip_limit=2.0, tile_grid_size=(4, 4), **CPU)
    _clahe_close(got, jpre.clahe(img, clip_limit=2.0, tile_grid_size=(4, 4)))
    # integer-valued float input: float32 codes, not rounded
    fimg = img.astype(np.float32)
    want = jpre.clahe(fimg, tile_grid_size=(4, 4))
    got = tpre.clahe(fimg, tile_grid_size=(4, 4), **CPU)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
    with pytest.raises(ValueError, match="clahe expects a 2D image."):
        tpre.clahe(img[None], **CPU)


def test_clahe_improves_local_contrast():
    rng = np.random.default_rng(7)
    base = rng.normal(30000, 500, size=(128, 128)).astype(np.uint16)
    out = tpre.clahe(base, clip_limit=4.0, tile_grid_size=(8, 8), **CPU)
    assert out.dtype == np.uint16 and out.shape == base.shape and out.std() > base.std()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16])
def test_distortion_2d_and_stack(dtype):
    rng = np.random.default_rng(9)
    img = (rng.normal(size=(2, 48, 56)) * 100 + 1000).astype(dtype)
    kw = dict(k1=0.05, k2=-0.01, p1=0.003, p2=-0.002, fill_value=-1.0)
    want = np.asarray(jpre.correct_distortion(img, **kw))
    got = tpre.correct_distortion(img, **kw, **CPU)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    atol = (1e-12 if dtype == np.float64 else 1e-6) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    one = tpre.correct_distortion(torch.from_numpy(img[1]), **kw)
    assert isinstance(one, torch.Tensor)
    np.testing.assert_array_equal(one.numpy(), got[1])
    assert (got == -1.0).any()  # out-of-bounds corners took fill_value


def test_distortion_identity_center_and_map():
    rng = np.random.default_rng(9)
    img = rng.normal(size=(64, 64)).astype(np.float32)
    np.testing.assert_allclose(tpre.correct_distortion(img, **CPU), img, rtol=1e-6, atol=1e-6)
    warped = tpre.correct_distortion(img, k1=0.05, center=(30.0, 33.5), **CPU)
    want = np.asarray(jpre.correct_distortion(img, k1=0.05, center=(30.0, 33.5)))
    np.testing.assert_allclose(warped, want, rtol=0, atol=1e-6 * np.abs(want).max())
    for a, b in zip(tpre.distortion_map((40, 50), k1=0.1, p2=0.01),
                    jpre.distortion_map((40, 50), k1=0.1, p2=0.01)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match=r"image must be 2D or 3D \(stack\)."):
        tpre.correct_distortion(np.ones(5), **CPU)
