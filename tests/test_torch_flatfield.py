# SPDX-License-Identifier: CECILL-2.1
"""Flat-field correction, robust ranges and the uint16 conversion: the
port against the JAX package on the same seeded numpy inputs.

``flat_field_correction`` agrees at rtol 1e-6 in float32 (``flat_mean``
sums the valid gain in another order than XLA; the other modes agree
exactly). The median repair is held exactly: a repaired pixel is the 3x3
median (scipy, ``mode="reflect"``) of the port's own zeroed output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from barc4dip_tpu.preprocessing.normalize import flat_field_correction as jax_ffc
from barc4dip_tpu.utils import dtype as jax_dtype
from barc4dip_tpu.utils import range as jax_range
from barc4dip_tpu_torch.ops import cuda_median
from barc4dip_tpu_torch.preprocessing import flat_field_correction as torch_ffc
from barc4dip_tpu_torch.preprocessing import normalize
from barc4dip_tpu_torch.utils import dtype as t_dtype
from barc4dip_tpu_torch.utils import range as t_range

torch.set_num_threads(2)
SIDE = 64
CPU = dict(device="cpu")  # the port runs on the CPU only where it is asked to


def flat_field_correction(images, **kw):
    return torch_ffc(images, **{**CPU, **kw})


def _calibration(seed=0, dead_frac=0.01):
    rng = np.random.default_rng(seed)
    gain = rng.normal(2.0, 0.1, size=(SIDE, SIDE))
    flats = (gain * 1000.0 + 100.0 + rng.normal(0, 3, size=(3, SIDE, SIDE))).astype(np.float32)
    darks = (100.0 + rng.normal(0, 2, size=(2, SIDE, SIDE))).astype(np.float32)
    dead = rng.random((SIDE, SIDE)) < dead_frac
    flats[:, dead] = 90.0  # flat <= dark: a dead pixel
    raw = (rng.poisson(800.0, size=(4, SIDE, SIDE)) * gain + 100.0).astype(np.uint16)
    return raw, flats, darks, dead


@pytest.mark.parametrize("eps", [None, 1e-3])
@pytest.mark.parametrize("bad_pixel_removal", [False, True])
@pytest.mark.parametrize("scale", ["none", "flat_mean", "flat_median"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_matches_jax(ndim, scale, bad_pixel_removal, eps):
    raw, flats, darks, dead = _calibration()
    images = raw if ndim == 3 else raw[0]
    kw = dict(flats=flats, darks=darks, scale=scale, bad_pixel_removal=bad_pixel_removal, eps=eps)
    got = flat_field_correction(images, **kw)
    want = jax_ffc(images, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == images.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if scale != "flat_mean":
        np.testing.assert_array_equal(got, want)
    planes = got.reshape(-1, SIDE, SIDE)
    for p in planes:
        if bad_pixel_removal:
            zeroed = np.where(dead, 0.0, p).astype(np.float32)
            repaired = ndimage.median_filter(zeroed, size=3, mode="reflect")
            np.testing.assert_array_equal(p[dead], repaired[dead])
        else:
            assert np.all(p[dead] == 0.0)


def test_degenerate_paths_match_jax():
    raw, flats, darks, _ = _calibration(seed=1)
    for kw in ({}, {"darks": darks}, {"flats": flats}):
        got = flat_field_correction(raw, **kw)
        np.testing.assert_array_equal(got, jax_ffc(raw, **kw))
        assert got.dtype == np.float32
    copy = flat_field_correction(raw)
    copy[0, 0, 0] = -1.0
    assert raw[0, 0, 0] != -1


def test_residence_follows_the_input():
    raw, flats, darks, _ = _calibration(seed=2)
    out_np = flat_field_correction(raw[0], flats=flats, darks=darks)
    out_t = flat_field_correction(torch.from_numpy(raw[0].astype(np.float32)), flats=flats,
                                  darks=torch.from_numpy(darks))
    assert isinstance(out_np, np.ndarray)
    assert isinstance(out_t, torch.Tensor) and out_t.dtype == torch.float32
    np.testing.assert_array_equal(out_t.numpy(), out_np)
    assert isinstance(flat_field_correction(raw[0], flats=flats, as_numpy=False), torch.Tensor)
    assert isinstance(flat_field_correction(torch.zeros(8, 8), flats=np.ones((8, 8)), as_numpy=True),
                      np.ndarray)


def test_validation_errors_match_jax():
    img = np.zeros((8, 8), np.float32)
    for bad in (dict(scale="median"), dict(flats=np.ones((2, 2, 8, 8)))):
        with pytest.raises(ValueError) as want:
            jax_ffc(img, **bad)
        with pytest.raises(ValueError, match=str(want.value)):
            flat_field_correction(img, **bad)
    with pytest.raises(ValueError, match="2D or 3D"):
        flat_field_correction(np.zeros(8), flats=np.ones(8))


def test_flatfield_on_cpu_launches_nothing():
    raw, flats, darks, _ = _calibration(seed=3)
    cuda_median.reset_counts()
    flat_field_correction(raw, flats=flats, darks=darks, bad_pixel_removal=True)
    assert cuda_median.LAUNCHES == {"median3x3": 0} and cuda_median.PLAIN_BY_SHAPE == {}


def _stacks(kind, seed=6):
    """10 flats and 10 darks as raw counts, in the residence and dtype of ``kind``."""
    rng = np.random.default_rng(seed)
    gain = rng.normal(2.0, 0.1, size=(SIDE, SIDE))
    flats = np.round(gain * 10000.0 + 100.0 + rng.normal(0, 30, size=(10, SIDE, SIDE)))
    darks = np.round(100.0 + rng.normal(0, 2, size=(10, SIDE, SIDE)))
    flats[:, rng.random((SIDE, SIDE)) < 0.01] = 90.0  # flat <= dark: a dead pixel
    if kind == "float32":
        return (flats * 1.001).astype(np.float32), (darks * 1.001).astype(np.float32)
    flats, darks = flats.astype(np.uint16), darks.astype(np.uint16)
    if kind == "torch_uint16":
        return torch.from_numpy(flats), torch.from_numpy(darks)
    return flats, darks


def _host_mean(stack):
    return np.asarray(stack, dtype=np.float32).mean(axis=0)


@pytest.mark.parametrize("which", ["flats_and_darks", "flats_only"])
@pytest.mark.parametrize("kind", ["numpy_uint16", "torch_uint16", "float32"])
def test_stacked_calibration_equals_its_host_float32_means(kind, which):
    raw, *_ = _calibration(seed=7)
    flats, darks = _stacks(kind)
    if which == "flats_only":
        darks = None
    kw = dict(scale="flat_median", bad_pixel_removal=True)
    got = flat_field_correction(raw, flats=flats, darks=darks, **kw)
    want = flat_field_correction(raw, flats=_host_mean(flats),
                                 darks=None if darks is None else _host_mean(darks), **kw)
    if kind == "float32":  # float stacks: the sums round, in another order than numpy's may
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:  # integer counts sum exactly: the quotient is the host's mean bit for bit
        np.testing.assert_array_equal(got, want)


def _images_as(raw, dtype):
    """``raw``'s counts in ``dtype``; the float ones off the integer grid, so
    the float64 -> float32 cast rounds."""
    if dtype.kind == "f":
        return (raw * 1.0007 + 0.3).astype(dtype)
    return raw.astype(dtype)


@pytest.mark.parametrize("bad_pixel_removal", [False, True])
@pytest.mark.parametrize("frames", [None, 4, 7])  # None: one 2D image; 7 is no multiple of the chunk
@pytest.mark.parametrize("dtype", ["<u2", ">u2", "<i2", "<f4", "<f8"])
def test_numpy_images_equal_their_host_float32_copy(dtype, frames, bad_pixel_removal):
    assert 7 % normalize.UPLOAD_CHUNK_FRAMES != 0
    rng = np.random.default_rng(12)
    _, flats, darks, _ = _calibration(seed=12)
    gain = rng.normal(2.0, 0.1, size=(SIDE, SIDE))
    raw = rng.poisson(800.0, size=(frames or 1, SIDE, SIDE)) * gain + 100.0
    images = _images_as(raw if frames else raw[0], np.dtype(dtype))
    kw = dict(flats=flats, darks=darks, bad_pixel_removal=bad_pixel_removal)
    got = flat_field_correction(images, **kw)
    assert normalize.LAST_RUN_PERF["upload_device_frames"] == (frames or 1)
    want = flat_field_correction(np.array(images, dtype=np.float32), **kw)
    assert got.dtype == np.float32 and got.shape == images.shape
    assert got.tobytes() == want.tobytes()

    twin = flat_field_correction(torch.from_numpy(np.array(images, dtype=np.float32)), **kw)
    assert normalize.LAST_RUN_PERF["upload_device_frames"] == 0  # reset; a tensor input is not uploaded
    assert twin.numpy().tobytes() == got.tobytes()
    flat_field_correction(images)  # uncalibrated: the host copy, nothing brought to a device
    assert normalize.LAST_RUN_PERF["upload_device_frames"] == 0


def _range_inputs():
    rng = np.random.default_rng(11)
    frames = rng.gamma(2.0, 300.0, size=(3, 48, 40)).astype(np.float32)
    frames[rng.random(frames.shape) < 0.01] = 60000.0  # hot pixels
    nan_frames = frames.copy()
    nan_frames[rng.random(frames.shape) < 0.01] = np.nan
    return frames, nan_frames


@pytest.mark.parametrize("which", ["plain", "nan"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_ranges_match_jax(which, ndim):
    frames, nan_frames = _range_inputs()
    x = frames if which == "plain" else nan_frames
    x = x if ndim == 3 else x[0]
    assert t_range.filtered_minmax_range(x, **CPU) == jax_range.filtered_minmax_range(x)
    assert (t_range.filtered_minmax_range_streaming(x, **CPU)
            == jax_range.filtered_minmax_range_streaming(x))
    assert t_range.filtered_minmax_range(x, size=5, **CPU) == jax_range.filtered_minmax_range(x, size=5)
    assert t_range.percentile_minmax_range(x, **CPU) == jax_range.percentile_minmax_range(x)
    assert (t_range.percentile_minmax_range(x, 2.0, 98.0, **CPU)
            == jax_range.percentile_minmax_range(x, 2.0, 98.0))


def test_percentile_range_of_counts_matches_jax():
    raw, *_ = _calibration(seed=4)
    assert t_range.percentile_minmax_range(raw, **CPU) == jax_range.percentile_minmax_range(raw)


@pytest.mark.parametrize(
    "fn, bad",
    [("filtered_minmax_range", np.zeros(5)), ("filtered_minmax_range", np.ones((6, 6))),
     ("filtered_minmax_range_streaming", np.zeros((2, 2, 2, 2))),
     ("filtered_minmax_range_streaming", np.full((2, 5, 5), 3.0))],
)
def test_range_errors_match_jax(fn, bad):
    with pytest.raises(ValueError) as want:
        getattr(jax_range, fn)(bad)
    with pytest.raises(ValueError) as got:
        getattr(t_range, fn)(bad, **CPU)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


def test_to_uint16_matches_jax():
    raw, flats, darks, _ = _calibration(seed=5)
    counts = flat_field_correction(raw, flats=flats, darks=darks, scale="flat_mean")
    normalised = flat_field_correction(raw, flats=flats, darks=darks, scale="none")
    assert float(np.mean(normalised)) < 10.0 < float(np.mean(counts))
    for x in (counts, normalised, normalised[0], raw):
        got = t_dtype.to_uint16(x, **CPU)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, jax_dtype.to_uint16(x))
    with pytest.raises(ValueError, match="2D or 3D"):
        t_dtype.to_uint16(np.zeros(4, np.float32), **CPU)
    assert t_dtype.round_uint16_bounds(1234.5, 64999.0) == jax_dtype.round_uint16_bounds(1234.5, 64999.0)
