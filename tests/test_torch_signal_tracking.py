# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``barc4dip_tpu_torch.signal.tracking`` and
``ops.upsampled_dft`` against the JAX package's on the same seeded numpy
input (CPU, ``device="cpu"``).

Tolerances: float64 frames against JAX x64: shifts within 1e-6 px, peak
within 1e-9, snr at rtol 1e-9 (the phase paths round the z-scored template
through float32 in both packages, so they agree like the others); float32
frames: shifts within 1e-3 px, peak within 2e-5, snr at rtol 1e-3; the
upsampled DFT at 1e-9 of its peak.
"""
import numpy as np
import pytest
import torch

from barc4dip_tpu.geometry import roi_slices
from barc4dip_tpu.ops import upsampled_dft as j_up
from barc4dip_tpu.signal import tracking as j_trk
from barc4dip_tpu_torch.ops import upsampled_dft as t_up
from barc4dip_tpu_torch.signal import tracking as t_trk
from tests.conftest import make_speckle
from tests.test_torch_ops import t
from tests.test_tracking import _shifted_frame

torch.set_num_threads(2)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def scene():
    return make_speckle(np.random.default_rng(42), shape=(256, 256), grain_px=8.0)


@pytest.fixture(scope="module")
def noisy():
    """(scene, noise) for the phase paths. The synthetic speckle is
    band-limited: most of its spectrum is round-off, which whitening scales
    up to unit magnitude, so two float64 evaluations that differ in the
    last bit pick different peaks. White noise on both frames (a detector's)
    keeps every bin well above round-off."""
    rng = np.random.default_rng(43)
    base = make_speckle(np.random.default_rng(42), shape=(256, 256), grain_px=8.0)
    sd = 0.05 * base.std()
    return base + sd * rng.normal(size=base.shape), sd * rng.normal(size=base.shape)


def same(got, want, *, px=1e-6, peak=1e-9, snr=1e-9):
    """(dy, dx, peak, snr) tuples of Python floats within the tolerances."""
    assert all(type(v) is float for v in got)
    assert abs(got[0] - want[0]) <= px and abs(got[1] - want[1]) <= px, (got, want)
    for g, w, tol in ((got[2], want[2], peak), (got[3], want[3], snr * abs(want[3]))):
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= tol, (got, want)


@pytest.mark.parametrize("shift", [(3, -5), (0, 0), (2.3, -1.7), (-0.4, 3.6)])
@pytest.mark.parametrize("backend", ["opencv", "skimage"])
@pytest.mark.parametrize("subpixel", [True, False])
def test_template_matching(scene, shift, backend, subpixel):
    frame = _shifted_frame(scene, *shift)
    sl = roi_slices(scene.shape, (61, 61))
    tpl = scene[sl[0], sl[1]]
    kw = dict(slices_yx=sl, backend=backend, subpixel=subpixel)
    got = t_trk.template_matching(tpl, frame, **kw, **CPU)
    same(got, j_trk.template_matching(tpl, frame, **kw))
    assert abs(got[0] - shift[0]) <= (0.15 if subpixel else 0.5)
    assert abs(got[1] - shift[1]) <= (0.15 if subpixel else 0.5)
    assert got[2] > 0.9 and got[3] > 5


@pytest.mark.parametrize("side", [32, 64, (40, 33)])
def test_template_matching_even_templates_default_position(scene, side):
    """No ``slices_yx``: the template sits centred, also with even sides."""
    h, w = (side, side) if isinstance(side, int) else side
    frame = _shifted_frame(scene, 1.25, -2.5)
    y0, x0 = (256 - h) // 2, (256 - w) // 2
    tpl = scene[y0 : y0 + h, x0 : x0 + w]
    got = t_trk.template_matching(tpl, frame, **CPU)
    same(got, j_trk.template_matching(tpl, frame))
    assert abs(got[0] - 1.25) <= 0.15 and abs(got[1] + 2.5) <= 0.15


def test_template_matching_off_centre_roi_and_reference_convention(scene):
    frame = _shifted_frame(scene, 5.0, 7.0)
    sl = roi_slices(scene.shape, (41, 41), center_yx=(100, 90))
    tpl = scene[sl[0], sl[1]]
    for conv in ("newton", "reference"):
        kw = dict(slices_yx=sl, subpixel_convention=conv)
        same(t_trk.template_matching(tpl, frame, **kw, **CPU), j_trk.template_matching(tpl, frame, **kw))


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_template_matching_float32_and_integer_frames(scene, dtype):
    frame = (_shifted_frame(scene, 2.3, -1.7) * 4000).astype(dtype)
    sl = roi_slices(scene.shape, (61, 61))
    tpl = (scene * 4000).astype(dtype)[sl[0], sl[1]]
    got = t_trk.template_matching(tpl, frame, slices_yx=sl, **CPU)
    want = j_trk.template_matching(tpl.astype(np.float32), frame.astype(np.float32), slices_yx=sl)
    same(got, want, px=1e-3, peak=2e-5, snr=1e-3)


def test_template_matching_tensors_and_mixed_dtypes(scene):
    frame = _shifted_frame(scene, 3, -5)
    sl = roi_slices(scene.shape, (61, 61))
    tpl = scene[sl[0], sl[1]]
    want = t_trk.template_matching(tpl, frame, slices_yx=sl, **CPU)
    assert t_trk.template_matching(t(tpl), t(frame), slices_yx=sl) == want
    assert t_trk.template_matching(tpl, t(frame), slices_yx=sl) == want  # the tensor names the device
    mixed = t_trk.template_matching(tpl.astype(np.float32), frame, slices_yx=sl, **CPU)
    same(mixed, want, px=1e-4, peak=1e-6, snr=1e-5)


@pytest.mark.parametrize("shift", [(6, -9), (0, 0), (1.4, -2.6)])
@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("backend", ["internal", "skimage"])
def test_phase_correlation(noisy, shift, subpixel, backend):
    scene, noise = noisy
    frame = _shifted_frame(scene, *shift) + noise
    sl = roi_slices(scene.shape, (101, 101))
    tpl = scene[sl[0], sl[1]]
    kw = dict(slices_yx=sl, backend=backend, subpixel=subpixel)
    got = t_trk.phase_correlation(tpl, frame, **kw, **CPU)
    same(got, j_trk.phase_correlation(tpl, frame, **kw))
    assert abs(got[0] - shift[0]) <= 0.75 and abs(got[1] - shift[1]) <= 0.75
    assert np.isnan(got[2]) == (backend == "skimage") and np.isnan(got[3]) == (backend == "skimage")


def test_phase_correlation_default_position_even_template_and_conventions(noisy):
    scene, noise = noisy
    frame = _shifted_frame(scene, 2.0, -3.0) + noise
    tpl = scene[64:192, 64:192]  # 128 px: centred by default
    for conv in ("newton", "reference"):
        got = t_trk.phase_correlation(tpl, frame, subpixel_convention=conv, **CPU)
        same(got, j_trk.phase_correlation(tpl, frame, subpixel_convention=conv))
    f32 = t_trk.phase_correlation(tpl.astype(np.float32), frame.astype(np.float32), **CPU)
    want = j_trk.phase_correlation(tpl.astype(np.float32), frame.astype(np.float32))
    same(f32, want, px=1e-3, peak=2e-5, snr=1e-3)


@pytest.mark.parametrize("method, backend", [
    ("template", "internal"), ("template", "skimage"), (" Template ", "opencv"),
    ("phase", "internal"), ("PHASE", "skimage"),
])
def test_track_translation_dispatch(noisy, method, backend):
    scene, noise = noisy
    frame = _shifted_frame(scene, 2, 2) + noise
    sl = roi_slices(scene.shape, (61, 61))
    tpl = scene[sl[0], sl[1]]
    kw = dict(slices_yx=sl, method=method, backend=backend)
    got = t_trk.track_translation(tpl, frame, **kw, **CPU)
    same(got, j_trk.track_translation(tpl, frame, **kw))
    direct = t_trk._TRACKERS[method.strip().lower()](tpl, frame, slices_yx=sl, backend=backend, **CPU)
    np.testing.assert_equal(got, direct)


def test_registry_and_validation_messages_match_jax(scene):
    assert sorted(t_trk._TRACKERS) == sorted(j_trk._TRACKERS) == ["phase", "template"]
    tpl, frame = scene[:61, :61], scene
    cases = [
        ("track_translation", (tpl, frame), dict(method="bogus")),
        ("template_matching", (tpl, frame), dict(backend="bogus")),
        ("phase_correlation", (tpl, frame), dict(backend="bogus")),
        ("template_matching", (frame, tpl), {}),  # the template does not fit
        ("template_matching", (tpl[0], frame), {}),
        ("phase_correlation", (tpl, frame[None]), {}),
    ]
    for fn, args, kw in cases:
        with pytest.raises(ValueError) as want:
            getattr(j_trk, fn)(*args, **kw)
        with pytest.raises(ValueError) as got:
            getattr(t_trk, fn)(*args, **kw, **CPU)
        assert str(got.value) == str(want.value)


def test_centered_slices_equal_jax():
    for H, W, h, w in ((256, 256, 61, 61), (256, 200, 32, 64), (101, 77, 40, 33)):
        assert t_trk._centered_slices(H, W, h, w) == j_trk._centered_slices(H, W, h, w)


# -- ops.upsampled_dft ------------------------------------------------------------

@pytest.mark.parametrize("upsample", [1, 10, 50])
def test_phase_cross_correlation_upsampled(rng, upsample):
    field = make_speckle(rng, shape=(128, 96), grain_px=5.0)
    moved = _shifted_frame(field, -1.35, 2.15)
    dy, dx = t_up.phase_cross_correlation_upsampled(t(field), t(moved), upsample_factor=upsample)
    jy, jx = j_up.phase_cross_correlation_upsampled(field, moved, upsample_factor=upsample)
    assert abs(float(dy) - float(jy)) <= 1e-6 and abs(float(dx) - float(jx)) <= 1e-6
    tol = 0.5 if upsample == 1 else 1.5 / upsample
    assert abs(float(dy) - 1.35) <= tol and abs(float(dx) + 2.15) <= tol


@pytest.mark.parametrize("shape", [(32, 32), (31, 40)])
def test_upsampled_dft_kernel_products(rng, shape):
    data = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    offsets = np.array([3.5, -2.25])
    got = t_up.upsampled_dft(t(data), 15, 10, t(offsets)).numpy()
    want = np.asarray(j_up.upsampled_dft(data, 15, 10, offsets))
    assert got.shape == (15, 15)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    # complex64 holds against complex128 at float32 round-off
    got32 = t_up.upsampled_dft(t(data.astype(np.complex64)), 15, 10, t(offsets.astype(np.float32)))
    assert got32.dtype == torch.complex64
    np.testing.assert_allclose(got32.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_upsampled_peak_is_the_row_major_first_maximum():
    """A flat correlation (reference == moving == one pixel) has every
    upsampled sample equal in magnitude: the first one wins, as
    ``jnp.argmax`` picks it."""
    img = np.zeros((16, 16))
    img[0, 0] = 1.0
    dy, dx = t_up.phase_cross_correlation_upsampled(t(img), t(img), upsample_factor=10)
    jy, jx = j_up.phase_cross_correlation_upsampled(img, img, upsample_factor=10)
    assert (float(dy), float(dx)) == (float(jy), float(jx))
