# SPDX-License-Identifier: CECILL-2.1
"""The XST slice as a whole, through both packages on the same seeded
numpy data: raw uint16 frames -> ``flat_field_correction`` with bad-pixel
repair -> dense tracking -> wavefront (``WavefrontScanPipeline``).

A 192^2 reference speckle is warped by a parabolic wavefront plus a
uniform per-frame shift (T = 5), then turned into detector counts with a
gain flat, a dark offset and ~0.1% dead pixels. Bounds: the JAX XST test's
own, atol 5e-4 px for dy/dx and 1e-4 for the peak; the wavefront and phase
within 1e-3 of their max; the grid and ``meta`` identical."""
import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

import barc4dip_tpu.maths as jmaths
import barc4dip_tpu.models as jmodels
import barc4dip_tpu.preprocessing.normalize as jnorm
import barc4dip_tpu.signal as jsignal
import barc4dip_tpu_torch.maths as tmaths
import barc4dip_tpu_torch.models as tmodels
import barc4dip_tpu_torch.preprocessing as tprep
import barc4dip_tpu_torch.signal as tsignal
from barc4dip_tpu_torch.utils import speckle_field, speckle_stack

torch.set_num_threads(2)
SIDE, T = 192, 5
PIXEL, DIST, R = 1e-6, 0.5, 20.0
SHIFTS = [(0.0, 0.0), (0.6, -0.4), (-0.9, 0.3), (0.2, 1.1), (-0.5, -0.8)]
PIPE = dict(pixel_size=PIXEL, distance=DIST, wavelength=1e-10, tile_size=25, step=16,
            search_radius=5)
CPU = dict(device="cpu")  # the port runs on the CPU only where it is asked to


def _torch_ffc(images, **kw):
    return tprep.flat_field_correction(images, **CPU, **kw)


def _warp(img, dy, dx):
    yy, xx = np.mgrid[0:SIDE, 0:SIDE].astype(np.float64)
    return map_coordinates(img, [yy - dy, xx - dx], order=3, mode="reflect")


def _parabola_displacement(y, x):
    """Displacement [px] of a spherical wavefront of radius R at (y, x)."""
    c = SIDE / 2
    return (y - c) * DIST / R, (x - c) * DIST / R


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(2024)
    ref = speckle_field((SIDE, SIDE), grain_px=3.0, mean_counts=3000.0, seed=rng,
                        dtype=np.float64)
    yy, xx = np.mgrid[0:SIDE, 0:SIDE].astype(np.float64)
    py, px = _parabola_displacement(yy, xx)
    frames = np.stack([_warp(ref, py + sy, px + sx) for sy, sx in SHIFTS])
    gain = rng.normal(2.0, 0.1, size=(SIDE, SIDE))
    dead = rng.random((SIDE, SIDE)) < 1e-3
    dead[50, 60] = True
    flats = (gain * 3000.0 + 100.0 + rng.normal(0, 5, size=(2, SIDE, SIDE))).astype(np.float32)
    flats[:, dead] = 95.0
    darks = (100.0 + rng.normal(0, 2, size=(3, SIDE, SIDE))).astype(np.float32)

    def counts(x):
        return np.clip(np.round(np.clip(x, 0, None) * gain + 100.0), 0, 65535).astype(np.uint16)

    return counts(ref), counts(frames), flats, darks, dead


def _corrected(pkg_ffc, raw):
    ref, frames, flats, darks, _ = raw
    kw = dict(flats=flats, darks=darks, bad_pixel_removal=True)
    return pkg_ffc(frames, **kw), pkg_ffc(ref, **kw)


def _compare_fields(got, want, keys=("dy", "dx", "peak")):
    for k in keys:
        tol = 1e-4 if k == "peak" else 5e-4
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got["x"], want["x"])
    assert got["meta"] == want["meta"]


def _compare_wavefronts(got, want):
    for k in ("slope_y", "slope_x"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-4 * PIXEL / DIST, err_msg=k)
    for k in ("wavefront", "phase"):
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-3 * scale, k


def test_flatfield_repairs_dead_pixels_like_jax(raw):
    t_stack, t_ref = _corrected(_torch_ffc, raw)
    j_stack, j_ref = _corrected(jnorm.flat_field_correction, raw)
    np.testing.assert_array_equal(t_stack, j_stack)
    np.testing.assert_array_equal(t_ref, j_ref)
    assert np.all(t_stack[:, raw[4]] > 0)  # repaired, not left at zero


def test_wavefront_scan_matches_jax(raw):
    t_stack, t_ref = _corrected(_torch_ffc, raw)
    j_stack, j_ref = _corrected(jnorm.flat_field_correction, raw)
    got = tmodels.WavefrontScanPipeline(**PIPE, **CPU)(t_stack, t_ref)
    want = jmodels.WavefrontScanPipeline(**PIPE)(j_stack, j_ref)
    assert got["meta"]["method"] == "fft"
    assert got["dy"].shape == (T, *got["meta"]["grid_shape"])
    _compare_fields(got, want)
    _compare_wavefronts(got, want)

    # the known motion, at the interior nodes
    Y, X = np.meshgrid(got["y"], got["x"], indexing="ij")
    py, px = _parabola_displacement(Y, X)
    for t, (sy, sx) in enumerate(SHIFTS):
        assert abs(np.median((got["dy"][t] - py - sy)[2:-2, 2:-2])) < 0.05
        assert abs(np.median((got["dx"][t] - px - sx)[2:-2, 2:-2])) < 0.05


def test_single_frame_matches_jax(raw):
    t_stack, t_ref = _corrected(_torch_ffc, raw)
    got = tmodels.WavefrontScanPipeline(**PIPE, **CPU)(t_stack[2], t_ref)
    want = jmodels.WavefrontScanPipeline(**PIPE)(t_stack[2], t_ref)
    _compare_fields(got, want)
    _compare_wavefronts(got, want)
    with pytest.raises(ValueError, match="reference"):
        tmodels.WavefrontScanPipeline(**PIPE, **CPU)(t_stack[2])


def test_frame_batched_pallas_path_matches_jax(raw):
    """method="pallas", frame_batch=2 over T=5 frames: the padded tail."""
    t_stack, t_ref = _corrected(_torch_ffc, raw)
    kw = dict(tile_size=25, step=16, search_radius=5, method="pallas", frame_batch=2)
    got = tsignal.track_displacement_stack(t_stack, t_ref, **CPU, **kw)
    want = jsignal.track_displacement_stack(t_stack, t_ref, **kw)
    assert got["meta"]["frame_batch"] == 2 and got["dy"].shape[0] == T
    _compare_fields(got, want)
    wf = dict(pixel_size=PIXEL, distance=DIST, wavelength=1e-10)
    _compare_wavefronts(tsignal.wavefront_from_displacements(got, **wf),
                        jsignal.wavefront_from_displacements(want, **wf))
    # frame by frame, the batched FFTs round differently: float32 round-off
    per_frame = tsignal.track_displacement_stack(t_stack, t_ref, **{**kw, **CPU, "frame_batch": 1})
    for k in ("dy", "dx", "peak"):
        np.testing.assert_allclose(per_frame[k], got[k], rtol=0, atol=1e-5)


def test_tensor_inputs_give_the_same_field(raw):
    t_stack, t_ref = _corrected(_torch_ffc, raw)
    kw = dict(tile_size=25, step=16, search_radius=5)
    a = tsignal.track_displacement_field(t_stack[1], t_ref, **CPU, **kw)
    b = tsignal.track_displacement_field(torch.from_numpy(t_stack[1]), torch.from_numpy(t_ref), **kw)
    for k in ("dy", "dx", "peak"):
        np.testing.assert_array_equal(a[k], b[k])


def test_integrate_gradients_float64_matches_jax():
    rng = np.random.default_rng(6)
    gy, gx = rng.normal(size=(2, 24, 31))
    for kw in ({}, {"dy": 0.5, "dx": 2.0}):
        got = tmaths.integrate_gradients(gy, gx, **kw)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(jmaths.integrate_gradients(gy, gx, **kw)),
                                   rtol=1e-9, atol=1e-12)
    ints = tmaths.integrate_gradients(np.ones((4, 4), np.int64), np.zeros((4, 4), np.int32))
    assert ints.dtype == torch.float32


@pytest.mark.parametrize(
    "args, kw",
    [((np.zeros((4, 4)), np.zeros((4, 5))), {}),
     ((np.zeros((4, 4)), np.zeros((4, 4))), {"dy": 0.0}),
     ((np.zeros((4, 4)), np.zeros((4, 4))), {"dx": np.inf}),
     ((np.zeros(4), np.zeros(4)), {})],
)
def test_integrate_gradients_validation_matches_jax(args, kw):
    with pytest.raises(ValueError) as want:
        jmaths.integrate_gradients(*args, **kw)
    with pytest.raises(ValueError) as got:
        tmaths.integrate_gradients(*args, **kw)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def test_validation_and_unported_entry_points(tmp_path):
    a = np.zeros((64, 64))
    with pytest.raises(ValueError, match="equal-shape"):
        tsignal.track_displacement_field(a, np.zeros((64, 32)), **CPU)
    with pytest.raises(ValueError, match="too small"):
        tsignal.track_displacement_field(a, a, tile_size=48, search_radius=16, **CPU)
    with pytest.raises(ValueError, match="3D"):
        tsignal.track_displacement_stack(a, **CPU)
    with pytest.raises(ValueError, match="ref shape"):
        tsignal.track_displacement_stack(np.zeros((2, 64, 64)), ref=a[:32], **CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tsignal.track_displacement_stack(np.zeros((2, 64, 64)), mesh=object(), **CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tmodels.WavefrontScanPipeline(pixel_size=1e-6, distance=1.0, mesh=object(), **CPU)(
            np.zeros((2, 64, 64)))
    # the file-driven entry points run: frames from disk equal frames from memory
    from barc4dip_tpu_torch.io import save_edf, save_h5

    stack = speckle_stack(3, (160, 160), seed=np.random.default_rng(8), dtype=np.float32,
                          mean_counts=3000.0)
    paths = []
    for t, frame in enumerate(stack):
        paths.append(str(tmp_path / f"f{t}.edf"))
        save_edf(frame, paths[-1])
    wf = tmodels.WavefrontScanPipeline(pixel_size=1e-6, distance=1.0, tile_size=17,
                                       search_radius=4, **CPU)
    from_files, in_memory = wf.run_files(paths), wf(stack)
    for k in ("dy", "dx", "peak", "wavefront"):
        np.testing.assert_array_equal(from_files[k], in_memory[k])
    save_h5(stack, tmp_path / "run.h5")
    pipe = tmodels.SpeckleStackPipeline(metrics="amplitude", tiles=False, frame_chunk=2, **CPU)
    in_memory = pipe(stack)
    for name, arg in (("run_files", paths), ("run_edf_files", paths),
                      ("run_hdf5", str(tmp_path / "run.h5"))):
        out = getattr(pipe, name)(arg)
        np.testing.assert_array_equal(out["temporal"]["abs"]["dx"], in_memory["temporal"]["abs"]["dx"])
        np.testing.assert_array_equal(out["full"]["amplitude"]["visibility"],
                                      in_memory["full"]["amplitude"]["visibility"])
    with pytest.raises(ValueError, match="positive"):
        tmodels.WavefrontScanPipeline(pixel_size=0.0, distance=1.0)
    field = {"dy": np.zeros((4, 4)), "dx": np.zeros((4, 4)), "meta": {"step": 16}}
    with pytest.raises(ValueError, match="positive"):
        tsignal.wavefront_from_displacements(field, pixel_size=1e-6, distance=1.0, wavelength=-1.0)


def test_speckle_stack_pipeline_flatfields_then_matches_jax():
    stack = speckle_stack(3, (192, 192), seed=np.random.default_rng(5), dtype=np.uint16,
                          mean_counts=4000.0)
    rng = np.random.default_rng(6)
    flats = rng.normal(1000.0, 10.0, size=(2, 192, 192)).astype(np.float32)
    darks = rng.normal(50.0, 1.0, size=(192, 192)).astype(np.float32)
    kw = dict(metrics="amplitude,stats", tiles=False, frame_chunk=2)
    got = tmodels.SpeckleStackPipeline(**kw, **CPU)(stack, flats=flats, darks=darks)
    want = jmodels.SpeckleStackPipeline(**kw)(stack, flats=flats, darks=darks)
    for g in ("amplitude", "stats"):
        for f, v in want["full"][g].items():
            np.testing.assert_allclose(got["full"][g][f], v, rtol=1e-4, atol=1e-6, err_msg=f"{g}.{f}")
    for f in ("dx", "dy"):
        np.testing.assert_allclose(got["temporal"]["abs"][f], want["temporal"]["abs"][f], atol=1e-3)
