# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``barc4dip_tpu_torch.metrics.fourier_ring_correlation``
against the JAX package's on the same seeded numpy input (CPU,
``device="cpu"``), with the cases of ``tests/test_frc.py``.

Both packages compute in complex64 whatever the input, so the curve is held
at 1e-5 absolute; the ring ids (``rint`` of a float32 radius) are held
equal to the JAX program's; the frequency axis exactly; the resolution
within 1e-4 cycles/px (a linear interpolation between two curve samples).
Ring 0 is the DC bin alone: the images are mean-removed, so it holds the
ratio of two round-off values (+1, -1 or NaN, by chance) in both packages
and is not compared; the crossing search skips it too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barc4dip_tpu.metrics import fourier_ring_correlation as j_frc
from barc4dip_tpu.utils.synthetic import speckle_field
from barc4dip_tpu_torch.metrics import fourier_ring_correlation as t_frc
from barc4dip_tpu_torch.metrics import frc as t_mod
from tests.test_frc import _band_limited

torch.set_num_threads(2)
CURVE_ATOL = 1e-5
CPU = {"device": "cpu"}


def same(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["freq"], want["freq"])
    assert got["frc"].dtype == np.float64 and got["frc"].shape == want["frc"].shape
    np.testing.assert_array_equal(np.isnan(got["frc"][1:]), np.isnan(want["frc"][1:]))
    np.testing.assert_allclose(got["frc"][1:], want["frc"][1:], rtol=0, atol=CURVE_ATOL, equal_nan=True)
    assert got["threshold"] == want["threshold"]
    for k in ("resolution_cyc_per_px", "resolution_px"):
        assert type(got[k]) is type(want[k]) or np.isnan(got[k])
        assert (np.isnan(got[k]) and np.isnan(want[k])) or abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k]))


def _jax_ring_ids(H, W):
    """The ring ids as the JAX program forms them (``frc.py::_frc_program``)."""
    nr = min(H, W) // 2
    fy = jnp.fft.fftfreq(H).astype(jnp.float32)[:, None]
    fx = jnp.fft.fftfreq(W).astype(jnp.float32)[None, :]
    rid = jnp.rint(jnp.sqrt(fy * fy + fx * fx) * min(H, W)).astype(jnp.int32)
    return np.asarray(jnp.where(rid < nr, rid, nr)).ravel(), nr


@pytest.mark.parametrize("shape", [(96, 96), (64, 80), (128, 128), (256, 256), (75, 50), (33, 47)])
def test_ring_ids_equal_the_jax_programs(shape):
    rid, nr = t_mod._ring_ids(shape, torch.device("cpu"))
    want, want_nr = _jax_ring_ids(*shape)
    assert nr == want_nr
    np.testing.assert_array_equal(rid.numpy(), want)


@pytest.mark.parametrize("shape", [(96, 96), (64, 80), (75, 50)])
@pytest.mark.parametrize("kind", ["float32", "float64", "uint16"])
@pytest.mark.parametrize("threshold", [0.143, 0.5])
def test_noisy_pairs_against_jax(shape, kind, threshold):
    rng = np.random.default_rng(8)
    sig = speckle_field(shape, grain_px=4.0, seed=0) * 2000 + 300
    a = (sig + rng.normal(size=shape) * 60).astype(kind)
    b = (sig + rng.normal(size=shape) * 60).astype(kind)
    got = t_frc(a, b, threshold=threshold, **CPU)
    same(got, j_frc(a, b, threshold=threshold))
    same(t_frc(torch.from_numpy(a.astype(np.float32)), b.astype(np.float32), threshold=threshold), got)  # the tensor names the device


def test_identical_images_give_unit_frc():
    img = speckle_field((96, 96), grain_px=5.0, seed=0).astype(np.float32)
    out = t_frc(img, img, **CPU)
    assert np.nanmax(np.abs(out["frc"][1:] - 1.0)) < 1e-4
    assert np.isnan(out["resolution_cyc_per_px"]) and np.isnan(out["resolution_px"])
    same(out, j_frc(img, img))


def test_independent_noise_decorrelates():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(128, 128)).astype(np.float32)
    b = rng.normal(size=(128, 128)).astype(np.float32)
    out = t_frc(a, b, **CPU)
    assert np.nanmax(np.abs(out["frc"][20:])) < 0.25
    assert np.nanmean(np.abs(out["frc"][20:])) < 0.08
    same(out, j_frc(a, b))


def test_resolution_tracks_the_common_band_edge():
    n, fc = 256, 0.18
    sig = _band_limited(n, fc, seed=2)
    rng = np.random.default_rng(3)
    scale = sig.std()
    a = sig + rng.normal(size=(n, n)).astype(np.float32) * 0.05 * scale
    b = sig + rng.normal(size=(n, n)).astype(np.float32) * 0.05 * scale
    out = t_frc(a, b, **CPU)
    assert out["frc"][3] > 0.99
    res = out["resolution_cyc_per_px"]
    assert fc - 0.01 <= res <= fc + 0.01, res
    np.testing.assert_allclose(out["resolution_px"], 1.0 / res)
    assert t_frc(a, b, threshold=0.5, **CPU)["resolution_cyc_per_px"] <= res + 1e-9
    same(out, j_frc(a, b))


def test_curve_in_complex128_bounds_the_float32_error():
    """The card check's reference: the same curve computed in complex128."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(64, 64)))
    b = a + 0.5 * torch.from_numpy(rng.normal(size=(64, 64)))
    a, b = a - a.mean(), b - b.mean()
    c64 = t_mod._frc_curve(a.float(), b.float())
    c128 = t_mod._frc_curve(a, b, complex_dtype=torch.complex128)
    assert c64.dtype == torch.float32 and c128.dtype == torch.float64
    np.testing.assert_allclose(c64.numpy()[1:], c128.numpy()[1:], rtol=0, atol=CURVE_ATOL)


def test_verbose_logs_one_line(caplog):
    img = speckle_field((32, 32), grain_px=3.0, seed=1).astype(np.float32)
    with caplog.at_level("INFO", logger="barc4dip_tpu_torch.metrics.frc"):
        t_frc(img, img, verbose=True, **CPU)
    assert len(caplog.records) == 1 and "fourier_ring_correlation: rings=16" in caplog.text


def test_validation_errors_match_jax():
    img = np.ones((16, 16), np.float32)
    for args, kw in (((img[None], img[None]), {}), ((img, np.ones((16, 18), np.float32)), {}),
                     ((img, img), dict(threshold=1.5)), ((img, img), dict(threshold=0.0))):
        with pytest.raises(ValueError) as want:
            j_frc(*args, **kw)
        with pytest.raises(ValueError) as got:
            t_frc(*args, **kw, **CPU)
        assert str(got.value) == str(want.value)
