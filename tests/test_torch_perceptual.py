# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``psnr``, ``ssim`` and ``ms_ssim`` of
``barc4dip_tpu_torch.metrics.perceptual`` against the JAX package's on the
same seeded numpy input (CPU, ``device="cpu"``), with the cases of
``tests/test_perceptual.py``.

Tolerances: float64 pairs against JAX x64 at rtol 1e-9; float32 pairs at
2e-5 (PSNR, a log unit: 2e-4 dB); integer images compute in float32 here
and in float64 in the JAX package under x64, so they are held at 2e-5 too.
"""
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from barc4dip_tpu.metrics import perceptual as j_p
from barc4dip_tpu_torch.metrics import perceptual as t_p
from tests.conftest import make_speckle
from tests.test_perceptual import _np_ssim

torch.set_num_threads(2)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(91)
    clean = make_speckle(rng, shape=(256, 256), grain_px=5.0)
    clean = clean / clean.max()
    return clean, clean + rng.normal(scale=0.05, size=clean.shape)


def rel(kind):
    return 1e-9 if kind == "float64" else 2e-5


@pytest.mark.parametrize("kind", ["float64", "float32"])
@pytest.mark.parametrize("data_range", [None, 1.0])
def test_psnr(pair, kind, data_range):
    clean, noisy = (a.astype(kind) for a in pair)
    got = t_p.psnr(noisy, clean, data_range=data_range, **CPU)
    want = j_p.psnr(noisy, clean, data_range=data_range)
    assert type(got) is float
    assert abs(got - want) <= (1e-9 if kind == "float64" else 2e-4)
    assert t_p.psnr(clean, clean, **CPU) == np.inf == j_p.psnr(clean, clean)
    if data_range == 1.0:
        assert got == pytest.approx(10 * np.log10(1.0 / np.mean((pair[1] - pair[0]) ** 2)), rel=1e-5)


@pytest.mark.parametrize("kind", ["float64", "float32"])
@pytest.mark.parametrize("kw", [{}, dict(data_range=1.0), dict(win_size=11, gaussian_weights=True),
                                dict(win_size=5, gaussian_weights=True, sigma=0.8, k1=0.02, k2=0.05),
                                dict(win_size=3)])
def test_ssim(pair, kind, kw):
    clean, noisy = (a.astype(kind) for a in pair)
    got = t_p.ssim(noisy, clean, **kw, **CPU)
    assert type(got) is float
    assert got == pytest.approx(j_p.ssim(noisy, clean, **kw), rel=rel(kind))
    assert t_p.ssim(clean, clean, **kw, **CPU) == pytest.approx(1.0, abs=1e-6)


def test_ssim_golden_and_ordering(pair):
    clean, noisy = pair
    assert t_p.ssim(noisy, clean, data_range=1.0, **CPU) == pytest.approx(_np_ssim(noisy, clean, 1.0), rel=1e-7)
    a, b = gaussian_filter(clean, 0.5), gaussian_filter(clean, 2.0)
    assert t_p.ssim(a, clean, data_range=1.0, **CPU) > t_p.ssim(b, clean, data_range=1.0, **CPU)


@pytest.mark.parametrize("kind", ["float64", "float32"])
@pytest.mark.parametrize("kw", [dict(levels=3), dict(levels=3, data_range=1.0), dict(levels=2, win_size=7),
                                dict(levels=4, k1=0.02, k2=0.05), dict(levels=1)])
def test_ms_ssim(pair, kind, kw):
    clean, noisy = (a.astype(kind) for a in pair)
    got = t_p.ms_ssim(noisy, clean, **kw, **CPU)
    assert type(got) is float and 0.3 < got < 1.0
    assert got == pytest.approx(j_p.ms_ssim(noisy, clean, **kw), rel=rel(kind))
    assert t_p.ms_ssim(clean, clean, **kw, **CPU) == pytest.approx(1.0, abs=1e-6)


def test_ms_ssim_orders_degradations_and_odd_sides(pair):
    clean, noisy = pair
    v = t_p.ms_ssim(noisy, clean, data_range=1.0, levels=3, **CPU)
    assert t_p.ms_ssim(gaussian_filter(clean, 3.0), clean, data_range=1.0, levels=3, **CPU) < v
    x, y = noisy[:201, :179], clean[:201, :179]  # the 2x2 mean drops the odd row and column
    assert t_p.ms_ssim(x, y, levels=3, **CPU) == pytest.approx(j_p.ms_ssim(x, y, levels=3), rel=1e-9)


def test_mixed_dtype_pairs_do_not_wrap(rng):
    """Each image of a pair is cast on its own: uint16 y*y would wrap."""
    raw = rng.integers(200, 4000, size=(64, 64)).astype(np.uint16)
    as_float = raw.astype(np.float32)
    for x, y in ((as_float, raw), (raw, as_float), (raw, raw), (as_float.astype(np.float64), raw)):
        assert t_p.ssim(x, y, **CPU) == pytest.approx(1.0, abs=1e-6)
        assert t_p.ssim(x, y, **CPU) == pytest.approx(j_p.ssim(x, y), abs=2e-5)
        assert t_p.psnr(x, y, **CPU) > 100.0
    noisy = (as_float + rng.normal(size=raw.shape) * 50).astype(np.float32)
    assert t_p.ssim(noisy, raw, **CPU) == pytest.approx(j_p.ssim(noisy, raw), rel=2e-5)
    assert t_p.psnr(noisy, raw, **CPU) == pytest.approx(j_p.psnr(noisy, raw), abs=2e-4)
    # the default data range is the reference image's
    assert t_p.psnr(noisy, raw, **CPU) == pytest.approx(
        t_p.psnr(noisy, raw, data_range=float(raw.max()) - float(raw.min()), **CPU), abs=1e-6)


def test_tensor_pairs_compute_where_they_live(pair):
    clean, noisy = (torch.from_numpy(a) for a in pair)
    assert t_p.ssim(noisy, clean) == t_p.ssim(pair[1], pair[0], **CPU)
    assert t_p.psnr(noisy, pair[0]) == t_p.psnr(pair[1], pair[0], **CPU)  # the tensor names the device
    assert t_p.ms_ssim(noisy, clean, levels=2) == t_p.ms_ssim(pair[1], pair[0], levels=2, **CPU)


@pytest.mark.parametrize("fn, args, kw", [
    ("ssim", lambda c: (c, c[:-1, :]), {}), ("psnr", lambda c: (c, c[:, :-1]), {}),
    ("ssim", lambda c: (c[None], c[None]), {}), ("ssim", lambda c: (c, c), dict(win_size=4)),
    ("ssim", lambda c: (c, c), dict(win_size=1)), ("ssim", lambda c: (c[:5, :5], c[:5, :5]), dict(win_size=7)),
    ("ms_ssim", lambda c: (c[:32, :32], c[:32, :32]), dict(levels=5)),
])
def test_validation_errors_match_jax(pair, fn, args, kw):
    with pytest.raises(ValueError) as want:
        getattr(j_p, fn)(*args(pair[0]), **kw)
    with pytest.raises(ValueError) as got:
        getattr(t_p, fn)(*args(pair[0]), **kw, **CPU)
    assert str(got.value) == str(want.value)
