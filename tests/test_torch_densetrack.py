# SPDX-License-Identifier: CECILL-2.1
"""Kernel K3's module on the CPU: the port's dense tracking (``ops/
densetrack.py``, ``ops/cuda_densetrack.py``) against the JAX package on the
same seeded inputs.

- K3's plain sums against the JAX Pallas kernel in interpret mode: 1e-5 of
  each output's max (float32 sums in another order);
- ``fft`` tracking in float64: rtol 1e-9;
- ``pallas`` (JAX interpreted) and ``conv`` against ``fft``: the JAX test's
  own bounds, atol 5e-4 px for dy/dx and 1e-4 for the peak."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

from barc4dip_tpu.ops import densetrack as jd
from barc4dip_tpu_torch.ops import cuda_densetrack
from barc4dip_tpu_torch.ops import densetrack as td
from barc4dip_tpu_torch.utils import speckle_field

torch.set_num_threads(2)
EPS = float(np.float32(1e-9))


@pytest.fixture(scope="module")
def pair():
    base = speckle_field((112, 112), grain_px=3.0, seed=21, dtype=np.float64, precision="double")
    yy, xx = np.mgrid[0:112, 0:112].astype(np.float64)
    img = map_coordinates(base, [yy - 0.7 - 0.01 * (yy - 56), xx + 0.55 + 0.008 * (xx - 56)],
                          order=3, mode="reflect")
    return img, base


def test_plain_sums_match_pallas_kernel_interpreted():
    rng = np.random.default_rng(4)
    s, r, N = 9, 3, 200
    w = s + 2 * r
    t_nl = rng.normal(size=(s, s, N))
    t_nl -= t_nl.mean(axis=(0, 1), keepdims=True)
    w_nl = rng.normal(size=(w, w, N))
    pad = ((0, 0), (0, 0), (0, 256 - N))
    want = jd._pallas_ncc_sums(
        jnp.asarray(np.pad(t_nl, pad, mode="edge").astype(np.float32)),
        jnp.asarray(np.pad(w_nl, pad, mode="edge").astype(np.float32)),
        s, w, r, True,
    )
    got = cuda_densetrack.ncc_sums_plain(
        torch.from_numpy(np.moveaxis(t_nl, -1, 0).astype(np.float32)),
        torch.from_numpy(np.moveaxis(w_nl, -1, 0).astype(np.float32)), r,
    )
    for name, g, wv in zip(("num", "s1", "s2"), got, want):
        wv = np.asarray(wv)[..., :N]
        g = np.moveaxis(g.numpy(), 0, -1)
        assert g.shape == wv.shape == (2 * r + 1, 2 * r + 1, N)
        assert np.abs(g - wv).max() <= 1e-5 * np.abs(wv).max(), name


def test_wrapper_reads_the_grid_from_the_images(pair):
    """``ncc_sums`` on images (the kernel's interface) equals the plain sums
    of the gathered tiles and windows, for one frame and for a batch."""
    img, base = (torch.from_numpy(a.astype(np.float32)) for a in pair)
    y0s, x0s = td.grid_starts(112, 112, 13, 4, 10)
    frames = torch.stack([img, base, img.flip(0)])
    num, s1, s2 = cuda_densetrack.ncc_sums(base, frames, y0s, x0s, 13, 4)
    N = len(y0s) * len(x0s)
    assert num.shape == (3 * N, 9, 9) and num.dtype == torch.float32
    t, wins = cuda_densetrack.grid_windows(base, frames, y0s, x0s, 13, 4)
    assert torch.equal(wins[N + 5], base[y0s[0] - 4:y0s[0] + 17, x0s[5] - 4:x0s[5] + 17])
    for a, b in zip((num, s1, s2), cuda_densetrack.ncc_sums_plain(t, wins, 4)):
        assert torch.equal(a, b)
    one = cuda_densetrack.ncc_sums(base, img, y0s, x0s, 13, 4)
    assert torch.equal(one[0], num[:N])
    with pytest.raises(ValueError, match="leaves"):
        cuda_densetrack.ncc_sums(base, img, y0s - 1, x0s, 13, 4)


def test_grid_starts_identical():
    for args in [(112, 112, 13, 4, 10), (2048, 2048, 33, 10, 16), (96, 130, 17, 4, 24)]:
        for a, b in zip(td.grid_starts(*args), jd.grid_starts(*args)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for bad in [(64, 64, 2, 4, 8), (64, 64, 9, 0, 8), (64, 64, 9, 4, 0), (64, 64, 48, 16, 8)]:
        with pytest.raises(ValueError) as want:
            jd.grid_starts(*bad)
        with pytest.raises(ValueError, match=str(want.value).replace("(", r"\(").replace(")", r"\)")):
            td.grid_starts(*bad)


@pytest.mark.parametrize("subpixel", [False, True])
def test_node_peaks_match_node_last(subpixel):
    rng = np.random.default_rng(8)
    r, N = 4, 300
    L = 2 * r + 1
    corr = rng.normal(size=(N, L, L))
    corr[:5, 0, 3] = 10.0     # peaks on the border keep the integer peak
    corr[5:10, 4, L - 1] = 10.0
    corr[10:12] = 1.0         # flat maps: first occurrence, det == 0
    dy, dx, peak = td.peaks_node_first(torch.from_numpy(corr), r, subpixel)
    jy, jx, jp = jd._peaks_node_last(jnp.asarray(np.moveaxis(corr, 0, -1)), r, subpixel)
    np.testing.assert_array_equal(np.round(dy.numpy()), np.round(np.asarray(jy)))
    for a, b in ((dy, jy), (dx, jx), (peak, jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    assert np.all(dy.numpy()[:5] == -r) and np.all(dx.numpy()[:5] == 3 - r)


@pytest.mark.parametrize("subpixel", [False, True])
def test_fft_tracking_float64_matches_jax(pair, subpixel):
    img, base = pair
    kw = (112, 112, 13, 4, 10, subpixel)
    jp, jgrid = jd.dense_track_program(*kw, method="fft")
    tp, tgrid = td.dense_track_program(*kw, method="fft")
    want = jp(jnp.asarray(img), jnp.asarray(base), jnp.asarray(1e-9, jnp.float32))
    got = tp(torch.from_numpy(img), torch.from_numpy(base), EPS)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)
    for a, b in zip(tgrid, jgrid):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pallas_and_conv_match_fft_and_jax_pallas(pair, dtype):
    img, base = (a.astype(dtype) for a in pair)
    kw = (112, 112, 13, 4, 10, True)
    ref, _ = td.dense_track_program(*kw, method="fft")
    a = [v.numpy() for v in ref(torch.from_numpy(img), torch.from_numpy(base), EPS)]
    jp, _ = jd.dense_track_program(*kw, method="pallas")
    j = [np.asarray(v) for v in jp(jnp.asarray(img), jnp.asarray(base), jnp.asarray(1e-9, jnp.float32))]
    cuda_densetrack.reset_counts()
    for method in ("pallas", "conv"):
        tp, _ = td.dense_track_program(*kw, method=method)
        b = [v.numpy() for v in tp(torch.from_numpy(img), torch.from_numpy(base), EPS)]
        for want in (a, j):
            np.testing.assert_allclose(b[0], want[0], rtol=0, atol=5e-4, err_msg=method)
            np.testing.assert_allclose(b[1], want[1], rtol=0, atol=5e-4, err_msg=method)
            np.testing.assert_allclose(b[2], want[2], rtol=0, atol=1e-4, err_msg=method)
        assert b[0].dtype == dtype
    assert cuda_densetrack.LAUNCHES == {"ncc_sums": 0} and cuda_densetrack.PLAIN_BY_SHAPE == {}


def test_stack_program_matches_jax_interpreted(pair):
    img, base = (a.astype(np.float32) for a in pair)
    frames = np.stack([img, base, np.roll(img, 1, axis=1)])
    kw = (112, 112, 13, 4, 10, True, 3)
    jp, _ = jd.dense_track_stack_program(*kw)
    tp, _ = td.dense_track_stack_program(*kw)
    want = jp(jnp.asarray(frames), jnp.asarray(base), jnp.asarray(1e-9, jnp.float32))
    got = tp(torch.from_numpy(frames), torch.from_numpy(base), EPS)
    gy, gx = (len(v) for v in td.grid_starts(112, 112, 13, 4, 10))
    for g, w, tol in zip(got, want, (5e-4, 5e-4, 1e-4)):
        assert g.shape == (3, gy, gx)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


def test_methods_resolve_and_bogus_raises():
    assert td.resolve_track_method("auto", "cpu") == "fft"
    assert td.resolve_track_method("auto", "cuda") == "pallas"
    assert td.resolve_track_method("conv") == jd.resolve_track_method("conv")
    with pytest.raises(ValueError, match="method"):
        td.resolve_track_method("bogus")
    with pytest.raises(ValueError, match="method"):
        td.dense_track_program(64, 64, 9, 4, 8, True, method="bogus")
