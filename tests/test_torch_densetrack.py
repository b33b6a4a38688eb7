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


def _kernel_model(tile, win, s, r):
    """K3's arithmetic as ``csrc/densetrack_sums.cu`` orders it, in float64
    numpy: the numerator by each thread's 7-wide strip sliding a 12-value
    ring along the window rows, in parts of tile rows whose sums meet at
    the end; s1 and s2 as row sums then column sums, each run's first sum
    direct and the next ones sliding. A read past the kernel's shared
    arrays raises."""
    S, R = cuda_densetrack.STRIP, cuda_densetrack.RING
    L, w = 2 * r + 1, s + 2 * r
    lay = cuda_densetrack.launch_layout(s, r)
    tp = np.zeros((s, lay.sp))
    tp[:, :s] = tile - tile.mean()
    wpad = np.zeros((w, lay.wp))
    wpad[:, :w] = win

    def slide(x, n, step, guard):
        """Slide a ring over x(m), the value at offset m of each task's row,
        calling step(b, k, ring) for each of the n steps (guarded or not)."""
        ring = np.zeros(x(0).shape + (R,))
        for j in range(S - 1):
            ring[..., j] = x(j)
        for b0 in range(0, n, R):
            for k in range(R):
                if guard and b0 + k >= n:
                    continue
                ring[..., (k + S - 1) % R] = x(b0 + k + S - 1)
                step(b0 + k, k, ring)

    u, v0 = cuda_densetrack.strip_tasks(L)
    rows = -(-s // lay.ksplit)
    acc = np.zeros((len(u), S))
    for a0 in range(0, s, rows):  # the parts' sums meet at the end, in order
        part = np.zeros_like(acc)
        for a in range(a0, min(s, a0 + rows)):
            def step(b, k, ring, a=a):
                for j in range(S):
                    part[:, j] += ring[:, (k + j) % R] * tp[a, b]
            slide(lambda m, a=a: wpad[u + a, v0 + m], lay.sp, step, guard=False)
        acc += part
    num = np.full((L, L), np.nan)
    for t in range(len(u)):
        for j in range(S):
            if v0[t] + j < L:
                assert np.isnan(num[u[t], v0[t] + j])  # each offset once
                num[u[t], v0[t] + j] = acc[t, j]

    def box_run(x, n, count):
        """x(m) -> the values at offset m of each task's run: the first sum
        direct, each next one sliding by one, as the kernel's box_run."""
        out = np.empty(x(0).shape + (count,))
        acc = sum(x(b) for b in range(n))
        out[..., 0] = acc
        for m in range(1, count):
            acc = acc + (x(m + n - 1) - x(m - 1))
            out[..., m] = acc
        return out

    y = np.arange(w)
    rs1 = box_run(lambda m: wpad[y, m], s, L)                       # (w, L)
    rs2 = box_run(lambda m: wpad[y, m] ** 2, s, L)
    out = [box_run(lambda m, rs=rs: rs[m, :], s, L).T for rs in (rs1, rs2)]
    return num, out[0], out[1]


@pytest.mark.parametrize("s, r", [(33, 10), (21, 7), (9, 3), (13, 4), (5, 1)])
def test_kernel_arithmetic_model_matches_direct_sums(s, r):
    """The kernel's strip partition covers every offset once, and its ring
    numerator and separable sliding box sums equal the direct float64
    sums."""
    rng = np.random.default_rng(s * 100 + r)
    w, L = s + 2 * r, 2 * r + 1
    tile, win = rng.normal(size=(s, s)), rng.normal(size=(w, w))
    got = _kernel_model(tile, win, s, r)
    t = tile - tile.mean()
    want = [np.empty((L, L)) for _ in range(3)]
    for u in range(L):
        for v in range(L):
            x = win[u:u + s, v:v + s]
            want[0][u, v], want[1][u, v], want[2][u, v] = (x * t).sum(), x.sum(), (x * x).sum()
    for name, g, wv in zip(("num", "s1", "s2"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, wv, rtol=1e-12, atol=1e-12 * np.abs(wv).max(), err_msg=name)


def test_layout_covers_config_f_without_conflicts():
    """Config F (33-px tiles, radius 10): 63 strips, the tile rows in 2
    parts of 2 warps, under the 48 KB of shared memory that needs no
    opt-in, at any number of frames (the blocks loop over them), with no
    bank conflict on the numerator's window loads;
    larger geometries opt in up to 227 KB, and those past it or past 256
    threads are not covered."""
    lay = cuda_densetrack.launch_layout(33, 10)
    assert (lay.nstrip, lay.lp, lay.sp, lay.tpp, lay.ksplit, lay.threads) == (3, 21, 36, 64, 2, 128)
    assert lay.wp >= lay.lp + lay.sp - 1 and lay.smem <= 48 * 1024
    assert cuda_densetrack._bank_conflicts(33, 21, 64, 2, lay.wp) == 4  # one wavefront a warp
    assert cuda_densetrack.supported(21, 7) and cuda_densetrack.supported(61, 20)
    assert cuda_densetrack.launch_layout(61, 20).smem > 100 * 1024
    assert not cuda_densetrack.supported(201, 20)   # shared memory
    assert not cuda_densetrack.supported(9, 60)     # 121 x 18 strips


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
