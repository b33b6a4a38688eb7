# SPDX-License-Identifier: CECILL-2.1
"""Kernels K1, K2 and K3 on the card against their plain PyTorch versions
(the comparisons of chip_smoke.py's kernel phases, as test cases). Marked
``cuda``: they skip where no card is present. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.ops import cuda_densetrack, cuda_fftp, cuda_median, densetrack, ncc
from barc4dip_tpu_torch.ops.phasecorr import argmax2d
from barc4dip_tpu_torch.utils import speckle_stack

pytestmark = pytest.mark.cuda
ATOL_REL = 2e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


def _frames(dev, n, side):
    st = speckle_stack(n, (side, side), grain_px=8.0, mean_counts=8000.0, seed=11,
                       dtype=np.uint16)
    return torch.from_numpy(st.astype(np.float32)).to(dev)


@pytest.mark.parametrize(
    "h, w, nf", [(128, 128, 1), (256, 256, 3), (2048, 2048, 1), (4096, 4096, 1),
                 (256, 1024, 2), (1024, 128, 1)],
)
def test_corr_from_rfft_matches_plain(dev, h, w, nf):
    a = _frames(dev, nf, max(h, w))[:, :h, :w]
    a = a - a.mean(dim=(-2, -1), keepdim=True)
    F = torch.fft.rfft2(a)
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(F, F[:, None], s=(h, w))
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0}
    want = cuda_fftp.corr_from_rfft_plain(F, F[:, None], s=(h, w))
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL_REL * float(want.abs().max())


@pytest.mark.parametrize("side, nf, shared", [(256, 2, True), (256, 2, False), (2048, 1, True)])
def test_ncc_masked_peaks_matches_plain(dev, side, nf, shared):
    frames = _frames(dev, nf + 1, side)
    s = 29
    starts = [(side // 4 * i + 3, side // 4 * j + 5) for i in range(1, 4) for j in range(1, 4)]
    tiles = torch.stack([frames[0, y:y + s, x:x + s] for y, x in starts])
    bank = ncc.prep_template(tiles, side, side)
    G, en = bank["Ft"], bank["energy"]
    if not shared:
        G, en = G[None].repeat(nf, 1, 1, 1).contiguous(), en[None].repeat(nf, 1).contiguous()
    prep = ncc.zncc_prepare_image(frames[1:], s, s)
    var_full = torch.nn.functional.pad(prep["var_sum"], (0, s - 1, 0, s - 1))
    kw = dict(valid_hw=(side - s + 1, side - s + 1), eps=1e-9, s=(side, side))
    cuda_fftp.reset_counts()
    maps, iy, ix = cuda_fftp.ncc_masked_peaks(prep["F"], G, var_full, en, **kw)
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 0, "rows_ncc": 1}
    pmaps, piy, pix = cuda_fftp.ncc_masked_peaks_plain(prep["F"], G, var_full, en, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(pmaps)
    assert torch.equal(torch.isfinite(maps), fin)
    assert float((maps[fin] - pmaps[fin]).abs().max()) <= ATOL_REL * float(pmaps[fin].abs().max())
    ai, aj = argmax2d(maps)
    assert torch.equal(iy, ai) and torch.equal(ix, aj)
    assert torch.equal(iy, piy) and torch.equal(ix, pix)


def test_uncovered_shape_takes_plain_and_is_counted(dev):
    a = _frames(dev, 1, 256)[:, :228, :228]
    F = torch.fft.rfft2(a - a.mean())
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(F, F[:, None], s=(228, 228))
    assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0}
    assert cuda_fftp.PLAIN_BY_SHAPE == {"corr:228x228:complex64": 1}
    torch.testing.assert_close(got, cuda_fftp.corr_from_rfft_plain(F, F[:, None], s=(228, 228)))


def test_wrong_layout_raises(dev):
    a = _frames(dev, 2, 128)
    F = torch.fft.rfft2(a)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fftp.corr_from_rfft(F, F[:, None].transpose(-1, -2).contiguous().transpose(-1, -2),
                                 s=(128, 128))


@pytest.mark.parametrize("shape", [(2048, 2048), (4, 2048, 2048), (37, 1), (3, 45, 70)])
def test_median3x3_matches_plain_exactly(dev, shape):
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32)).to(dev)
    x.view(-1)[::997] = 0.0
    cuda_median.reset_counts()
    got = cuda_median.median3x3(x)
    assert cuda_median.LAUNCHES == {"median3x3": 1} and cuda_median.PLAIN_BY_SHAPE == {}
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_median.median3x3_plain(x))


def test_median3x3_propagates_nan(dev):
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 257)).astype(np.float32)).to(dev)
    x.view(-1)[::113] = float("nan")
    got = cuda_median.median3x3(x)
    want = cuda_median.median3x3_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got).any())
    fin = ~torch.isnan(want)
    assert torch.equal(got[fin], want[fin])


def test_median_uncovered_calls_are_counted(dev):
    cuda_median.reset_counts()
    x = torch.zeros(16, 16, dtype=torch.float64, device=dev)
    from barc4dip_tpu_torch.ops.rank import median_filter2d

    median_filter2d(x, 3)
    median_filter2d(x.float(), 5)
    assert cuda_median.LAUNCHES == {"median3x3": 0}
    assert cuda_median.PLAIN_BY_SHAPE == {"median3x3:16x16:float64": 1, "median5x5:16x16:float32": 1}


@pytest.mark.parametrize("nf, side, s, r, step", [(1, 2048, 33, 10, 16), (4, 2048, 33, 10, 16),
                                                  (2, 256, 9, 3, 7)])
def test_ncc_sums_matches_plain(dev, nf, side, s, r, step):
    frames = _frames(dev, nf + 1, side)
    frames = (frames - frames.mean()) / frames.std()
    y0s, x0s = densetrack.grid_starts(side, side, s, r, step)
    ref, img = frames[0].contiguous(), frames[1:].contiguous()
    cuda_densetrack.reset_counts()
    got = cuda_densetrack.ncc_sums(ref, img, y0s, x0s, s, r)
    assert cuda_densetrack.LAUNCHES == {"ncc_sums": 1} and cuda_densetrack.PLAIN_BY_SHAPE == {}
    want = cuda_densetrack.ncc_sums_plain(*cuda_densetrack.grid_windows(ref, img, y0s, x0s, s, r), r)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (nf * len(y0s) * len(x0s), 2 * r + 1, 2 * r + 1)
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_ncc_sums_uncovered_geometry_is_counted(dev):
    frames = _frames(dev, 2, 256)
    y0s, x0s = densetrack.grid_starts(256, 256, 81, 20, 64)
    cuda_densetrack.reset_counts()
    cuda_densetrack.ncc_sums(frames[0], frames[1], y0s, x0s, 81, 20)
    assert cuda_densetrack.LAUNCHES == {"ncc_sums": 0}
    assert cuda_densetrack.PLAIN_BY_SHAPE == {"ncc_sums:s81r20:float32": 1}
