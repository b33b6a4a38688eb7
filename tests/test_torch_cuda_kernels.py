# SPDX-License-Identifier: CECILL-2.1
"""Kernels K1, K2, K3 and K4 on the card against their plain PyTorch
versions (the comparisons of chip_smoke.py's kernel phases, as test cases),
K4 also against float64 ``torch.linalg.eigvalsh`` on the card. Marked
``cuda``: they skip where no card is present. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.ops import cuda_densetrack, cuda_fftp, cuda_median, cuda_symeig, densetrack, ncc
from barc4dip_tpu_torch.ops.phasecorr import argmax2d
from barc4dip_tpu_torch.utils import speckle_stack

pytestmark = pytest.mark.cuda
ATOL_REL = 2e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


def _clusters(h):
    """Pass-1 launches on the cluster route of one K1 call at ``h`` rows."""
    return int(h > cuda_fftp.CLUSTER_ABOVE)


def _frames(dev, n, side):
    st = speckle_stack(n, (side, side), grain_px=8.0, mean_counts=8000.0, seed=11,
                       dtype=np.uint16)
    return torch.from_numpy(st.astype(np.float32)).to(dev)


@pytest.mark.parametrize(
    "h, w, nf", [(128, 128, 1), (256, 256, 3), (2048, 2048, 1), (4096, 4096, 1),
                 (256, 1024, 2), (1024, 128, 1), (1536, 1536, 1), (2048, 2560, 2), (3072, 3072, 4)],
)
def test_corr_from_rfft_matches_plain(dev, h, w, nf):
    a = _frames(dev, nf, max(h, w))[:, :h, :w]
    a = a - a.mean(dim=(-2, -1), keepdim=True)
    F = torch.fft.rfft2(a)
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(F, F[:, None], s=(h, w))
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": _clusters(h)}
    want = cuda_fftp.corr_from_rfft_plain(F, F[:, None], s=(h, w))
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL_REL * float(want.abs().max())


@pytest.mark.parametrize("nf", [1, 2, 3, 8])
def test_corr_from_rfft_standardized_batches_match_plain(dev, nf):
    """The sharpness path's batches (one image, a chunk of 8, a tail chunk
    of 3 and its remainder of 2) of standardized 2048^2 frames, every plane
    against the plain version at the same bound."""
    from barc4dip_tpu_torch.ops import corrcore

    F = torch.fft.rfft2(corrcore._precondition(_frames(dev, nf, 2048), True, True))
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(F, F[:, None], s=(2048, 2048))
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": 0}
    want = cuda_fftp.corr_from_rfft_plain(F, F[:, None], s=(2048, 2048))
    torch.cuda.synchronize()
    for k in range(nf):
        assert float((got[k] - want[k]).abs().max()) <= ATOL_REL * float(want[k].abs().max()), k


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
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 0, "rows_ncc": 1, "cols_cluster": 0}
    pmaps, piy, pix = cuda_fftp.ncc_masked_peaks_plain(prep["F"], G, var_full, en, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(pmaps)
    assert torch.equal(torch.isfinite(maps), fin)
    assert float((maps[fin] - pmaps[fin]).abs().max()) <= ATOL_REL * float(pmaps[fin].abs().max())
    ai, aj = argmax2d(maps)
    assert torch.equal(iy, ai) and torch.equal(ix, aj)
    assert torch.equal(iy, piy) and torch.equal(ix, pix)


# every power of two from 128 to 4096 on each axis at least once (8192: MIXED_SHAPES)
RADIX_SHAPES = [(128, 4096), (4096, 128), (2048, 2048), (256, 1024), (1024, 256), (512, 512),
                (128, 128)]


def _random_spectra(h, w, nf, k, shared, seed):
    """Random complex half spectra (not Hermitian where rfft2 would make
    them so), as complex128 numpy and complex64 tensors' sources."""
    rng = np.random.default_rng(seed)
    wh = w // 2 + 1

    def c(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    F = c(nf, h, wh)
    G = c(k, h, wh) if shared else c(nf, k, h, wh)
    return F, G


def _corr_ref(F, G, h, w):
    """numpy float64 irfft2(F * conj(G)): the contract, for any spectra."""
    G = G.astype(np.complex128)
    prod = F.astype(np.complex128)[:, None] * np.conj(G if G.ndim == 4 else G[None])
    return np.fft.irfft2(prod, s=(h, w))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("h, w", RADIX_SHAPES)
def test_corr_random_spectra_vs_numpy(dev, h, w, shared):
    nf = 1 if h * w >= 2048 * 2048 else 2
    F, G = _random_spectra(h, w, nf, 2, shared, seed=h + w)
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(torch.from_numpy(F).to(dev), torch.from_numpy(G).to(dev), s=(h, w))
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": _clusters(h)}
    want = _corr_ref(F, G, h, w)
    got = got.cpu().numpy()
    assert got.shape == want.shape == (nf, 2, h, w)
    assert np.abs(got - want).max() <= ATOL_REL * np.abs(want).max()


def _ncc_ref(F, G, var, en, h, w, vh, vw, eps):
    corr = _corr_ref(F, G, h, w)
    en = en.astype(np.float64)
    denom = np.sqrt(var.astype(np.float64)[:, None] * (en if en.ndim == 2 else en[None])[..., None, None])
    with np.errstate(invalid="ignore"):
        safe = denom > eps
    ncc = np.where(safe, corr / np.where(safe, denom, 1.0), 0.0)
    valid = (np.arange(h) < vh)[:, None] & (np.arange(w) < vw)[None, :]
    maps = np.where(valid, ncc, -np.inf)
    flat = maps.reshape(maps.shape[:2] + (-1,)).argmax(-1)  # first NaN, else first max
    return maps, flat // w, flat % w


def _check_ncc(dev, F, G, var, en, h, w, vh, vw, eps=1e-9):
    cuda_fftp.reset_counts()
    args = [torch.from_numpy(a).to(dev) for a in (F, G, var, en)]
    maps, iy, ix = cuda_fftp.ncc_masked_peaks(*args, valid_hw=(vh, vw), eps=eps, s=(h, w))
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 0, "rows_ncc": 1, "cols_cluster": _clusters(h)}
    want, wy, wx = _ncc_ref(F, G, var, en, h, w, vh, vw, eps)
    maps = maps.cpu().numpy()
    for pred in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(pred(maps), pred(want))
    fin = np.isfinite(want)
    if fin.any():
        assert np.abs(maps[fin] - want[fin]).max() <= ATOL_REL * np.abs(want[fin]).max()
    np.testing.assert_array_equal(iy.cpu().numpy(), wy)
    np.testing.assert_array_equal(ix.cpu().numpy(), wx)
    ai, aj = argmax2d(torch.from_numpy(maps))
    np.testing.assert_array_equal(ai.numpy(), wy)
    np.testing.assert_array_equal(aj.numpy(), wx)
    return maps


def _ncc_inputs(h, w, nf, k, shared, seed):
    F, G = _random_spectra(h, w, nf, k, shared, seed)
    rng = np.random.default_rng(seed + 1)
    var = rng.uniform(0.5, 2.0, size=(nf, h, w)).astype(np.float32)
    var[:, ::7, ::5] = 0.0  # denominator <= eps: the map reads 0 there
    en = rng.uniform(0.5, 2.0, size=(k,) if shared else (nf, k)).astype(np.float32)
    return F, G, var, en


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("h, w", RADIX_SHAPES)
def test_ncc_random_spectra_vs_numpy(dev, h, w, shared):
    nf = 1 if h * w >= 2048 * 2048 else 2
    F, G, var, en = _ncc_inputs(h, w, nf, 3, shared, seed=3 * h + w)
    _check_ncc(dev, F, G, var, en, h, w, h - 7, w - 5)


# a side of each class of the 128*k gate: odd factors 3, 5, 7, 11 and 63, the
# power-of-two tail at 8192, ragged pass-1 column groups (1536: 10 columns a
# block) and pass-2 row-pair groups, and NCC row pairs that straddle warps
# (W = 640, 896); then each odd factor of the register route on both passes
# (7: 1792, 9: 1152 and 2304, 15: 1920, 25: 3200, 27: 3456, 45: 5760, 49:
# 6272, 63: 8064) and the direct route's 11 on pass 2 (1408)
MIXED_SHAPES = [(384, 640), (1536, 1536), (2048, 2560), (3072, 3072), (1408, 896), (8064, 128),
                (128, 8192), (8192, 8192), (1792, 1152), (1152, 1792), (1920, 1920), (2304, 2304),
                (3200, 3456), (3456, 3200), (5760, 6272), (6272, 5760), (128, 8064), (896, 1408)]


def _mixed_batch(h, w):
    return (1, 1) if h * w >= 3072 * 3072 else (2, 2)


@pytest.mark.parametrize("h, w", MIXED_SHAPES)
def test_corr_mixed_radix_vs_numpy(dev, h, w):
    nf, k = _mixed_batch(h, w)
    F, G = _random_spectra(h, w, nf, k, True, seed=h + 3 * w)
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(torch.from_numpy(F).to(dev), torch.from_numpy(G).to(dev), s=(h, w))
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": _clusters(h)} \
        and not cuda_fftp.PLAIN_BY_SHAPE
    want = _corr_ref(F, G, h, w)
    got = got.cpu().numpy()
    assert got.shape == want.shape == (nf, k, h, w)
    assert np.abs(got - want).max() <= ATOL_REL * np.abs(want).max()


@pytest.mark.parametrize("h, w", MIXED_SHAPES)
def test_ncc_mixed_radix_vs_numpy(dev, h, w):
    """Masks, zeros where the denominator is <= eps, and (with two images)
    NaN in one image's spectrum ranked highest."""
    nf, k = _mixed_batch(h, w)
    F, G, var, en = _ncc_inputs(h, w, nf, k + 1, nf == 1, seed=7 * h + w)
    if nf > 1:
        F[1, 3, 5] = np.nan
    cuda_fftp.reset_counts()
    maps = _check_ncc(dev, F, G, var, en, h, w, h - 7, w - 5)
    assert not cuda_fftp.PLAIN_BY_SHAPE
    if nf > 1:
        assert np.isnan(maps[1]).any() and not np.isnan(maps[0]).any()


# pass 1 above 2048 rows, on thread-block clusters, one shape at least for
# each instantiation: 8 blocks a cluster at 2176 = 8 * 272 (odd factor 17,
# the direct route), 16 at 2304 = 16 * 144 (odd factor 9, partial warps),
# 2560, 3072, 6144 (odd factors 5, 3, 3) and the powers of two; narrow and
# square planes, several images and templates where the planes are small;
# then, 128 columns wide, each other register-route instantiation (m = 7,
# 15, 21, 25, 27, 35, 45, 49, 63 and 5, 9, 15 at longer L) and the direct
# route with 16 blocks (2816 = 11 * 256, 5632 = 11 * 512)
CLUSTER_SHAPES = [(2176, 384), (2304, 640), (2560, 512), (3072, 3072), (4096, 4096), (6144, 256),
                  (8192, 128), (8192, 8192)] + [
    (h, 128) for h in (2688, 2816, 3200, 3456, 3584, 3840, 4480, 4608, 5120, 5376, 5632, 5760, 6272, 6400,
                       6912, 7168, 7680, 8064)]


def _cluster_batch(h, w):
    return (1, 2) if h * w >= 3072 * 3072 else (2, 3)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("h, w", CLUSTER_SHAPES)
def test_corr_cluster_route_vs_numpy(dev, h, w, shared):
    nf, k = _cluster_batch(h, w)
    F, G = _random_spectra(h, w, nf, k, shared, seed=5 * h + w)
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(torch.from_numpy(F).to(dev), torch.from_numpy(G).to(dev), s=(h, w))
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": _clusters(h)} \
        and not cuda_fftp.PLAIN_BY_SHAPE
    want = _corr_ref(F, G, h, w)
    got = got.cpu().numpy()
    assert got.shape == want.shape == (nf, k, h, w)
    assert np.abs(got - want).max() <= ATOL_REL * np.abs(want).max()


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("h, w", CLUSTER_SHAPES)
def test_ncc_cluster_route_vs_numpy(dev, h, w, shared):
    nf, k = _cluster_batch(h, w)
    F, G, var, en = _ncc_inputs(h, w, nf, k, shared, seed=11 * h + w)
    _check_ncc(dev, F, G, var, en, h, w, h - 7, w - 5)
    assert not cuda_fftp.PLAIN_BY_SHAPE


# every side of the gate on each pass, the other side 128: each
# instantiation of csrc/fftp_corr.cu (power of two, register route, direct
# route; pass 1 whole columns or clusters, pass 2 and 2') runs at least once
SIDES = [128 * k for k in range(1, 65)]


@pytest.mark.parametrize("n", SIDES)
def test_corr_every_side_vs_numpy(dev, n):
    for h, w in ((n, 128), (128, n)):
        F, G = _random_spectra(h, w, 2, 2, True, seed=n + h)
        cuda_fftp.reset_counts()
        got = cuda_fftp.corr_from_rfft(torch.from_numpy(F).to(dev), torch.from_numpy(G).to(dev), s=(h, w))
        assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": _clusters(h)} \
            and not cuda_fftp.PLAIN_BY_SHAPE
        want = _corr_ref(F, G, h, w)
        assert np.abs(got.cpu().numpy() - want).max() <= ATOL_REL * np.abs(want).max(), (h, w)


@pytest.mark.parametrize("n", SIDES)
def test_ncc_every_side_vs_numpy(dev, n):
    for h, w in ((n, 128), (128, n)):
        F, G, var, en = _ncc_inputs(h, w, 2, 2, False, seed=3 * n + h)
        _check_ncc(dev, F, G, var, en, h, w, h - 7, w - 5)
        assert not cuda_fftp.PLAIN_BY_SHAPE


@pytest.mark.parametrize("h, w", [(1536, 2560), (8064, 640), (2304, 4096)])
def test_ncc_odd_sides_nan_spectra_and_masked_rows(dev, h, w):
    """On the register route (m = 3 and 5, 63, 9 on pass 1): NaN in one
    image's spectrum makes its planes NaN wherever the denominator is > eps,
    ranked highest; rows at or past vh are -inf throughout."""
    F, G, var, en = _ncc_inputs(h, w, 2, 2, True, seed=h + w)
    F[1, 3, 5] = np.nan
    vh = h // 3
    maps = _check_ncc(dev, F, G, var, en, h, w, vh, w - 9)
    assert np.isneginf(maps[:, :, vh:]).all()
    assert np.isnan(maps[1]).any() and not np.isnan(maps[0]).any()


@pytest.mark.parametrize("vh, vw", [(100, 200), (0, 256), (4096, 1)])
def test_ncc_cluster_route_nan_spectra_and_masked_rows(dev, vh, vw):
    """At H = 4096: NaN in one image's spectrum (row 3, so in rank 3 of each
    cluster) makes its planes NaN wherever the denominator is > eps, ranked
    highest; rows at or past vh are -inf throughout."""
    h, w = 4096, 256
    F, G, var, en = _ncc_inputs(h, w, 2, 3, True, seed=13)
    F[1, 3, 5] = np.nan
    maps = _check_ncc(dev, F, G, var, en, h, w, vh, vw)
    assert np.isneginf(maps[:, :, vh:]).all()
    if vh and vw:
        assert np.isnan(maps[1]).any() and not np.isnan(maps[0]).any()


@pytest.mark.parametrize("h, w", [(256, 512), (2048, 2048)])
def test_ncc_nan_spectra_rank_highest(dev, h, w):
    """NaN in one image's spectrum makes its planes NaN wherever the
    denominator is > eps: the peak is the first such entry, not the -inf
    mask and not the zeros."""
    F, G, var, en = _ncc_inputs(h, w, 2, 3, True, seed=5)
    F[1, 3, 5] = np.nan
    var[1, 0, :4] = 0.0
    maps = _check_ncc(dev, F, G, var, en, h, w, h - 30, w - 30)
    assert np.isnan(maps[1]).any() and not np.isnan(maps[0]).any()


def test_ncc_nan_variance_reads_zero(dev):
    h, w = 512, 256
    F, G, var, en = _ncc_inputs(h, w, 2, 2, False, seed=6)
    var[0, 10:20, 30:40] = np.nan
    maps = _check_ncc(dev, F, G, var, en, h, w, h - 3, w - 3)
    assert (maps[0, :, 10:20, 30:40] == 0.0).all()


@pytest.mark.parametrize("vh, vw", [(1, 64), (5, 256), (0, 256), (128, 0)])
def test_ncc_masked_rows(dev, vh, vw):
    """Rows at or past vh are -inf throughout; a fully masked map still
    gives a valid index, (0, 0) as argmax2d does."""
    h, w = 128, 256
    F, G, var, en = _ncc_inputs(h, w, 2, 3, True, seed=7)
    maps = _check_ncc(dev, F, G, var, en, h, w, vh, vw)
    assert np.isneginf(maps[:, :, vh:]).all()


def test_uncovered_shape_takes_plain_and_is_counted(dev):
    a = _frames(dev, 1, 256)[:, :228, :228]
    F = torch.fft.rfft2(a - a.mean())
    cuda_fftp.reset_counts()
    got = cuda_fftp.corr_from_rfft(F, F[:, None], s=(228, 228))
    assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0, "cols_cluster": 0}
    assert cuda_fftp.PLAIN_BY_SHAPE == {"corr:228x228:complex64": 1}
    torch.testing.assert_close(got, cuda_fftp.corr_from_rfft_plain(F, F[:, None], s=(228, 228)))


@pytest.mark.parametrize("side, tpl", [(256, 29), (2048, 29), (512, 32)])
def test_ncc_valid_of_one_image_launches_k1a(dev, side, tpl):
    """``ncc_valid`` as ``signal.template_matching`` calls it: one 2-D image
    (whose ``rfft2`` comes back strided on CUDA) against one template, odd
    or even: one K1a pair, no plain path, the map the plain correlation
    gives on the same prepared spectra."""
    frames = _frames(dev, 2, side)
    y0 = (side - tpl) // 2
    template = frames[0, y0 : y0 + tpl, y0 : y0 + tpl]
    cuda_fftp.reset_counts()
    got = ncc.ncc_valid(frames[1], template)
    assert cuda_fftp.LAUNCHES == {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": 0} \
        and not cuda_fftp.PLAIN_BY_SHAPE
    prep = ncc.zncc_prepare_image(frames[1], tpl, tpl)
    bank = ncc.prep_template(template[None], side, side)
    numer = cuda_fftp.corr_from_rfft_plain(prep["F"], bank["Ft"], s=(side, side))
    want = ncc._divide(numer[..., : side - tpl + 1, : side - tpl + 1], prep["var_sum"], bank["energy"], 1e-9)[0]
    assert got.shape == (side - tpl + 1, side - tpl + 1)
    assert float((got - want).abs().max()) <= ATOL_REL * float(want.abs().max())


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


def test_median3x3_unaligned_rows_match_plain(dev):
    """A plane that starts 4 bytes past a 16-byte boundary takes the scalar
    loads: still exactly the plain version."""
    buf = torch.from_numpy(np.random.default_rng(3).normal(size=512 * 256 + 1).astype(np.float32))
    x = buf.to(dev)[1:].view(512, 256)
    got = cuda_median.median3x3(x)
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


@pytest.mark.parametrize("nf, side, s, r, step", [
    (1, 2048, 33, 10, 16), (2, 2048, 33, 10, 16), (3, 2048, 33, 10, 16), (4, 2048, 33, 10, 16),
    (2, 256, 9, 3, 7), (1, 512, 21, 7, 11), (4, 512, 21, 7, 11), (2, 256, 61, 20, 64),
])
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
    """A window too large for a block's shared memory (241 px) takes the
    plain version and is counted."""
    frames = _frames(dev, 2, 256)
    y0s, x0s = densetrack.grid_starts(256, 256, 201, 20, 64)
    cuda_densetrack.reset_counts()
    cuda_densetrack.ncc_sums(frames[0], frames[1], y0s, x0s, 201, 20)
    assert cuda_densetrack.LAUNCHES == {"ncc_sums": 0}
    assert cuda_densetrack.PLAIN_BY_SHAPE == {"ncc_sums:s201r20:float32": 1}


# -- the sharpness path on the card -------------------------------------------

@pytest.mark.parametrize("side, launches, plain", [
    (2048, {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": 0}, {}),
    (512, {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": 0}, {}),
    (1536, {"cols": 1, "rows": 1, "rows_ncc": 0, "cols_cluster": 0}, {}),
    (1500, {"cols": 0, "rows": 0, "rows_ncc": 0, "cols_cluster": 0}, {"corr:1500x1500:complex64": 1}),
])
def test_sharpness_autocorrelation_launches_k1a(dev, side, launches, plain):
    """The ``autocorrelation`` group of a CUDA frame runs its one
    standardized autocorrelation through K1a where the kernel covers the
    side (every 128*k), and through the plain version, counted, where the
    TPU gate refuses it too (1500); the
    widths agree with the plain version's at rtol 1e-5 (float32 round-off
    of a 1/e crossing)."""
    from barc4dip_tpu_torch.metrics import estimators, sharpness_stats

    frame = _frames(dev, 1, side)[0]
    cuda_fftp.reset_counts()
    out = sharpness_stats(frame, metrics="autocorrelation", tiles=False, verbose=False)
    assert cuda_fftp.LAUNCHES == launches
    assert cuda_fftp.PLAIN_BY_SHAPE == plain
    d = frame - frame.mean()
    d = d / d.std(correction=0)
    F = torch.fft.rfft2(d)
    ac = torch.fft.fftshift(cuda_fftp.corr_from_rfft_plain(F, F[None], s=(side, side))[0])
    lx, ly, leq = estimators._widths_from_autocorr(
        ac / ac.abs().max(), fraction=float(1 / np.e), radial_method="interpolated")
    got = out["full"]["autocorrelation"]
    for key, want in (("sx", 1 / float(lx)), ("sy", 1 / float(ly)), ("seq", 1 / float(leq))):
        assert got[key] == pytest.approx(want, rel=1e-5), key


@pytest.mark.parametrize("name", ["sobel_x", "sobel_y", "laplace"])
def test_stencils_float32_against_float64(dev, name):
    """Nine float32 terms of a frame of ~8000 counts: within 1e-6 of the
    output's scale of the float64 result (nothing here can run at TF32)."""
    from barc4dip_tpu_torch.ops import stencils

    frame = _frames(dev, 1, 1024)[0]
    got = getattr(stencils, name)(frame).double()
    want = getattr(stencils, name)(frame.double())
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("side", [227, 2048])
def test_gram_product_is_not_tf32(dev, side):
    """The eigenvalues group's Gram product J J^T in float32 against
    float64: within 1e-5 of its largest entry (float32 sums of ``side``
    terms). At TF32 (10 mantissa bits) the same product is off by ~1e-3;
    the test also shows that such a loss would be seen."""
    frame = _frames(dev, 1, 2048)[0][:side, :side]
    x = frame / torch.sqrt((frame * frame).sum())
    J = x - x.mean()
    want = J.double() @ J.double().mT
    scale = float(want.abs().max())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert float((J @ J.mT - want).abs().max()) <= 1e-5 * scale
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loose = float((J @ J.mT - want).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert loose > 1e-5 * scale


@pytest.mark.parametrize("side, method", [(227, "dense"), (1024, "subspace"), (2048, "auto")])
def test_eigenvalues_float32_against_float64(dev, side, method):
    """Batched dense (kernel K4) and subspace eigenvalues in float32 against
    a float64 dense solve on the card: rtol 1e-4, the metric value gate."""
    from barc4dip_tpu_torch.metrics import estimators

    frames = _frames(dev, 2, 2048)[:, :side, :side]
    got = estimators.eigenvalues_core(frames, eig_method=method)
    want = estimators.eigenvalues_core(frames.double(), eig_method="dense")
    for key in ("eigenvalues", "e1", "e2", "re"):
        rel = ((got[key].double() - want[key]).abs() / want[key].abs()).max()
        assert float(rel) <= 1e-4, key


# -- kernel K4: the dense eigenvalue route -----------------------------------------

# float32 tridiagonalisation: within this share of the spectral radius of
# float64 eigvalsh (as tests/test_torch_symeig.py holds the plain version)
K4_ATOL_REL = 2e-6


def _k4_symmetric(B, M, seed):
    X = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, M, M)).astype(np.float32))
    return torch.tril(X) + torch.tril(X, -1).mT


def _k4_gram(img):
    """``eigenvalues_core``'s Gram matrix of each image."""
    x = img / torch.sqrt((img * img).sum(dim=(-2, -1)))[..., None, None]
    J = x - x.mean(dim=(-2, -1), keepdim=True)
    return J @ J.mT


def _k4_case(dev, case):
    if case.startswith("random-"):
        M = int(case.split("-")[1])
        return _k4_symmetric(2, M, seed=M).to(dev)
    if case.startswith("subtile-"):  # 25 subtiles of one 2048^2 frame, a bucket's shape
        rows, cols = map(int, case.split("-")[1].split("x"))
        frame = _frames(dev, 1, 2048)[0]
        tiles = frame[:5 * rows, :5 * cols].reshape(5, rows, 5, cols).permute(0, 2, 1, 3)
        return _k4_gram(tiles.reshape(25, rows, cols).contiguous())
    if case == "zeros":
        return torch.zeros(3, 228, 228, device=dev)
    if case == "rank1":
        u = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 228)).astype(np.float32)).to(dev)
        return u[:, :, None] * u[:, None, :]
    if case == "repeated":
        Q, _ = torch.linalg.qr(torch.from_numpy(np.random.default_rng(2).normal(size=(228, 228))))
        lam = torch.tensor([1.0] * 80 + [2.0] * 100 + [-3.0] * 48, dtype=torch.float64)
        return ((Q * lam) @ Q.T).float()[None].to(dev)
    if case == "identity":
        return 3.5 * torch.eye(228, device=dev)[None].repeat(2, 1, 1)
    if case == "batch81":
        return _k4_symmetric(81, 228, seed=81).to(dev)
    raise ValueError(case)


K4_CASES = ["random-1", "random-2", "random-3", "random-32", "random-227", "random-228", "random-238",
            "subtile-228x228", "subtile-228x227", "subtile-227x228", "subtile-227x227",
            "zeros", "rank1", "repeated", "identity", "batch81"]


@pytest.mark.parametrize("case", K4_CASES)
def test_symeig_matches_float64_eigvalsh(dev, case):
    """K4, one launch, against float64 ``eigvalsh`` on the card and against
    its plain version: within 2e-6 of the spectral radius, ascending;
    zeros exactly (a bad subtile is solved on zeros)."""
    G = _k4_case(dev, case)
    cuda_symeig.reset_counts()
    got = cuda_symeig.eigvalsh(G)
    torch.cuda.synchronize()
    assert cuda_symeig.LAUNCHES == {"symeig": 1} and cuda_symeig.LIBRARY_BY_SHAPE == {}
    want = torch.linalg.eigvalsh(G.double())
    scale = float(want.abs().max())
    assert got.shape == want.shape and got.dtype == torch.float32 and got.device == G.device
    assert float((got.double() - want).abs().max()) <= K4_ATOL_REL * scale
    assert bool((got[..., 1:] >= got[..., :-1]).all())
    if case == "zeros":
        assert torch.equal(got.abs(), torch.zeros_like(got))
    if case != "batch81":  # the plain version's Python steps: 81 x 228^2 is slow
        plain = cuda_symeig.symeig_tridiag_plain(G)
        assert float((got - plain).abs().max()) <= K4_ATOL_REL * scale


@pytest.mark.parametrize("rows, cols", [(228, 228), (228, 227), (227, 228), (227, 227)])
def test_symeig_subtile_buckets_against_float64(dev, rows, cols):
    """The eigenvalue group on a bucket of 25 subtiles through K4 against a
    float64 dense solve on the card: rtol 1e-4, the metric value gate."""
    from barc4dip_tpu_torch.metrics import estimators

    frame = _frames(dev, 1, 2048)[0]
    tiles = frame[:5 * rows, :5 * cols].reshape(5, rows, 5, cols).permute(0, 2, 1, 3)
    tiles = tiles.reshape(25, rows, cols).contiguous()
    cuda_symeig.reset_counts()
    got = estimators.eigenvalues_core(tiles)
    assert cuda_symeig.LAUNCHES == {"symeig": 1} and cuda_symeig.LIBRARY_BY_SHAPE == {}
    want = estimators.eigenvalues_core(tiles.double())
    for key in ("eigenvalues", "e1", "e2", "re"):
        rel = ((got[key].double() - want[key]).abs() / want[key].abs()).max()
        assert float(rel) <= 1e-4, key


def test_sharpness_stats_launches_k4_once_a_bucket(dev):
    """A 2048^2 frame's ``metrics="all"`` call with 9x9 subtiles: four
    buckets (227/228 px a side), one K4 launch each; the frame's own
    eigenvalues take the subspace route; nothing goes to the library."""
    from barc4dip_tpu_torch.metrics import sharpness_stats

    frame = _frames(dev, 1, 2048)[0]
    cuda_symeig.reset_counts()
    out = sharpness_stats(frame, metrics="all", tiles=True, verbose=False)
    assert cuda_symeig.LAUNCHES == {"symeig": 4} and cuda_symeig.LIBRARY_BY_SHAPE == {}
    assert np.isfinite(np.asarray(out["tiles"]["eigenvalues"]["e1"]["mean"])).all()


def test_symeig_library_calls_are_counted(dev):
    """A CUDA batch K4 does not take (M above its limit, float64) goes to
    ``torch.linalg.eigvalsh``, counted by shape and dtype."""
    G = _k4_symmetric(2, cuda_symeig.MAX_M + 1, seed=3).to(dev)
    cuda_symeig.reset_counts()
    got = cuda_symeig.eigvalsh(G)
    cuda_symeig.eigvalsh(G[:, :20, :20].double())
    assert cuda_symeig.LAUNCHES == {"symeig": 0}
    assert cuda_symeig.LIBRARY_BY_SHAPE == {"eigvalsh:2x239x239:float32": 1, "eigvalsh:2x20x20:float64": 1}
    assert torch.equal(got, torch.linalg.eigvalsh(G))


@pytest.mark.parametrize("kernel", ["K1a", "K1b", "K2", "K3", "K4"])
def test_launch_leaves_the_current_device(dev, kernel):
    """Each binding switches the CUDA runtime to its tensor's device; the
    wrapper's guard puts the caller's current device back. With two cards
    the caller sits on cuda:1 while cuda:0 launches; with one, the current
    device must simply stay as it was."""
    x = _frames(dev, 2, 256)
    before = 1 if torch.cuda.device_count() > 1 else torch.cuda.current_device()
    torch.cuda.set_device(before)
    try:
        if kernel in ("K1a", "K1b"):
            F = torch.fft.rfft2(x - x.mean(dim=(-2, -1), keepdim=True))
            if kernel == "K1a":
                cuda_fftp.corr_from_rfft(F, F[:, None], s=(256, 256))
            else:
                G = F[0, None].expand(3, *F.shape[1:]).contiguous()
                var = torch.ones(2, 256, 256, device=dev)
                cuda_fftp.ncc_masked_peaks(F, G, var, torch.ones(3, device=dev),
                                           valid_hw=(200, 200), s=(256, 256))
        elif kernel == "K2":
            cuda_median.median3x3(x)
        elif kernel == "K4":
            cuda_symeig.symeig_tridiag(_k4_gram(x[:, :64, :64]).contiguous())
        else:
            cuda_densetrack.ncc_sums(x[0], x[1:], (20, 60), (20, 60), 17, 4)
        assert torch.cuda.current_device() == before
    finally:
        torch.cuda.set_device(0)


def test_mesh_on_one_card_leaves_the_current_device_and_matches(dev):
    """A two-shard mesh on one card (``frame_mesh(["cuda:0", "cuda:0"])``):
    every K1 launch runs on cuda:0, the current device is unchanged, and the
    stack's results equal the unsharded run's within float32 round-off: the
    metric leaves at rtol 1e-5, the trajectories at 1e-3 px (the float32
    trajectory bound of the card check; the window variance sums come from
    float32 integral images, whose rounding a change of batch shape on the
    card reshuffles: 3.1e-4 px seen at 2048^2)."""
    from barc4dip_tpu_torch import speckle_stack_stats
    from barc4dip_tpu_torch.parallel import frame_mesh

    st = speckle_stack(6, (512, 512), grain_px=6.0, mean_counts=8000.0, seed=5, dtype=np.uint16)
    kw = dict(metrics="all", tiles=True, frame_chunk=4, verbose=False, grain_maps=False)
    before = torch.cuda.current_device()
    single = speckle_stack_stats(st, device=dev, **kw)
    cuda_fftp.reset_counts()
    sharded = speckle_stack_stats(st, mesh=frame_mesh(["cuda:0", "cuda:0"]), **kw)
    assert torch.cuda.current_device() == before
    # chunks of 4 frames in two shards of 2, the tail chunk one shard of 2:
    # one K1a and two K1b a shard
    assert cuda_fftp.LAUNCHES == {"cols": 9, "rows": 3, "rows_ncc": 6, "cols_cluster": 0}
    for blk in ("abs", "inc"):
        for k in ("dx", "dy"):
            np.testing.assert_allclose(sharded["temporal"][blk][k], single["temporal"][blk][k],
                                       atol=1e-3)
    for g, fields in single["full"].items():
        for k, v in fields.items():
            np.testing.assert_allclose(sharded["full"][g][k], v, rtol=1e-5, err_msg=f"{g}/{k}")


def test_shard_frames_puts_each_shard_on_its_device(dev):
    from barc4dip_tpu_torch.parallel import frame_mesh, frames_sharding, shard_frames

    st = _frames(dev, 4, 128).cpu().numpy()
    for mesh in (frame_mesh(["cuda:0", "cuda:0"]), frame_mesh()):
        sharded = shard_frames(st, mesh)
        assert sharded.sharding == frames_sharding(mesh)
        assert [s.device for s in sharded.shards] == list(mesh.devices)
        assert sharded.device_set == set(mesh.devices)
        np.testing.assert_array_equal(torch.cat([s.cpu() for s in sharded.shards]).numpy(), st)


def test_last_run_perf_times_the_uploads_on_the_card(dev):
    """A host stack's chunk copies are timed by CUDA events (``upload_io_s``)
    and counted in their own dtype; a CUDA tensor stack uploads nothing."""
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.metrics import stack_fused

    stack = speckle_stack(8, (256, 256), grain_px=8.0, mean_counts=8000.0, seed=11, dtype=np.uint16)
    kw = dict(metrics="all", tiles=False, frame_chunk=4, verbose=False, grain_maps=False)
    host = port.speckle_stack_stats(stack, device=dev, **kw)
    perf = dict(stack_fused.LAST_RUN_PERF)
    assert perf["chunks"] == 2 and perf["upload_bytes"] == stack.nbytes and "resident" not in perf
    assert 0.0 < perf["upload_io_s"] and perf["upload_s"] > 0.0
    resident = port.speckle_stack_stats(torch.from_numpy(stack).to(dev), **kw)
    perf = dict(stack_fused.LAST_RUN_PERF)
    assert perf["resident"] is True and perf["upload_bytes"] == 0 and perf["upload_io_s"] == 0.0
    np.testing.assert_array_equal(resident["temporal"]["abs"]["dy"], host["temporal"]["abs"]["dy"])


def test_a_float32_stack_on_the_card_is_resident_and_replayed(dev):
    """Config D on an 8-frame 2048^2 float32 CUDA stack (whole counts plus a
    uniform offset, as calibrated frames): nothing uploaded, every frame
    loaded from the card, the float32 key of the metric step captured once in
    the first call and only replayed in the second, and every leaf and a lazy
    grain map equal to the same call on the host copy."""
    import barc4dip_tpu_torch as port
    from barc4dip_tpu_torch.metrics import speckles_device, stack_fused

    counts = speckle_stack(8, (2048, 2048), grain_px=8.0, mean_counts=8000.0, seed=11, dtype=np.uint16)
    host = counts.astype(np.float32) + np.random.default_rng(3).uniform(-0.5, 0.5, counts.shape).astype(np.float32)
    stack = torch.from_numpy(host).to(dev)
    kw = dict(metrics="all", tiles=True, frame_chunk=4, verbose=False)
    graph_keys = ("graph_replays", "graph_captures", "eager_steps")
    torch.cuda.synchronize()
    speckles_device._SEEN.clear()
    speckles_device._GRAPHED.clear()
    try:
        perfs = []
        for _ in range(2):
            out = port.speckle_stack_stats(stack, **kw)
            perfs.append(dict(stack_fused.LAST_RUN_PERF))
        want = port.speckle_stack_stats(host, device=dev, **kw)
    finally:
        torch.cuda.synchronize()
        speckles_device._SEEN.clear()
        speckles_device._GRAPHED.clear()
    for perf in perfs:
        assert perf["resident"] is True and perf["resident_frames"] == 8
        assert perf["upload_bytes"] == 0 and perf["upload_s"] == 0.0 and perf["upload_io_s"] == 0.0
    # chunks of 4: the first sights the key, the second captures and replays it
    assert [perfs[0][k] for k in graph_keys] == [1, 1, 1]
    assert [perfs[1][k] for k in graph_keys] == [2, 0, 0]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
                yield f"{prefix}{k}", v

    for sec in ("full", "tiles", "temporal"):
        a, b = dict(leaves(out[sec])), dict(leaves(want[sec]))
        assert a.keys() == b.keys() and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{sec}/{k}")
    np.testing.assert_array_equal(out["full"]["grain"]["autocorr"][5], want["full"]["grain"]["autocorr"][5])


@pytest.mark.parametrize("side, clusters", [(4096, 3), (2048, 0)])
def test_config_d_chunk_counts_the_cluster_route(dev, side, clusters):
    """One chunk of Config D (4 frames, ``frame_chunk=4``): its three pass-1
    launches (K1a of the frame, K1b of the two banks) take the cluster route
    at 4096 rows, and none at 2048; the entry records the call's count."""
    from barc4dip_tpu_torch import speckle_stack_stats
    from barc4dip_tpu_torch.metrics import stack_fused

    st = speckle_stack(4, (side, side), grain_px=8.0, mean_counts=8000.0, seed=11, dtype=np.uint16)
    kw = dict(metrics="all", tiles=True, frame_chunk=4, verbose=False, device=dev)
    cuda_fftp.reset_counts()
    speckle_stack_stats(st, **kw)
    assert cuda_fftp.LAUNCHES["cols"] == 3 and cuda_fftp.LAUNCHES["cols_cluster"] == clusters
    assert stack_fused.LAST_RUN_PERF["k1_cluster_launches"] == clusters
    assert stack_fused.LAST_RUN_PERF["frame0_s"] > 0.0


@pytest.mark.parametrize("tensor", [False, True])
def test_probe_launches_k1_on_the_card(dev, tensor):
    from barc4dip_tpu_torch.metrics.speckles import tracking_grid_from_frame0
    from barc4dip_tpu_torch.metrics.stack_fused import device_compute_probe

    stack = speckle_stack(8, (256, 256), grain_px=8.0, mean_counts=8000.0, seed=11, dtype=np.uint16)
    st = torch.from_numpy(stack).to(dev) if tensor else stack
    cuda_fftp.reset_counts()
    out = device_compute_probe(st, tracking_grid_from_frame0(stack)[0], groups={"amplitude", "grain", "stats"},
                               mode="off", sat=65535.0, eps=1e-6, flip=True, frame_chunk=4, device=dev)
    assert out["frames"] == 8 and np.isfinite(out["mpix_s"]) and out["mpix_s"] > 0
    # warm + three timed passes of 2 chunks: K1a in the three with metrics, two K1b in the three with tracking
    assert cuda_fftp.LAUNCHES["rows"] == 3 * 2 and cuda_fftp.LAUNCHES["rows_ncc"] == 3 * 2 * 2
