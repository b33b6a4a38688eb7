# SPDX-License-Identifier: CECILL-2.1
"""Kernel K1's module (``barc4dip_tpu_torch/ops/cuda_fftp.py``) against the
TPU kernel it replaces (``barc4dip_tpu/ops/pallas_fftp.py``).

The JAX kernel runs in Pallas interpret mode on the CPU with the MXU-FFT
knob forced on, as tests/test_mxufft.py runs it; the port takes its plain
versions, because the tensors lie on the CPU. Both see the same image and
templates. The CUDA kernel itself is held against the plain versions on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from barc4dip_tpu.ops import ncc as j_ncc
from barc4dip_tpu.ops import pallas_fftp
from barc4dip_tpu_torch.ops import cuda_fftp
from barc4dip_tpu_torch.ops import ncc as t_ncc
from barc4dip_tpu_torch.ops.phasecorr import argmax2d

torch.set_num_threads(2)

H = W = 256
S = 21


@pytest.fixture()
def case(rng, monkeypatch):
    """A 256^2 f32 image and a bank of 3 f32 21-px templates, prepared by
    both packages (the JAX side in permuted order, through the MXU path).

    As in the tracker, the templates are cut from the image, so each map
    peaks near 1: both float32 paths sit about 1e-6 from a float64
    reference in absolute terms, whatever a map's maximum."""
    monkeypatch.setenv("BARC4DIP_TPU_MXU_FFT", "1")
    img = rng.normal(size=(H, W)).astype(np.float32)
    tiles = np.stack([img[40:40 + S, 30:30 + S], img[100:100 + S, 200:200 + S],
                      img[5:5 + S, 5:5 + S]])
    jprep = j_ncc.zncc_prepare_image(jnp.asarray(img), S, S)
    jbank = jax.vmap(lambda x: j_ncc.prep_template(x, H, W))(jnp.asarray(tiles))
    tprep = t_ncc.zncc_prepare_image(torch.from_numpy(img), S, S)
    tbank = t_ncc.prep_template(torch.from_numpy(tiles), H, W)
    return jprep, jbank, tprep, tbank


def test_ncc_bank_masked_peaks_vs_pallas_interpret(case):
    jprep, jbank, tprep, tbank = case
    var_full = jnp.pad(jprep["var_sum"], ((0, S - 1), (0, S - 1)))
    ref, riy, rix = pallas_fftp.ncc_masked_peaks_from_spectra(
        jprep["Fre"], jprep["Fim"], jbank["Ftre"], jbank["Ftim"], var_full,
        jbank["energy"], valid_hw=(H - S + 1, W - S + 1), interpret=True,
    )
    maps, iy, ix, vb = t_ncc.ncc_bank_masked_peaks(tprep, tbank)
    assert vb == (H - S + 1, W - S + 1)
    ref = np.asarray(ref)
    maps = maps.numpy()
    for k in range(3):
        valid = np.isfinite(ref[k])
        np.testing.assert_array_equal(np.isfinite(maps[k]), valid)
        np.testing.assert_allclose(
            maps[k][valid], ref[k][valid], rtol=0, atol=5e-6 * np.abs(ref[k][valid]).max()
        )
    np.testing.assert_array_equal(iy.numpy(), np.asarray(riy))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(rix))
    assert [(int(a), int(b)) for a, b in zip(iy, ix)] == [(40, 30), (100, 200), (5, 5)]


def test_corr_from_rfft_vs_pallas_interpret(case):
    jprep, jbank, tprep, tbank = case
    ref = np.asarray(pallas_fftp.corr_from_spectra(
        jprep["Fre"], jprep["Fim"], jbank["Ftre"], jbank["Ftim"], interpret=True
    ))
    got = cuda_fftp.corr_from_rfft(tprep["F"], tbank["Ft"], s=(H, W)).numpy()
    assert got.shape == ref.shape == (3, H, W)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 * np.abs(ref).max())


def test_float64_vs_jax_cpu_fallback(rng, monkeypatch):
    """float64 never reaches a kernel in either package: the port's plain
    versions against the JAX natural-order composition at 1e-9."""
    monkeypatch.setenv("BARC4DIP_TPU_MXU_FFT", "0")
    img = rng.normal(size=(160, 128))
    tiles = rng.normal(size=(2, 17, 17))
    jprep = j_ncc.zncc_prepare_image(jnp.asarray(img), 17, 17)
    jbank = jax.vmap(lambda x: j_ncc.prep_template(x, 160, 128))(jnp.asarray(tiles))
    ref, riy, rix, rvb = j_ncc.ncc_bank_masked_peaks(jprep, jbank)
    tprep = t_ncc.zncc_prepare_image(torch.from_numpy(img), 17, 17)
    tbank = t_ncc.prep_template(torch.from_numpy(tiles), 160, 128)
    maps, iy, ix, vb = t_ncc.ncc_bank_masked_peaks(tprep, tbank)
    assert vb == rvb == (144, 112)
    ref = np.asarray(ref)
    valid = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(maps.numpy()), valid)
    np.testing.assert_allclose(maps.numpy()[valid], ref[valid], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(iy.numpy(), np.asarray(riy))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(rix))


def test_bank_layouts_agree(rng):
    """A bank shared by every image and one bank per image give the same
    planes; a 2-D image spectrum drops the image axis."""
    imgs = torch.from_numpy(rng.normal(size=(2, 128, 128)))
    tiles = torch.from_numpy(rng.normal(size=(3, 15, 15)))
    prep = t_ncc.zncc_prepare_image(imgs, 15, 15)
    bank = t_ncc.prep_template(tiles, 128, 128)
    shared = cuda_fftp.corr_from_rfft(prep["F"], bank["Ft"], s=(128, 128))
    per_image = cuda_fftp.corr_from_rfft(
        prep["F"], bank["Ft"][None].expand(2, -1, -1, -1), s=(128, 128)
    )
    single = cuda_fftp.corr_from_rfft(prep["F"][1], bank["Ft"], s=(128, 128))
    assert shared.shape == (2, 3, 128, 128) and single.shape == (3, 128, 128)
    torch.testing.assert_close(shared, per_image, rtol=0, atol=0)
    torch.testing.assert_close(shared[1], single, rtol=0, atol=0)

    var_full = torch.nn.functional.pad(prep["var_sum"], (0, 14, 0, 14))
    maps, iy, ix = cuda_fftp.ncc_masked_peaks(
        prep["F"], bank["Ft"], var_full, bank["energy"], valid_hw=(114, 114), s=(128, 128)
    )
    assert maps.shape == (2, 3, 128, 128) and iy.shape == (2, 3)
    ai, aj = argmax2d(maps)
    assert torch.equal(iy, ai) and torch.equal(ix, aj)
    with pytest.raises(ValueError):
        cuda_fftp.corr_from_rfft(prep["F"], bank["Ft"][None], s=(128, 128))


@pytest.mark.parametrize(
    "shape, covered",
    [((128, 128), True), ((2048, 2048), True), ((4096, 256), True), ((64, 64), False),
     ((227, 227), False), ((8192, 8192), False), ((2048, 1024 + 512), False)],
)
def test_supported_shapes(shape, covered):
    assert cuda_fftp.supported(shape) is covered


def test_cpu_tensors_never_touch_the_kernel(rng):
    cuda_fftp.reset_counts()
    F = torch.fft.rfft2(torch.from_numpy(rng.normal(size=(1, 256, 256)).astype(np.float32)))
    cuda_fftp.corr_from_rfft(F, F[:, None], s=(256, 256))
    assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0}
    assert cuda_fftp.PLAIN_BY_SHAPE == {}
