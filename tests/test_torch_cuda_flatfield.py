# SPDX-License-Identifier: CECILL-2.1
"""The flat-field's stacked flats and darks reduced on the card from their
raw counts, and numpy images sent there as raw counts in chunks and cast
there. Marked ``cuda``: they skip where no card is present. On the
card (the module imports nothing of JAX):

    python -m pytest --noconftest tests/test_torch_cuda_flatfield.py -q
"""
import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.preprocessing import normalize

pytestmark = pytest.mark.cuda
SIDE = 512


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stacks are reduced on the card")
    return torch.device("cuda", 0)


def _raw(seed=8, frames=4):
    """``frames`` images, 10 flats and 10 darks as uint16 counts, a few dead pixels."""
    rng = np.random.default_rng(seed)
    gain = rng.normal(2.0, 0.1, size=(SIDE, SIDE))
    flats = np.round(gain * 10000.0 + 100.0 + rng.normal(0, 30, size=(10, SIDE, SIDE)))
    flats[:, rng.random((SIDE, SIDE)) < 0.001] = 90.0  # flat <= dark: a dead pixel
    darks = np.round(100.0 + rng.normal(0, 2, size=(10, SIDE, SIDE)))
    images = rng.poisson(800.0, size=(frames, SIDE, SIDE)) * gain + 100.0
    return images.astype(np.uint16), flats.astype(np.uint16), darks.astype(np.uint16)


def _host_mean(stack):
    return np.asarray(stack, dtype=np.float32).mean(axis=0)


def test_card_stacks_equal_their_numpy_copies_and_stay_on_the_card(dev):
    raw, flats, darks = _raw()
    images = torch.from_numpy(raw).to(dev)
    kw = dict(bad_pixel_removal=True)
    got = normalize.flat_field_correction(
        images, flats=torch.from_numpy(flats).to(dev), darks=torch.from_numpy(darks).to(dev), **kw)
    assert normalize.LAST_RUN_PERF["calib_device_frames"] == flats.shape[0] + darks.shape[0]
    want = normalize.flat_field_correction(images, flats=flats, darks=darks, **kw)
    assert isinstance(got, torch.Tensor) and got.device == dev and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_card_means_are_the_host_float32_means_bit_for_bit(dev):
    raw, flats, darks = _raw(seed=9)
    kw = dict(bad_pixel_removal=True, device=dev)
    got = normalize.flat_field_correction(raw, flats=flats, darks=darks, **kw)
    want = normalize.flat_field_correction(raw, flats=_host_mean(flats), darks=_host_mean(darks), **kw)
    np.testing.assert_array_equal(got, want)


def test_numpy_stack_equals_its_card_float32_twin_in_no_more_memory(dev):
    frames = 2 * normalize.UPLOAD_CHUNK_FRAMES + 1  # a short last chunk
    raw, flats, darks = _raw(seed=10, frames=frames)
    kw = dict(flats=flats, darks=darks, bad_pixel_removal=True, as_numpy=False, device=dev)
    normalize.flat_field_correction(raw, **kw)  # warm: kernels, plans and constants cached on the card
    torch.cuda.synchronize(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    got = normalize.flat_field_correction(raw, **kw)
    torch.cuda.synchronize(dev)
    peak_numpy = torch.cuda.max_memory_allocated(dev)
    assert normalize.LAST_RUN_PERF["upload_device_frames"] == frames
    got = got.cpu()

    twin = torch.from_numpy(raw.astype(np.float32)).to(dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    want = normalize.flat_field_correction(twin, **kw)
    torch.cuda.synchronize(dev)
    peak_twin = torch.cuda.max_memory_allocated(dev)
    assert normalize.LAST_RUN_PERF["upload_device_frames"] == 0
    assert torch.equal(got, want.cpu())
    chunk_f32 = normalize.UPLOAD_CHUNK_FRAMES * SIDE * SIDE * 4
    assert peak_numpy <= peak_twin + chunk_f32, (peak_numpy, peak_twin)
