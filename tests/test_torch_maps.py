# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``barc4dip_tpu_torch.metrics.visibility_map`` against the
JAX package's on the same seeded numpy input (CPU, ``device="cpu"``), with
the cases of ``tests/test_maps.py``.

Tolerance against JAX: 2e-5 of the map's peak (both compute in float32);
against a float64 evaluation of the definition at production count levels:
rtol 1e-4 a window, as the JAX package's own test holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from barc4dip_tpu.metrics import visibility_map as j_vis
from barc4dip_tpu.utils.synthetic import speckle_field
from barc4dip_tpu_torch.metrics import amplitude, maps
from barc4dip_tpu_torch.metrics import visibility_map as t_vis
from tests.test_maps import _brute_force
from tests.test_torch_ops import close

torch.set_num_threads(2)
F32 = 2e-5
CPU = {"device": "cpu"}


@pytest.mark.parametrize("shape, window, stride", [((24, 30), 5, 1), ((64, 64), 16, 1), ((50, 41), 8, 3),
                                                   ((33, 64), 2, 2), ((40, 40), 40, 1)])
@pytest.mark.parametrize("kind", ["float32", "float64", "uint16"])
def test_single_image_against_jax(shape, window, stride, kind):
    rng = np.random.default_rng(0)
    img = ((rng.random(shape) + 0.2) * 1000.0).astype(kind)
    got = t_vis(img, window=window, stride=stride, **CPU)
    want = j_vis(img, window=window, stride=stride)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    close(got, want, F32)


def test_matches_brute_force_sliding_window():
    rng = np.random.default_rng(0)
    img = (rng.random((24, 30)).astype(np.float32) + 0.2) * 100.0
    got = t_vis(img, window=5, **CPU)
    assert got.shape == (20, 26)
    np.testing.assert_allclose(got, _brute_force(img, 5), rtol=2e-4, atol=1e-6)


def test_nonpositive_mean_windows_are_nan():
    img = np.zeros((12, 12), np.float32)
    img[8:, 8:] = 5.0
    got = t_vis(img, window=4, **CPU)
    want = j_vis(img, window=4)
    assert np.isnan(got[0, 0]) and np.isfinite(got[-1, -1])
    close(got, want, F32)  # equal NaN masks too
    assert np.isnan(t_vis(np.zeros((8, 8), np.float32), window=4, **CPU)).all()  # global mean 0


def test_stride_subsamples_the_full_map():
    rng = np.random.default_rng(1)
    img = rng.random((32, 32)).astype(np.float32) + 0.5
    full = t_vis(img, window=8, **CPU)
    np.testing.assert_array_equal(t_vis(img, window=8, stride=3, **CPU), full[::3, ::3])


@pytest.mark.parametrize("chunk", [8, 2, 1])
def test_stack_and_residence(chunk):
    stack = np.stack([speckle_field((48, 48), grain_px=4.0, seed=s).astype(np.float32) for s in range(3)])
    out_np = t_vis(stack, window=9, frame_chunk=chunk, **CPU)
    assert out_np.shape == (3, 40, 40) and isinstance(out_np, np.ndarray)
    close(out_np, j_vis(stack, window=9, frame_chunk=chunk), F32)
    out_dev = t_vis(torch.from_numpy(stack), window=9, frame_chunk=chunk)  # tensor in, tensor out
    assert isinstance(out_dev, torch.Tensor) and out_dev.device.type == "cpu"
    np.testing.assert_array_equal(out_dev.numpy(), out_np)
    close(out_dev, j_vis(jnp.asarray(stack), window=9, frame_chunk=chunk), F32)
    # per-frame independence: frame 0 alone equals the stack's slice
    np.testing.assert_array_equal(t_vis(stack[0], window=9, **CPU), out_np[0])
    one = t_vis(torch.from_numpy(stack[0]), window=9)
    assert isinstance(one, torch.Tensor) and one.shape == (40, 40)


def test_integer_and_float64_tensors_compute_in_float32():
    rng = np.random.default_rng(3)
    raw = rng.integers(200, 4000, size=(2, 40, 40)).astype(np.uint16)
    want = t_vis(raw.astype(np.float32), window=8, **CPU)
    for tensor in (torch.from_numpy(raw), torch.from_numpy(raw.astype(np.float64))):
        got = t_vis(tensor, window=8)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_visibility_definition_matches_full_frame_metric():
    img = speckle_field((64, 64), grain_px=5.0, seed=7).astype(np.float32)
    vm = t_vis(img, window=64, **CPU)
    assert vm.shape == (1, 1)
    np.testing.assert_allclose(vm[0, 0], amplitude(img, verbose=False, **CPU)["visibility"], rtol=2e-5)


def test_f32_accuracy_at_production_count_levels():
    """Separable box sums hold float32 round-off on a large frame at
    detector count levels, where an integral image loses about three
    significant digits to cancellation; the float64 run of the same code is
    the reference the card check uses."""
    img = (speckle_field((512, 512), grain_px=5.0, seed=11) * 12.0 + 5000.0).astype(np.float32)
    got = t_vis(img, window=16, stride=16, **CPU)
    img64 = img.astype(np.float64)
    for i in range(0, got.shape[0], 7):
        for j in range(0, got.shape[1], 7):
            patch = img64[16 * i : 16 * i + 16, 16 * j : 16 * j + 16]
            np.testing.assert_allclose(got[i, j], patch.std() / patch.mean(), rtol=1e-4)
    ref = maps._visibility_frames(torch.from_numpy(img64)[None], 16, 16)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    close(got, j_vis(img, window=16, stride=16), F32)


def test_box_sum_is_a_plain_window_sum():
    x = torch.arange(2 * 6 * 7, dtype=torch.float64).reshape(2, 6, 7)
    got = maps._box_sum_valid(x, 3)
    want = x.unfold(-2, 3, 1).unfold(-2, 3, 1).sum(dim=(-2, -1))
    assert torch.equal(got, want)


def test_validation_errors_match_jax():
    img = np.ones((16, 16), np.float32)
    for args, kw in (((img,), dict(window=1)), ((img,), dict(stride=0)), ((img,), dict(window=17)),
                     ((img[None, None],), {})):
        with pytest.raises(ValueError) as want:
            j_vis(*args, **kw)
        with pytest.raises(ValueError) as got:
            t_vis(*args, **kw, **CPU)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="numpy.ndarray or torch.Tensor"):
        t_vis([[1.0]], **CPU)
