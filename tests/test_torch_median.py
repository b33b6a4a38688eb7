# SPDX-License-Identifier: CECILL-2.1
"""Kernel K2's module on the CPU: the port's ``median_filter2d`` (the plain
version of K2 here) against the JAX package's Pallas 3x3 median kernel in
interpret mode and its lax path, on the same seeded inputs. A median picks
one of its inputs, so every comparison is exact."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from barc4dip_tpu.ops.pallas_median import median3x3_pallas
from barc4dip_tpu.ops.rank import median_filter2d as jax_median
from barc4dip_tpu_torch.ops import cuda_median
from barc4dip_tpu_torch.ops.rank import median_filter2d

torch.set_num_threads(2)


def _pallas_interpret(x):
    from jax.experimental import pallas as pl

    orig_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig_call(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", interp_call):
        return np.asarray(median3x3_pallas(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(64, 64), (200, 130), (300, 257)])
def test_matches_pallas_kernel_interpreted(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    got = median_filter2d(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(got, _pallas_interpret(x))
    np.testing.assert_array_equal(got, ndimage.median_filter(x, size=3, mode="reflect"))


@pytest.mark.parametrize("size", [1, 3, 5])
@pytest.mark.parametrize("shape", [(37, 52), (3, 29, 41)])
def test_matches_lax_path(size, shape):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    got = median_filter2d(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_median(jnp.asarray(x), size)))


def test_nan_propagates_as_on_the_tpu():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(70, 45)).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    x[0, 0] = x[-1, -1] = x[33, 0] = np.nan  # corners and an edge
    got = median_filter2d(torch.from_numpy(x), 3).numpy()
    want = _pallas_interpret(x)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


def test_batch_equals_each_plane():
    x = np.random.default_rng(5).normal(size=(4, 33, 20)).astype(np.float32)
    got = cuda_median.median3x3_plain(torch.from_numpy(x)).numpy()
    for b in range(4):
        np.testing.assert_array_equal(got[b], ndimage.median_filter(x[b], size=3, mode="reflect"))


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (6, 1), (2, 2)])
def test_tiny_frames_match_scipy(shape):
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    got = median_filter2d(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(got, ndimage.median_filter(x, size=3, mode="reflect"))


@pytest.mark.parametrize("size", [0, 2, 4, -3])
def test_even_or_nonpositive_size_raises(size):
    with pytest.raises(ValueError, match="odd"):
        median_filter2d(torch.zeros(8, 8), size)


def test_cpu_calls_launch_and_count_nothing():
    cuda_median.reset_counts()
    median_filter2d(torch.zeros(2, 8, 8), 3)
    median_filter2d(torch.zeros(8, 8, dtype=torch.float64), 5)
    assert cuda_median.LAUNCHES == {"median3x3": 0}
    assert cuda_median.PLAIN_BY_SHAPE == {}


def _nan_min(a, b):
    return np.where((a < b) | (a != a), a, b)


def _nan_max(a, b):
    return np.where((a > b) | (a != a), a, b)


def _med3(a, b, c):
    return _nan_max(_nan_min(a, b), _nan_min(_nan_max(a, b), c))


def _column_sort_median(v):
    """K2's median of 9 (``csrc/median3x3.cu``): each column of 3 sorted by
    three NaN-propagating exchanges, then med3(max of the minima, med3 of
    the medians, min of the maxima). ``v``: 9 arrays, row-major 3x3."""
    cols = []
    for c in range(3):
        a, b, d = v[c], v[3 + c], v[6 + c]
        a, b = _nan_min(a, b), _nan_max(a, b)
        b, d = _nan_min(b, d), _nan_max(b, d)
        a, b = _nan_min(a, b), _nan_max(a, b)
        cols.append((a, b, d))
    lo = _nan_max(_nan_max(cols[0][0], cols[1][0]), cols[2][0])
    md = _med3(cols[0][1], cols[1][1], cols[2][1])
    hi = _nan_min(_nan_min(cols[0][2], cols[1][2]), cols[2][2])
    return _med3(lo, md, hi)


@pytest.mark.parametrize("specials", [False, True])
def test_column_sort_median_equals_median9(specials):
    """The kernel's column-sort median equals the TPU kernel's Paeth network
    (``pallas_median._median9``) on random 3x3 sets with ties and, with
    ``specials``, NaN and +-inf: NaN wherever the set holds one."""
    from barc4dip_tpu.ops.pallas_median import _median9

    rng = np.random.default_rng(11 + specials)
    v = rng.integers(-4, 5, size=(9, 50000)).astype(np.float32)
    if specials:
        v[rng.random(v.shape) < 0.04] = np.inf
        v[rng.random(v.shape) < 0.04] = -np.inf
        v[rng.random(v.shape) < 0.02] = np.nan
    got = _column_sort_median(list(v))
    want = np.asarray(_median9([jnp.asarray(x) for x in v]))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() == specials


@pytest.mark.parametrize("shape", [(37, 52), (8, 128), (1, 5), (45, 70), (33, 129)])
def test_kernel_model_matches_scipy(shape):
    """K2's whole arithmetic on an image: rows and columns clamped (the
    symmetric pad of width 1) and the column-sort median, exactly
    scipy's 3x3 median, including widths that are not a multiple of 4."""
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    H, W = shape
    ys, xs = np.arange(H), np.arange(W)
    v = [x[np.clip(ys + dy, 0, H - 1)][:, np.clip(xs + dx, 0, W - 1)]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    np.testing.assert_array_equal(_column_sort_median(v),
                                  ndimage.median_filter(x, size=3, mode="reflect"))
