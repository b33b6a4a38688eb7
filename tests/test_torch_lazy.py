# SPDX-License-Identifier: CECILL-2.1
"""The port's lazy array leaves (``barc4dip_tpu_torch/utils/lazy.py``, its
own copy of ``barc4dip_tpu/utils/lazy.py``) through the five cases of
``tests/test_lazy.py``: deferral, caching, the operator surface, shape
checks and per-frame fetches."""
import numpy as np
import pytest

from barc4dip_tpu_torch.utils.lazy import LazyMap, LazyMapStack


def test_lazy_map_defers_then_caches():
    calls = []

    def fetch():
        calls.append(1)
        return np.full((4, 5), 2.5)

    m = LazyMap((4, 5), np.float64, fetch)
    assert m.shape == (4, 5) and m.ndim == 2 and m.dtype == np.float64
    assert m.size == 20
    assert not calls, "metadata access must not materialize"

    np.testing.assert_array_equal(np.asarray(m), 2.5)
    assert m[1, 2] == 2.5
    np.testing.assert_array_equal(m + 0.5, 3.0)
    np.testing.assert_array_equal(1.0 - m, -1.5)
    assert m.mean() == 2.5 and m.max() == 2.5
    assert len(calls) == 1, "fetch must run exactly once"


def test_lazy_map_full_operator_surface():
    m = LazyMap((2, 2), np.float64, lambda: np.array([[1.0, 2.0], [3.0, 4.0]]))
    np.testing.assert_array_equal(m > 2.0, [[False, False], [True, True]])
    np.testing.assert_array_equal(m <= 1.0, [[True, False], [False, False]])
    np.testing.assert_array_equal(abs(-1.0 * m), [[1, 2], [3, 4]])
    np.testing.assert_array_equal(m ** 2, [[1, 4], [9, 16]])
    np.testing.assert_array_equal((m > 1) & (m < 4), [[False, True], [True, False]])
    np.testing.assert_array_equal(m @ np.eye(2), [[1, 2], [3, 4]])
    np.testing.assert_array_equal(m // 2, [[0, 1], [1, 2]])


def test_lazy_map_shape_mismatch_raises():
    m = LazyMap((3, 3), np.float32, lambda: np.zeros((2, 2), np.float32))
    with pytest.raises(RuntimeError):
        np.asarray(m)


def test_lazy_stack_per_frame_fetch():
    fetched = []

    def fetch(t):
        fetched.append(t)
        return np.full((3, 3), float(t))

    s = LazyMapStack(4, (3, 3), np.float64, fetch)
    assert s.shape == (4, 3, 3) and len(s) == 4

    np.testing.assert_array_equal(s[2], 2.0)
    assert fetched == [2], "integer indexing materializes one frame only"
    assert s[2, 1, 1] == 2.0 and fetched == [2], "frame cache reused"
    np.testing.assert_array_equal(s[-1], 3.0)

    full = np.asarray(s)
    assert full.shape == (4, 3, 3)
    assert sorted(fetched) == [0, 1, 2, 3]
    np.testing.assert_array_equal(full[1], 1.0)

    # after full materialization, indexing comes from the cached array
    n = len(fetched)
    np.testing.assert_array_equal(s[0], 0.0)
    assert len(fetched) == n


def test_lazy_stack_slice_and_iter():
    s = LazyMapStack(3, (2, 2), np.float32,
                     lambda t: np.full((2, 2), t, np.float32))
    np.testing.assert_array_equal(s[1:][0], 1.0)
    frames = list(s)
    assert len(frames) == 3
    with pytest.raises(IndexError):
        s[7]
