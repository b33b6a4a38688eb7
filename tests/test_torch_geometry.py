# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``barc4dip_tpu_torch.geometry`` against the JAX package's
``geometry`` (exact: slicing, padding and integer arithmetic), NumPy and
tensor inputs, and that the port's public namespaces export every name the
JAX package's do."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import barc4dip_tpu as jdip
import barc4dip_tpu_torch as tdip
from barc4dip_tpu import geometry as j_geo
from barc4dip_tpu_torch import geometry as t_geo


@pytest.mark.parametrize("namespace", ["signal", "maths", "geometry", "metrics"])
def test_public_namespace_exports_every_jax_name(namespace):
    import barc4dip_tpu.metrics  # noqa: F401 - a lazy submodule of the JAX package

    want = set(getattr(jdip, namespace).__all__)
    port = getattr(tdip, namespace)
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for name in port.__all__:
        assert callable(getattr(port, name)), name
    assert namespace in tdip.__all__


def test_package_names_the_jax_packages_namespaces():
    for name in ("geometry", "maths", "signal", "metrics", "utils"):
        assert name in tdip.__all__ and name in jdip.__all__
    assert "tracking_grid_from_frame0" in tdip.metrics.__all__  # an extra of the port


@pytest.mark.parametrize("shape", [(64, 64), (63, 64), (64, 101), (7, 5), (4, 9)])
@pytest.mark.parametrize("constant", [1.0, 0.5, 0.33, 3.0])
def test_crop_to_square_center(rng, shape, constant):
    a = rng.normal(size=shape)
    want = j_geo.crop_to_square_center(a, constant)
    np.testing.assert_array_equal(t_geo.crop_to_square_center(a, constant), want)
    got = t_geo.crop_to_square_center(torch.from_numpy(a), constant)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[0] == got.shape[1] and got.shape[0] % 2 == 1


@pytest.mark.parametrize("shape, constant", [((2, 9), 0.33), ((8, 8), 0.01), ((0, 8), 1.0)])
def test_crop_to_square_center_error_matches_jax(shape, constant):
    with pytest.raises(ValueError) as want:
        j_geo.crop_to_square_center(np.zeros(shape), constant)
    for a in (np.zeros(shape), torch.zeros(shape)):
        with pytest.raises(ValueError) as got:
            t_geo.crop_to_square_center(a, constant)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(5, 9), (9, 5), (6, 6), (1, 4)])
@pytest.mark.parametrize("fill", [0.0, -2.5])
def test_pad_to_square(rng, shape, fill):
    a = rng.normal(size=shape)
    want = j_geo.pad_to_square(a, fill_value=fill)
    np.testing.assert_array_equal(t_geo.pad_to_square(a, fill_value=fill), want)
    got = t_geo.pad_to_square(torch.from_numpy(a), fill_value=fill)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_geo.pad_to_square(jnp.asarray(a), fill_value=fill)))
    for mod, arg in ((j_geo, a[None]), (t_geo, a[None]), (t_geo, torch.zeros(2, 3, 3))):
        with pytest.raises(ValueError, match="2D"):
            mod.pad_to_square(arg)


def test_pad_to_square_dtype(rng):
    a = rng.integers(0, 100, size=(4, 7)).astype(np.uint16)
    want = j_geo.pad_to_square(a, fill_value=3, dtype=np.float32)
    got_np = t_geo.pad_to_square(a, fill_value=3, dtype=np.float32)
    assert got_np.dtype == np.float32
    np.testing.assert_array_equal(got_np, want)
    got = t_geo.pad_to_square(torch.from_numpy(a.astype(np.int32)), fill_value=3, dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slices", [(slice(2, 7), slice(0, 4)), (slice(0, 5), slice(6, 10)),
                                    (slice(5, 10), slice(3, 7))])
def test_embed_roi(rng, slices):
    roi = rng.normal(size=(5, 4))
    kw = dict(out_shape=(10, 10), slices_yx=slices, fill_value=1.5)
    want = j_geo.embed_roi(roi, **kw)
    np.testing.assert_array_equal(t_geo.embed_roi(roi, **kw), want)
    got = t_geo.embed_roi(torch.from_numpy(roi), **kw)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_geo.embed_roi(jnp.asarray(roi), **kw)))
    ints = t_geo.embed_roi(torch.arange(20).reshape(5, 4), out_shape=(10, 10), slices_yx=slices, fill_value=7)
    assert ints.dtype == torch.int64 and int(ints.sum()) == 190 + 7 * 80


def test_embed_roi_shape_error_matches_jax():
    kw = dict(out_shape=(10, 10), slices_yx=(slice(0, 5), slice(0, 5)))
    for roi in (np.zeros((5, 4)), torch.zeros(4, 5)):
        with pytest.raises(ValueError) as got:
            t_geo.embed_roi(roi, **kw)
        with pytest.raises(ValueError) as want:
            j_geo.embed_roi(np.zeros((5, 4)), **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("center", [None, (10, 12), (0, 0), (39, 29), (-8, 50), (3, 28)])
@pytest.mark.parametrize("size", [(5, 7), (21, 9)])
def test_roi_slices_clip_or_raise(center, size):
    """``clip=True`` clamps as the JAX package does; ``clip=False`` raises
    the same error where the ROI leaves the image."""
    shape = (40, 30)
    assert t_geo.roi_slices(shape, size, center_yx=center, clip=True) == \
        j_geo.roi_slices(shape, size, center_yx=center, clip=True)
    try:
        want = j_geo.roi_slices(shape, size, center_yx=center)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            t_geo.roi_slices(shape, size, center_yx=center)
    else:
        assert t_geo.roi_slices(shape, size, center_yx=center) == want


def test_square_embed_slices_and_grid_equal_jax():
    from barc4dip_tpu.geometry.masks import square_embed_slices as j_ses

    for shape in ((5, 9), (9, 5), (6, 6)):
        assert t_geo.square_embed_slices(shape) == j_ses(shape)
    got, labels = t_geo.roi_grid_3x3((100, 120), (11, 11), (20, 25))
    want, wlabels = j_geo.roi_grid_3x3((100, 120), (11, 11), (20, 25))
    assert got.tolist() == want.tolist() and labels.tolist() == wlabels.tolist()
    assert t_geo.odd_size(6.2) == j_geo.odd_size(6.2) == 7
