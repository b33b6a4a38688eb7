# SPDX-License-Identifier: CECILL-2.1
"""Port parity of the sharpness API on one image: the stencils, the
subspace eigen-solver, each estimator core and standalone estimator, and
``sharpness_stats`` leaf by leaf, against the JAX package on the same seeded
float64 inputs (CPU).

Tolerances: rtol 1e-9 with equal finiteness (``close``) unless stated; the
stencils against SciPy at 1e-12 of the output's scale; subspace-iteration
eigenvalues at rtol 5e-6 (the JAX test's own bound against a dense solve:
the two packages draw different start blocks); the golden snapshot at the
tolerance ``tests/test_golden_snapshot.py`` uses (rel 1e-9, abs 1e-12).
"""
import json
import pathlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

import barc4dip_tpu.metrics as jm
import barc4dip_tpu.metrics.sharpness as j_sharp
import barc4dip_tpu_torch.metrics as tm
import barc4dip_tpu_torch.metrics.sharpness as t_sharp
from barc4dip_tpu.metrics import estimators as j_est
from barc4dip_tpu.ops import eig as j_eig
from barc4dip_tpu.ops import stencils as j_st
from barc4dip_tpu_torch.metrics import estimators as t_est
from barc4dip_tpu_torch.ops import corrcore as t_corr
from barc4dip_tpu_torch.ops import eig as t_eig
from barc4dip_tpu_torch.ops import stencils as t_st
from tests.conftest import make_speckle
from tests.test_torch_ops import close, t

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def assert_stats_close(got, want, rtol=1e-9, sections=("full", "tiles")):
    """Every leaf of the sections: same keys, same finiteness, rtol."""
    for sec in sections:
        assert (sec in got) == (sec in want), sec
        if sec not in want:
            continue
        dg, dw = dict(_leaves(got[sec])), dict(_leaves(want[sec]))
        assert dg.keys() == dw.keys()
        for k, w in dw.items():
            g, w = np.asarray(dg[k], np.float64), np.asarray(w, np.float64)
            assert g.shape == w.shape, k
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w), err_msg=k)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=f"{sec}.{k}")


# -- stencils -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["sobel_x", "sobel_y", "laplace"])
def test_stencils_match_jax_and_scipy(rng, name):
    imgs = rng.normal(size=(2, 40, 52))
    scipy_fn = {
        "sobel_x": lambda x: ndi.sobel(x, axis=1, mode="reflect"),
        "sobel_y": lambda x: ndi.sobel(x, axis=0, mode="reflect"),
        "laplace": lambda x: ndi.laplace(x, mode="reflect"),
    }[name]
    got = getattr(t_st, name)(t(imgs)).numpy()
    for k in range(2):
        close(got[k], getattr(j_st, name)(jnp.asarray(imgs[k])))
        want = scipy_fn(imgs[k])
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-12 * np.abs(want).max())
    # a NaN and an inf spread only through the non-zero taps, as in the JAX form
    imgs[0, 5, 6] = np.nan
    imgs[1, 0, 0] = np.inf
    got = getattr(t_st, name)(t(imgs)).numpy()
    for k in range(2):
        close(got[k], getattr(j_st, name)(jnp.asarray(imgs[k])))
    if name == "laplace":  # the corner taps are zero
        assert np.isfinite(got[0, 4, 5]) and np.isnan(got[0, 4, 6])


# -- the subspace eigen-solver ------------------------------------------------

def _gram(img):
    x = img / np.sqrt((img * img).sum())
    J = x - x.mean()
    return J @ J.T


def test_subspace_solver_matches_jax_and_dense(rng, monkeypatch):
    """Top-5 of a speckle Gram matrix: the port against a dense float64
    solve and against the JAX solver, both at rtol 5e-6 (the bound of
    ``tests/test_metrics_estimators.py``); a batch equals its matrices one
    by one; the start block repeats run to run."""
    Gs = np.stack([_gram(make_speckle(rng, shape=(300, 300), grain_px=g)) for g in (7.0, 4.0)])
    got = t_eig.topk_eigvalsh_subspace(t(Gs), 5).numpy()
    assert got.shape == (2, 5)
    for k in range(2):
        dense = np.flip(np.linalg.eigvalsh(Gs[k]))[:5]
        np.testing.assert_allclose(got[k], dense, rtol=5e-6)
        np.testing.assert_allclose(
            got[k], np.asarray(j_eig.topk_eigvalsh_subspace(jnp.asarray(Gs[k]), 5)), rtol=5e-6
        )
        one = t_eig.topk_eigvalsh_subspace(t(Gs[k]), 5).numpy()
        np.testing.assert_allclose(one, got[k], rtol=1e-12)
    again = t_eig.topk_eigvalsh_subspace(t(Gs), 5).numpy()
    np.testing.assert_array_equal(again, got)
    # another start block converges to the same values
    monkeypatch.setattr(t_eig, "_START_SEED", 123)
    own = t_eig.topk_eigvalsh_subspace(t(Gs), 5).numpy()
    assert not np.array_equal(own, got)
    np.testing.assert_allclose(own, got, rtol=5e-6)
    monkeypatch.undo()
    # a block as wide as the matrix is the exact solve
    small = _gram(rng.normal(size=(20, 30)))
    np.testing.assert_allclose(
        t_eig.topk_eigvalsh_subspace(t(small), 3).numpy(),
        np.flip(np.linalg.eigvalsh(small))[:3], rtol=1e-9,
    )


def test_eigenvalues_auto_takes_subspace_from_1024_px(rng):
    """A 1030 x 1040 frame goes through the subspace solver in both
    packages ("auto"): agreement at rtol 5e-6, and with the port's dense
    path at the same bound."""
    img = make_speckle(rng, shape=(1030, 1040), grain_px=7.0)
    got = tm.eigenvalues(img, device="cpu")
    want = jm.eigenvalues(img)
    dense = tm.eigenvalues(img, eig_method="dense", device="cpu")
    for k in ("eigenvalues", "e1", "e2", "re"):
        assert got[k] == pytest.approx(want[k], rel=5e-6), k
        assert got[k] == pytest.approx(dense[k], rel=5e-6), k
    assert got["e1"] != dense["e1"]  # not the same solver


# -- estimator cores ----------------------------------------------------------

_CORES = {
    "tenengrad": ("tenengrad_core", {}),
    "laplacian_variance": ("laplacian_variance_core", {}),
    "spectral_entropy": ("spectral_entropy_core", {}),
    "spectral_entropy_raw": ("spectral_entropy_core", {"remove_mean": False, "remove_dc": False}),
    "iaw": ("inverse_autocorr_width_core", {}),
    "iaw_binned": ("inverse_autocorr_width_core", {"radial_method": "binned", "fraction": 0.5}),
    "eigenvalues": ("eigenvalues_core", {}),
    "eigenvalues_k1": ("eigenvalues_core", {"k": 1}),
    "eigenvalues_subspace": ("eigenvalues_core", {"eig_method": "subspace", "k": 3}),
}


def _core_batch(rng, shape):
    a = make_speckle(rng, shape=shape, grain_px=4.0)
    b = a.copy()
    b[3, 4] = np.nan
    b[10, 11] = np.inf
    b[20, 5] = -np.inf
    return np.stack([a, b, np.full(shape, 3.0), np.zeros(shape)])


@pytest.mark.parametrize("shape", [(64, 64), (48, 72), (75, 64)])
@pytest.mark.parametrize("case", list(_CORES))
def test_estimator_cores_match_jax(rng, case, shape):
    """A batch of four images (speckle; the same with NaN, +inf and -inf
    pixels; a constant; all zeros) through the port's batched core against
    the JAX core image by image, rtol 1e-9 with equal NaN/inf.

    Two stated exceptions, both for the eigenvalues group. The subspace
    solver is held at rtol 5e-6 (different start blocks). On the constant
    image the covariance is the round-off of the mean removal (~1e-34
    against ~1e-7 for speckle), so its eigenvalues are noise in both
    packages: they are held below 1e-25 and not compared."""
    name, kw = _CORES[case]
    batch = _core_batch(rng, shape)
    got = getattr(t_est, name)(t(batch), **kw)
    jfn = jax.jit(lambda x: getattr(j_est, name)(x, **kw))
    rtol = 5e-6 if "subspace" in case else 1e-9
    for i in range(len(batch)):
        ref = jfn(jnp.asarray(batch[i]))
        assert set(ref) == set(got)
        for key, v in ref.items():
            assert got[key].shape == (len(batch),)
            if name == "eigenvalues_core" and i == 2:
                if key != "re":
                    assert 0 <= float(got[key][i]) < 1e-25 and 0 <= float(v) < 1e-25
                continue
            close(got[key][i], v, rtol=rtol)


def test_eigenvalues_core_rejects_unknown_method(rng):
    with pytest.raises(ValueError, match="eig_method"):
        t_est.eigenvalues_core(t(rng.normal(size=(8, 8))), eig_method="qr")


@pytest.mark.parametrize("shape", [(64, 64), (50, 70)])
def test_autocorr2d_core_standardized(rng, shape):
    """``standardize=True`` divides by the population std of each image; a
    constant image (std 0) is left as it is."""
    from barc4dip_tpu.ops import corrcore as j_corr

    imgs = np.stack([make_speckle(rng, shape=shape, grain_px=4.0), np.full(shape, 2.0)])
    for normalize in ("peak", "none"):
        got = t_corr.autocorr2d_core(t(imgs), standardize=True, normalize=normalize).numpy()
        for k in range(2):
            close(got[k], j_corr.autocorr2d_core(
                jnp.asarray(imgs[k]), standardize=True, normalize=normalize))
    assert got[0].max() == pytest.approx(shape[0] * shape[1], rel=1e-9)  # unit variance


# -- standalone estimators ----------------------------------------------------

_STANDALONE = {
    "tenengrad": {},
    "laplacian_variance": {},
    "spectral_entropy": {},
    "inverse_autocorr_width": {"radial_method": "binned"},
    "eigenvalues": {"k": 3, "eig_method": "dense"},
}


@pytest.mark.parametrize("name", list(_STANDALONE))
def test_standalone_estimators_match_jax(rng, name):
    """numpy input against the JAX estimator at rtol 1e-9; a tensor input
    gives exactly the numpy input's result."""
    img = make_speckle(rng, shape=(96, 80), grain_px=5.0)
    kw = _STANDALONE[name]
    got = getattr(tm, name)(img, device="cpu", **kw)
    want = getattr(jm, name)(img, **kw)
    from_tensor = getattr(tm, name)(torch.from_numpy(img), **kw)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert isinstance(got[k], float)
            close(got[k], want[k])
        assert from_tensor == got
    else:
        assert isinstance(got, float)
        close(got, want)
        assert from_tensor == got


def _nan_image():
    return np.full((40, 40), np.nan)


def _one_nan():
    x = np.ones((40, 40))
    x[2, 2] = np.nan
    return x


_ERRORS = [
    ("tenengrad", lambda: np.ones((4, 4, 4)), {}),
    ("tenengrad", lambda: np.ones((0, 4)), {}),
    ("tenengrad", _nan_image, {}),
    ("laplacian_variance", lambda: np.ones(7), {}),
    ("laplacian_variance", _nan_image, {}),
    ("spectral_entropy", lambda: np.ones(9), {}),
    ("spectral_entropy", lambda: np.ones((0, 3)), {}),
    ("spectral_entropy", _one_nan, {}),
    ("spectral_entropy", lambda: np.ones((1, 2)), {}),
    ("spectral_entropy", lambda: np.full((16, 16), 2.0), {}),
    ("inverse_autocorr_width", lambda: np.ones((3, 40, 40)), {}),
    ("inverse_autocorr_width", lambda: np.ones((0, 40)), {}),
    ("inverse_autocorr_width", lambda: np.ones((16, 64)), {}),
    ("inverse_autocorr_width", lambda: np.ones((40, 40)), {"min_size_px": 41}),
    ("inverse_autocorr_width", lambda: np.ones((40, 40)), {"radial_method": "ring"}),
    ("eigenvalues", lambda: np.ones(5), {}),
    ("eigenvalues", lambda: np.ones((0, 5)), {}),
    ("eigenvalues", _one_nan, {}),
    ("eigenvalues", lambda: np.ones((8, 8)), {"k": 0}),
    ("eigenvalues", lambda: np.ones((1, 1)), {}),
    ("eigenvalues", lambda: np.zeros((8, 8)), {}),
]


@pytest.mark.parametrize("name,make,kw", _ERRORS, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(_ERRORS)])
def test_standalone_estimators_raise_as_jax(name, make, kw):
    """Every ``ValueError`` of the standalone estimators, under the same
    condition and with the same message, for numpy and for tensor input."""
    with pytest.raises(ValueError) as want:
        getattr(jm, name)(make(), **kw)
    with pytest.raises(ValueError) as got:
        getattr(tm, name)(make(), device="cpu", **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        getattr(tm, name)(torch.from_numpy(make()), **kw)
    assert str(got.value) == str(want.value)


# -- sharpness_stats ----------------------------------------------------------

def _patch_min_tile(monkeypatch, px):
    monkeypatch.setattr(j_sharp, "MIN_TILE_PX", px)
    monkeypatch.setattr(t_sharp, "MIN_TILE_PX", px)


def _lit_from_the_top(rng, shape):
    """Speckle brighter and finer at the top: the row flip changes every
    tile grid."""
    ramp = np.linspace(2.0, 0.5, shape[0])[:, None] * np.linspace(1.0, 1.2, shape[1])[None, :]
    return make_speckle(rng, shape=shape, grain_px=5.0) * ramp


@pytest.mark.parametrize(
    "mode,shape,origin",
    [
        ("off", (96, 120), "lower"),
        ("off", (96, 120), "upper"),
        ("tiles_3x3", (120, 132), "lower"),
        ("tiles_3x3", (120, 132), "upper"),
        ("subtiles_9x9", (300, 330), "lower"),
        ("subtiles_9x9", (300, 330), " Upper"),
    ],
)
def test_sharpness_stats_matches_jax(rng, monkeypatch, mode, shape, origin):
    """All six groups, full frame and tiles, leaf by leaf at rtol 1e-9.
    ``MIN_TILE_PX`` is lowered to 32 in both packages so that small frames
    reach the 3x3 and the 9x9 (four tile shapes) modes; the single-image
    call normalises the origin's spelling and echoes it as given."""
    _patch_min_tile(monkeypatch, 32)
    img = _lit_from_the_top(rng, shape)
    kw = dict(tiles=(mode != "off"), display_origin=origin, verbose=False)
    got = tm.sharpness_stats(img, device="cpu", **kw)
    want = jm.sharpness_stats(img, **kw)
    assert got["meta"].get("tile_mode", "off") == mode == want["meta"].get("tile_mode", "off")
    assert list(got["full"]) == list(want["full"])
    for k in ("kind", "display_origin", "input_shape", "requested_groups", "units",
              "tile_shape_px", "used_subtiles", "tile_grid_shape", "tile_order"):
        assert got["meta"].get(k) == want["meta"].get(k), k
    assert_stats_close(got, want)
    if mode != "off":
        std = got["tiles"]["gradient"]["tenengrad"]["std"]
        assert std.shape == (3, 3) and np.isnan(std).all() == (mode == "tiles_3x3")
        mean = got["tiles"]["stats"]["mean"]["mean"]
        assert (mean[0, 1] > mean[2, 1]) == (origin.strip().lower() == "upper")


@pytest.mark.parametrize(
    "metrics",
    ["gradient,laplacian", ["spectral"], ("autocorrelation", "stats"), "eigenvalues"],
    ids=["gradient,laplacian", "spectral", "autocorrelation+stats", "eigenvalues"],
)
def test_sharpness_stats_group_subsets(rng, monkeypatch, metrics):
    _patch_min_tile(monkeypatch, 32)
    img = _lit_from_the_top(rng, (120, 132))
    got = tm.sharpness_stats(img, metrics=metrics, verbose=False, device="cpu")
    want = jm.sharpness_stats(img, metrics=metrics, verbose=False)
    assert got["meta"]["requested_groups"] == want["meta"]["requested_groups"]
    assert list(got["full"]) == list(want["full"]) and set(got["tiles"]) == set(want["tiles"])
    assert_stats_close(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint16])
def test_sharpness_stats_tensor_equals_numpy(rng, monkeypatch, dtype):
    """A tensor input computes on its own device and gives exactly the
    numpy input's leaves; float32 and uint16 frames agree with the JAX
    package within float32 round-off (rtol 2e-4: the eigenvalue ratio and
    the spectral sums carry ~1e-5)."""
    _patch_min_tile(monkeypatch, 32)
    img = _lit_from_the_top(rng, (120, 132))
    img = np.round(img * 20).astype(dtype) if dtype == np.uint16 else img.astype(dtype)
    host = tm.sharpness_stats(img, verbose=False, device="cpu")
    tensor = tm.sharpness_stats(torch.from_numpy(img), verbose=False)
    assert_stats_close(tensor, host, rtol=0)
    assert_stats_close(host, jm.sharpness_stats(img, verbose=False),
                       rtol=1e-9 if dtype == np.float64 else 2e-4)


def test_sharpness_stats_nonfinite_pixels(rng):
    """NaN and inf pixels: the same leaves are NaN in both packages; a
    tensor with no finite value is not rejected (the JAX package does not
    check device arrays) and reads NaN."""
    img = make_speckle(rng, shape=(96, 96), grain_px=5.0)
    img[5, 7] = np.nan
    img[50, 3] = np.inf
    got = tm.sharpness_stats(img, tiles=False, verbose=False, device="cpu")
    assert_stats_close(got, jm.sharpness_stats(img, tiles=False, verbose=False))
    assert np.isnan(got["full"]["eigenvalues"]["e1"]) and np.isfinite(got["full"]["stats"]["mean"])
    blank = tm.sharpness_stats(torch.full((64, 64), np.nan), metrics="gradient",
                               tiles=False, verbose=False)
    assert blank["full"]["gradient"]["tenengrad"] == 0.0


def _bad_calls():
    ok = np.ones((64, 64))
    return [
        (TypeError, [[1.0, 2.0]], {}),
        (ValueError, np.ones((2, 64, 64)), {}),
        (ValueError, ok, {"display_origin": "bogus"}),
        (ValueError, ok, {"metrics": "sharp"}),
        (TypeError, ok, {"metrics": 3}),
        (ValueError, np.ones((20, 64)), {}),
        (ValueError, np.full((64, 64), np.nan), {"metrics": "laplacian"}),
    ]


@pytest.mark.parametrize("k", range(7))
def test_sharpness_stats_raises_as_jax(k):
    exc, image, kw = _bad_calls()[k]
    kw = dict(tiles=False, verbose=False, **kw)
    with pytest.raises(exc) as want:
        jm.sharpness_stats(image, **kw)
    with pytest.raises(exc) as got:
        tm.sharpness_stats(image, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_sharpness_stats_small_image_warns_and_runs_untiled(rng):
    img = make_speckle(rng, shape=(96, 96), grain_px=5.0)
    with pytest.warns(RuntimeWarning, match="too small for tiling"):
        got = tm.sharpness_stats(img, metrics="gradient", verbose=False, device="cpu")
    assert "tiles" not in got and "tile_mode" not in got["meta"]


def test_sharpness_stats_verbose_logs_and_prints(rng, caplog, capsys):
    img = make_speckle(rng, shape=(64, 64), grain_px=5.0)
    with caplog.at_level("INFO", logger=t_sharp.logger.name):
        tm.sharpness_stats(img, tiles=False, device="cpu")
    text = caplog.text
    for word in ("moments:", "tenengrad:", "laplacian variance:", "spectral_entropy:",
                 "inv_ac_width:", "eigenvalues:"):
        assert word in text
    assert ">> Total elapsed time:" in capsys.readouterr().out


# -- the golden snapshot ------------------------------------------------------

_GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden_snapshot.json").read_text())


@pytest.fixture(scope="module")
def golden_run():
    field = make_speckle(np.random.default_rng(20260816), shape=(384, 416), grain_px=6.0)
    return tm.sharpness_stats(field, metrics="all", tiles=True, verbose=False, device="cpu")


@pytest.mark.parametrize("group", list(_GOLDEN["sharpness_full"]))
def test_golden_snapshot_sharpness_full(golden_run, group):
    """The committed ``sharpness_full`` leaves (written by the JAX package)
    at rel 1e-9, abs 1e-12."""
    want = _GOLDEN["sharpness_full"][group]
    got = golden_run["full"][group]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-9, abs=1e-12), f"{group}.{k}"
