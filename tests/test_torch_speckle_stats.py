# SPDX-License-Identifier: CECILL-2.1
"""Port parity of the single-image speckle API: ``speckle_stats`` (every
group, 3x3 tiles and none, both display origins, the lazy autocorrelation
map) and ``amplitude``, ``grain`` (with its map), ``bandwidth`` and
``distribution_moments`` against the JAX package on float64 fields at rtol
1e-9; a tensor input equal to the numpy input exactly; the same
``ValueError``s; and the ``speckle_full`` / ``speckle_tiles_mean`` leaves
of ``tests/golden_snapshot.json`` on its own field at rtol 1e-9."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (x64 and the CPU backend come from conftest)

import barc4dip_tpu.metrics as jm
import barc4dip_tpu_torch.metrics as tm
from barc4dip_tpu_torch.utils import LazyMap
from tests.conftest import make_speckle

torch.set_num_threads(2)
RTOL, ATOL = 1e-9, 1e-12


def _field(seed=7, shape=(384, 400), grain=5.0):
    return make_speckle(np.random.default_rng(seed), shape=shape, grain_px=grain)


def _assert_close(got, want, path=""):
    """Leaf-by-leaf comparison of two result trees; numeric leaves at
    RTOL/ATOL with equal NaN positions, the rest equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
        return
    w = np.asarray(want)
    if w.dtype.kind not in "fc":
        assert np.array_equal(np.asarray(got), w), path
        return
    g = np.asarray(got, dtype=np.float64)
    assert g.shape == w.shape, path
    np.testing.assert_allclose(g, w.astype(np.float64), rtol=RTOL, atol=ATOL, equal_nan=True,
                               err_msg=path)


@pytest.mark.parametrize("origin", ["lower", "upper"])
@pytest.mark.parametrize("metrics,tiles", [("all", True), ("grain,stats", False)])
def test_speckle_stats_matches_jax(origin, metrics, tiles):
    field = _field()
    kw = dict(metrics=metrics, tiles=tiles, display_origin=origin, verbose=False)
    got = tm.speckle_stats(field, device="cpu", **kw)
    want = jm.speckle_stats(field, **kw)
    assert isinstance(got["full"]["grain"]["autocorr"], LazyMap)
    assert got["full"]["grain"]["autocorr"].dtype == np.float64
    # the map leaf is lazy in both packages; reading it compares the maps
    _assert_close(got["full"], want["full"], "full")
    assert got["meta"].keys() == want["meta"].keys()
    for k in ("kind", "display_origin", "input_shape", "requested_groups", "units"):
        assert got["meta"][k] == want["meta"][k], k
    if tiles:
        for k in ("tile_mode", "tile_grid_shape", "tile_order", "tile_shape_px", "used_subtiles"):
            assert got["meta"][k] == want["meta"][k], k
        assert got["meta"]["tile_labels"].tolist() == want["meta"]["tile_labels"].tolist()
        _assert_close(got["tiles"], want["tiles"], "tiles")
    else:
        assert "tiles" not in got


def test_lazy_map_defers_until_read(monkeypatch):
    from barc4dip_tpu_torch.metrics import speckles

    calls = []
    real = speckles.grain_map_core
    monkeypatch.setattr(speckles, "grain_map_core", lambda x: calls.append(1) or real(x))
    out = tm.speckle_stats(_field(), metrics="grain", tiles=False, verbose=False, device="cpu")
    assert not calls
    np.asarray(out["full"]["grain"]["autocorr"])
    out["full"]["grain"]["autocorr"][0, 0]
    assert len(calls) == 1


def test_standalone_estimators_match_jax():
    field = _field(seed=11)
    _assert_close(tm.amplitude(field, device="cpu"), jm.amplitude(field), "amplitude")
    _assert_close(tm.bandwidth(field, device="cpu"), jm.bandwidth(field), "bandwidth")
    for method in ("interpolated", "binned"):
        _assert_close(
            tm.grain(field, radial_method=method, device="cpu"),
            jm.grain(field, radial_method=method),
            f"grain[{method}]",
        )
    field[3, 4] = np.nan
    for sat in (65535.0, None, 2.0):
        _assert_close(
            tm.distribution_moments(field, saturation_value=sat, device="cpu"),
            jm.distribution_moments(field, saturation_value=sat),
            f"moments[{sat}]",
        )
    line = field[7]
    _assert_close(tm.distribution_moments(line, device="cpu"), jm.distribution_moments(line), "1d")


def test_tensor_input_equals_numpy_input():
    field = _field(seed=3)
    for arr in (field, field.astype(np.float32), (field * 1000).astype(np.uint16)):
        kw = dict(tiles=True, verbose=False)
        a = tm.speckle_stats(arr, device="cpu", **kw)
        b = tm.speckle_stats(torch.from_numpy(arr), **kw)
        for sec in ("full", "tiles"):
            for g, fields in a[sec].items():
                for f, v in fields.items():
                    if isinstance(v, dict):
                        for k in v:
                            np.testing.assert_array_equal(b[sec][g][f][k], v[k])
                    else:
                        np.testing.assert_array_equal(np.asarray(b[sec][g][f]), np.asarray(v))
    t = torch.from_numpy(field)
    np.testing.assert_array_equal(tm.grain(t)["autocorr"], tm.grain(field, device="cpu")["autocorr"])
    assert tm.amplitude(t) == tm.amplitude(field, device="cpu")
    assert tm.bandwidth(t) == tm.bandwidth(field, device="cpu")
    assert tm.distribution_moments(t) == tm.distribution_moments(field, device="cpu")


_ERRORS = [
    ("speckle_stats", (np.ones((4, 4, 4)),), {}),
    ("speckle_stats", (np.ones((64, 200)),), {"metrics": "grain"}),
    ("speckle_stats", (np.full((64, 64), -1.0),), {"metrics": "amplitude", "tiles": False}),
    ("speckle_stats", (np.full((64, 64), np.nan),), {"metrics": "stats", "tiles": False}),
    ("speckle_stats", (np.ones((64, 64)),), {"metrics": "sharpness"}),
    ("speckle_stats", (np.ones((64, 64)),), {"display_origin": "left"}),
    ("amplitude", (np.zeros((64, 64)),), {}),
    ("amplitude", (np.ones(8),), {}),
    ("grain", (np.ones((100, 200)),), {}),
    ("grain", (np.ones((200, 200)),), {"radial_method": "spline"}),
    ("bandwidth", (np.ones((64, 64)),), {}),
    ("distribution_moments", (np.ones((2, 2, 2)),), {}),
    ("distribution_moments", (np.zeros((0, 3)),), {}),
    ("distribution_moments", (np.full(5, np.inf),), {}),
]


@pytest.mark.parametrize("name,args,kw", _ERRORS, ids=[f"{e[0]}-{i}" for i, e in enumerate(_ERRORS)])
def test_same_value_errors(name, args, kw):
    kw = {**kw, **({"verbose": False} if name == "speckle_stats" else {})}
    with pytest.raises(ValueError) as want:
        getattr(jm, name)(*args, **kw)
    with pytest.raises(ValueError) as got:
        getattr(tm, name)(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_tensor_input_validates_after_the_run():
    """A tensor is validated on the results, with the numpy path's errors."""
    with pytest.raises(ValueError, match="Mean intensity"):
        tm.speckle_stats(torch.full((64, 64), -1.0, dtype=torch.float64), metrics="amplitude",
                         tiles=False, verbose=False)
    with pytest.raises(ValueError, match="no finite values"):
        tm.speckle_stats(torch.full((64, 64), float("nan"), dtype=torch.float64), metrics="stats",
                         tiles=False, verbose=False)
    with pytest.raises(TypeError):
        tm.speckle_stats([[1.0, 2.0]], verbose=False)


def test_golden_snapshot_speckle_leaves():
    want = json.loads((Path(__file__).parent / "golden_snapshot.json").read_text())
    field = make_speckle(np.random.default_rng(20260816), shape=(384, 416), grain_px=6.0)
    out = tm.speckle_stats(field, metrics="all", tiles=True, verbose=False, device="cpu")
    n = 0
    for g, d in want["speckle_full"].items():
        for k, v in d.items():
            assert out["full"][g][k] == pytest.approx(v, rel=1e-9, abs=1e-12, nan_ok=True), f"{g}.{k}"
            n += 1
    for g, d in want["speckle_tiles_mean"].items():
        for k, v in d.items():
            np.testing.assert_allclose(out["tiles"][g][k]["mean"], np.asarray(v), rtol=1e-9,
                                       atol=1e-12, err_msg=f"{g}.{k}")
            n += 1
    assert n == 40
