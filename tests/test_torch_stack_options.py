# SPDX-License-Identifier: CECILL-2.1
"""Port parity of ``speckle_stack_stats``'s options, each against the JAX
package on the same seeded float64 stacks (tolerances per test):

- the default call, lazy grain maps included (rtol 1e-9; float32 maps
  within 2e-6 of the peak);
- a tensor stack against the numpy stack: exactly equal, maps included;
- the windowed search against the full-frame search (1e-5 px) and against
  the JAX package's (1e-6 px: the trajectories are float32 leaves), clamped
  windows included, and both validation errors;
- phase tracking (1e-6 px, and the known shift within 0.5 px);
- checkpoints: store round trip, resume, partial resume (unsharded and under
  a two-entry mesh), the chunk file's keys, stale config, and
  a directory the JAX package wrote, which the port does not resume.
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (x64 and the CPU backend come from conftest)

import barc4dip_tpu.metrics as jm
import barc4dip_tpu_torch.metrics as tm
from barc4dip_tpu_torch.metrics import stack_fused
from barc4dip_tpu_torch.metrics.speckles_device import int_value_hint
from barc4dip_tpu_torch.parallel import frame_mesh
from barc4dip_tpu_torch.utils import LazyMapStack
from barc4dip_tpu_torch.utils.checkpoint import ChunkStore, config_hash
from tests.conftest import make_speckle

torch.set_num_threads(2)


def _shifted_frame(field, dy, dx):
    ny, nx = field.shape
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    return np.real(np.fft.ifft2(np.fft.fft2(field) * np.exp(-2j * np.pi * (fy * dy + fx * dx))))


def _spiral_stack(seed=77, side=160, T=5, grain=5.0, step=1.1):
    base = make_speckle(np.random.default_rng(seed), shape=(side, side), grain_px=grain)
    ts = np.arange(T)
    return np.stack(
        [_shifted_frame(base, dy, dx) for dy, dx in zip(step * ts * np.cos(ts), step * ts * np.sin(ts))]
    )


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _data(out):
    """Every numeric leaf of full/tiles/temporal as numpy (maps read whole)."""
    return {
        f"{sec}.{p}": np.asarray(v)
        for sec in ("full", "tiles", "temporal") if sec in out
        for p, v in _leaves(out[sec]) if "qc" not in p
    }


def _assert_equal(a, b):
    da, db = _data(a), _data(b)
    assert da.keys() == db.keys()
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_default_call_with_maps_matches_jax(dtype):
    stack = _spiral_stack(T=3).astype(dtype)
    got = tm.speckle_stack_stats(stack, verbose=False, device="cpu")
    want = jm.speckle_stack_stats(stack, verbose=False)
    ac = got["full"]["grain"]["autocorr"]
    assert isinstance(ac, LazyMapStack)
    assert ac.shape == (3, 160, 160) and ac.dtype == want["full"]["grain"]["autocorr"].dtype
    assert got["full"]["grain"]["xlag"].shape == (3, 160)
    dg, dw = _data(got), _data(want)
    assert dg.keys() == dw.keys()
    f64 = dtype == np.float64
    for k, w in dw.items():
        assert dg[k].dtype == w.dtype, k
        if k == "full.grain.autocorr":
            np.testing.assert_allclose(dg[k], w, rtol=1e-9 if f64 else 0, atol=1e-12 if f64 else 2e-6)
        elif f64:
            np.testing.assert_allclose(dg[k], w, rtol=1e-9, atol=1e-12, err_msg=k)


def test_maps_read_by_frame_compute_only_that_frame(monkeypatch):
    from barc4dip_tpu_torch.metrics import speckles

    calls = []
    real = speckles.grain_map_core
    monkeypatch.setattr(speckles, "grain_map_core", lambda x: calls.append(x.shape) or real(x))
    out = tm.speckle_stack_stats(_spiral_stack(T=4), tiles=False, verbose=False, device="cpu")
    assert not calls
    want = jm.speckle_stack_stats(_spiral_stack(T=4), tiles=False, verbose=False)
    np.testing.assert_allclose(out["full"]["grain"]["autocorr"][2],
                               want["full"]["grain"]["autocorr"][2], rtol=1e-9, atol=1e-12)
    assert calls == [(160, 160)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint16])
def test_tensor_stack_equals_numpy_stack(dtype):
    stack = _spiral_stack(T=5)
    if dtype == np.uint16:
        stack = np.round(stack * 1000).astype(np.uint16)
    stack = stack.astype(dtype)
    kw = dict(tiles=False, frame_chunk=2, verbose=False)
    host = tm.speckle_stack_stats(stack, device="cpu", **kw)
    tensor = tm.speckle_stack_stats(torch.from_numpy(stack), **kw)
    _assert_equal(host, tensor)
    assert int_value_hint(torch.from_numpy(stack).dtype) == int_value_hint(stack.dtype)


def test_int_value_hint_torch_dtypes():
    assert int_value_hint(torch.uint16) == (0, 65535)
    assert int_value_hint(torch.int8) == (-128, 127)
    assert int_value_hint(torch.float32) is None
    assert int_value_hint(torch.int32) is None
    assert int_value_hint(torch.bool) is None


def test_windowed_search_matches_full_frame_and_jax():
    stack = _spiral_stack()
    kw = dict(metrics="amplitude,stats", tiles=False, verbose=False)
    full = tm.speckle_stack_stats(stack, device="cpu", **kw)
    # radius 24 on a 160-px frame clamps the outer tiles' windows at the edge
    win = tm.speckle_stack_stats(stack, tracking_search_radius=24, device="cpu", **kw)
    ref = jm.speckle_stack_stats(stack, tracking_search_radius=24, **kw)
    for blk in ("abs", "inc"):
        for comp in ("dy", "dx", "r", "std_dy"):
            np.testing.assert_allclose(win["temporal"][blk][comp], full["temporal"][blk][comp],
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(win["temporal"][blk][comp], ref["temporal"][blk][comp],
                                       rtol=0, atol=1e-6)
    assert win["meta"]["tracking"]["search_area"] == "window_r24px" == ref["meta"]["tracking"]["search_area"]
    assert full["meta"]["tracking"]["search_area"] == "full_frame"
    # a window that does not fit runs the full search, and says so
    wide = tm.speckle_stack_stats(stack, tracking_search_radius=80, device="cpu", **kw)
    assert wide["meta"]["tracking"]["search_area"] == "full_frame"
    np.testing.assert_array_equal(wide["temporal"]["abs"]["dy"], full["temporal"]["abs"]["dy"])


@pytest.mark.parametrize(
    "kw,match",
    [(dict(tracking_method="phase", tracking_search_radius=16), "template"),
     (dict(tracking_search_radius=0.2), ">= 1")],
)
def test_windowed_search_validation(kw, match):
    stack = np.abs(np.random.default_rng(5).normal(1000, 100, size=(3, 160, 160))).astype(np.float32)
    kw = dict(metrics="stats", tiles=False, verbose=False, **kw)
    with pytest.raises(ValueError, match=match) as want:
        jm.speckle_stack_stats(stack, **kw)
    with pytest.raises(ValueError, match=match) as got:
        tm.speckle_stack_stats(stack, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_phase_tracking_matches_jax():
    base = make_speckle(np.random.default_rng(32), shape=(256, 256), grain_px=6.0)
    stack = np.stack([base, _shifted_frame(base, 3.0, -2.0), _shifted_frame(base, 1.0, 2.5)])
    kw = dict(metrics="stats", tiles=False, tracking_method="phase", roi_grain_factor=12.0,
              frame_chunk=2, verbose=False)
    got = tm.speckle_stack_stats(stack, device="cpu", **kw)
    want = jm.speckle_stack_stats(stack, **kw)
    for blk in ("abs", "inc"):
        for comp in ("dy", "dx", "r", "std_dx"):
            np.testing.assert_allclose(got["temporal"][blk][comp], want["temporal"][blk][comp],
                                       rtol=0, atol=1e-6)
    assert got["temporal"]["abs"]["dy"][1] == pytest.approx(3.0, abs=0.5)
    assert got["temporal"]["abs"]["dx"][1] == pytest.approx(-2.0, abs=0.5)
    assert got["meta"]["tracking"]["method"] == "phase"


# -- display origin -----------------------------------------------------------

@pytest.mark.parametrize("origin", ["LOWER", " lower", "upper", "lower", "bogus"])
def test_stack_display_origin_follows_jax_rule(origin, monkeypatch):
    """The stack path flips rows if and only if ``display_origin ==
    "lower"`` exactly: other spellings and invalid values run unflipped and
    raise nothing, and ``meta`` echoes the argument as given. Tile grids
    (3x3 tiles of a frame brighter at the top) and the lazy maps (frame 0
    read) against the JAX package at rtol 1e-9."""
    import barc4dip_tpu.metrics.speckles as j_speckles
    import barc4dip_tpu_torch.metrics.speckles as t_speckles

    monkeypatch.setattr(j_speckles, "MIN_TILE_PX", 40)
    monkeypatch.setattr(t_speckles, "MIN_TILE_PX", 40)
    ramp = np.linspace(2.0, 0.5, 160)[:, None] * np.linspace(1.0, 1.3, 160)[None, :]
    stack = _spiral_stack(T=2) * ramp
    kw = dict(metrics="grain,stats", display_origin=origin, verbose=False)
    got = tm.speckle_stack_stats(stack, device="cpu", **kw)
    want = jm.speckle_stack_stats(stack, **kw)
    assert got["meta"]["display_origin"] == origin == want["meta"]["display_origin"]
    assert "tiles" in got and "tiles" in want
    mean = got["tiles"]["stats"]["mean"]["mean"]
    top_first = mean[0, 0, 1] > mean[0, 2, 1]
    assert top_first == (origin != "lower")
    dg, dw = _data(got), _data(want)
    assert dg.keys() == dw.keys()
    for k, w in dw.items():
        if k == "full.grain.autocorr":
            dg[k], w = np.asarray(got["full"]["grain"]["autocorr"][0]), w[0]
        np.testing.assert_allclose(dg[k], w, rtol=1e-9, atol=1e-12, err_msg=k)


# -- checkpoints --------------------------------------------------------------

def test_chunkstore_roundtrip_and_hash(tmp_path):
    store = ChunkStore(tmp_path, "test", {"a": 1, "shape": (3, 4)})
    tree = {"full": {"x": np.arange(6.0).reshape(2, 3)}, "tiles": {"g/f": {"mean": np.ones((2, 3, 3))}}}
    assert not store.has(0)
    store.save(0, tree)
    loaded = store.load(0)
    np.testing.assert_array_equal(loaded["full"]["x"], tree["full"]["x"])
    np.testing.assert_array_equal(loaded["tiles"]["g/f"]["mean"], tree["tiles"]["g/f"]["mean"])
    assert config_hash({"g": [1], "c": 4}) == config_hash({"c": 4, "g": [1]})
    assert config_hash({"c": 4}) != config_hash({"c": 8})


def _ckpt_stack():
    base = make_speckle(np.random.default_rng(81), shape=(160, 160), grain_px=6.0)
    return np.stack([_shifted_frame(base, 0.3 * t, -0.2 * t) * (1 + 0.01 * t) for t in range(6)])


_CKPT_KW = dict(metrics="amplitude,grain,stats", tiles=False, verbose=False, frame_chunk=2)


def _count_tracking(monkeypatch):
    calls = []
    real = stack_fused._track_chunk
    monkeypatch.setattr(stack_fused, "_track_chunk", lambda *a: calls.append(1) or real(*a))
    return calls


def test_resume_matches_fresh_and_computes_nothing(tmp_path, monkeypatch):
    stack = _ckpt_stack()
    fresh = tm.speckle_stack_stats(stack, device="cpu", **_CKPT_KW)
    first = tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    assert len(list(tmp_path.glob("torch_speckle_fused_*.npz"))) == 3
    calls = _count_tracking(monkeypatch)
    resumed = tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    assert not calls, "a fully resumed run tracks no chunk"
    _assert_equal(first, fresh)
    _assert_equal(resumed, fresh)


@pytest.mark.parametrize("mesh, tracked", [(None, 2), (("cpu", "cpu"), 4)])
def test_partial_resume_after_lost_chunks(tmp_path, monkeypatch, mesh, tracked):
    """Lost chunks are recomputed, the incremental reference after a loaded
    chunk re-derived from the stack: the result equals a fresh run. Under a
    two-entry mesh each run chunk tracks two one-frame shards."""
    stack = _ckpt_stack()
    kw = dict(_CKPT_KW, device="cpu", mesh=None if mesh is None else frame_mesh(list(mesh)))
    fresh = tm.speckle_stack_stats(stack, **kw)
    tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, **kw)
    files = sorted(tmp_path.glob("*.npz"))
    files[0].unlink()
    files[-1].unlink()
    calls = _count_tracking(monkeypatch)
    resumed = tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, **kw)
    assert len(calls) == tracked
    _assert_equal(resumed, fresh)
    assert len(sorted(tmp_path.glob("*.npz"))) == len(files)


def test_speckle_chunk_file_keeps_its_format(tmp_path):
    """A chunk file holds the metric leaves under ``metrics`` and the four
    trajectories by name, (n, 9) in the frames' dtype: chunks written by
    earlier versions of the port resume."""
    stack = _ckpt_stack()
    tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    files = sorted(tmp_path.glob("torch_speckle_fused_*.npz"))
    assert len(files) == 3
    with np.load(files[0]) as data:
        assert str(data["__chunkstore_kind__"]) == "dict"
        keys = set(data.files) - {"__chunkstore_kind__"}
        tracks = {f"track||{k}" for k in ("dy_a", "dx_a", "dy_i", "dx_i")}
        assert tracks <= keys
        assert keys - tracks and all(k.startswith("metrics||") for k in keys - tracks)
        for k in tracks:
            assert data[k].shape == (2, 9) and data[k].dtype == np.float64, k


def test_resume_ignores_stale_config(tmp_path):
    stack = _ckpt_stack()
    tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    n_before = len(list(tmp_path.glob("*.npz")))
    tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu",
                           **{**_CKPT_KW, "metrics": "stats"})
    assert len(list(tmp_path.glob("*.npz"))) == 2 * n_before


def test_jax_checkpoint_directory_is_not_resumed(tmp_path, monkeypatch):
    stack = _ckpt_stack()
    jm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, **_CKPT_KW)
    jax_files = sorted(tmp_path.glob("*.npz"))
    assert jax_files
    loads = []
    real = ChunkStore.load
    monkeypatch.setattr(ChunkStore, "load", lambda self, c0: loads.append(c0) or real(self, c0))
    got = tm.speckle_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    assert not loads
    assert len(list(tmp_path.glob("torch_speckle_fused_*.npz"))) == 3
    _assert_equal(got, tm.speckle_stack_stats(stack, device="cpu", **_CKPT_KW))
