# SPDX-License-Identifier: CECILL-2.1
"""Port parity of ``sharpness_stack_stats``, ``SharpnessScanPipeline`` and
the chunk loop and host helpers of ``metrics/common.py``, against the JAX
package on the same seeded stacks (CPU).

Tolerances: float64 stacks at rtol 1e-9 with equal finiteness; float32 and
uint16 stacks, which both packages compute in float32, at rtol 2e-4 (the
eigenvalue ratio and the spectral sums carry ~1e-5 of float32 round-off);
a tensor stack and a resumed checkpoint exactly equal to their references.
``MIN_TILE_PX`` is lowered to 32 in both packages so that small frames
reach the tiled modes.
"""
import weakref

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

import barc4dip_tpu.metrics as jm
import barc4dip_tpu.metrics.common as j_common
import barc4dip_tpu.metrics.sharpness as j_sharp
import barc4dip_tpu.models.pipeline as j_pipe
import barc4dip_tpu_torch.metrics as tm
import barc4dip_tpu_torch.metrics.common as t_common
import barc4dip_tpu_torch.metrics.sharpness as t_sharp
import barc4dip_tpu_torch.models as t_models
from barc4dip_tpu_torch.utils.checkpoint import ChunkStore
from tests.conftest import make_speckle
from tests.test_torch_sharpness import _leaves, assert_stats_close

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _small_tiles(monkeypatch):
    monkeypatch.setattr(j_sharp, "MIN_TILE_PX", 32)
    monkeypatch.setattr(t_sharp, "MIN_TILE_PX", 32)


def _scan(T=5, shape=(120, 132), seed=11):
    """A through-focus series: one speckle frame, brighter at the top,
    blurred by a Gaussian whose width goes through zero at frame 2."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(2.0, 0.5, shape[0])[:, None] * np.linspace(1.0, 1.2, shape[1])[None, :]
    base = make_speckle(rng, shape=shape, grain_px=5.0) * ramp
    return np.stack([ndi.gaussian_filter(base, 0.6 * abs(t - 2)) for t in range(T)])


def _as_dtype(stack, dtype):
    if dtype == np.uint16:
        return np.round(stack * 20).astype(np.uint16)
    return stack.astype(dtype)


def _assert_same_dtypes(got, want, compute_dtype=None):
    """Leaves have the reference's dtype. With ``compute_dtype`` (a JAX
    reference run under x64) the spectral-entropy leaves are held to the
    compute dtype instead: the JAX core divides by a numpy float64 scalar,
    which promotes that one leaf to float64 only while x64 is on."""
    for sec in ("full", "tiles"):
        if sec in want:
            dg, dw = dict(_leaves(got[sec])), dict(_leaves(want[sec]))
            for k, w in dw.items():
                expect = np.asarray(w).dtype
                if compute_dtype is not None and "spectral_entropy" in k and "std" not in k:
                    expect = np.dtype(compute_dtype)
                assert np.asarray(dg[k]).dtype == expect, f"{sec}.{k}"


_GRID = [
    dict(dtype=np.float64),
    dict(dtype=np.float32),
    dict(dtype=np.uint16),
    dict(dtype=np.float64, display_origin="upper"),
    dict(dtype=np.float64, display_origin="LOWER"),
    dict(dtype=np.float64, display_origin=" lower"),
    dict(dtype=np.float64, display_origin="bogus"),
    dict(dtype=np.uint16, display_origin="upper", tiles=False),
    dict(dtype=np.float64, tiles=False, frame_chunk=3),
    dict(dtype=np.float64, metrics="gradient,laplacian", frame_chunk=8),
    dict(dtype=np.float32, metrics=["autocorrelation", "stats"], frame_chunk=1),
    dict(dtype=np.float64, metrics="eigenvalues,spectral", frame_chunk=4),
    dict(dtype=np.float64, saturation_value=None, eps=1e-3, metrics="stats"),
    dict(dtype=np.uint16, saturation_value=30.0, metrics="stats", tiles=False),
]


@pytest.mark.parametrize("case", _GRID, ids=[
    "-".join(f"{k}={getattr(v, '__name__', v)}" for k, v in c.items()) for c in _GRID])
def test_stack_options_grid_matches_jax(case):
    """dtype, origin spellings (the stack path flips only on the exact
    string "lower" and echoes the argument), tiles, group subsets and
    chunks that do and do not divide T = 5 (the default here is 2)."""
    case = dict(case)
    dtype = case.pop("dtype")
    stack = _as_dtype(_scan(), dtype)
    kw = {"frame_chunk": 2, "verbose": False, **case}
    got = tm.sharpness_stack_stats(stack, device="cpu", **kw)
    want = jm.sharpness_stack_stats(stack, **kw)
    assert set(got) == set(want)
    for k, w in want["meta"].items():
        if k == "tile_labels":
            np.testing.assert_array_equal(got["meta"][k], w)
        else:
            assert got["meta"][k] == w, k
    assert got["meta"].keys() == want["meta"].keys()
    _assert_same_dtypes(got, want, np.float64 if dtype == np.float64 else np.float32)
    assert_stats_close(got, want, rtol=1e-9 if dtype == np.float64 else 2e-4)
    if "tiles" in got and "stats" in got["tiles"]:
        mean = got["tiles"]["stats"]["mean"]["mean"]
        flipped = mean[0, 0, 1] < mean[0, 2, 1]
        assert flipped == (case.get("display_origin", "lower") == "lower")
        assert np.isnan(got["tiles"]["stats"]["mean"]["std"]).all()  # direct 3x3 tiles


def test_stack_subtiles_9x9_matches_jax():
    stack = _scan(T=2, shape=(300, 330))
    kw = dict(metrics="gradient,autocorrelation,eigenvalues", verbose=False)
    got = tm.sharpness_stack_stats(stack, device="cpu", **kw)
    want = jm.sharpness_stack_stats(stack, **kw)
    assert got["meta"]["tile_mode"] == "subtiles_9x9" == want["meta"]["tile_mode"]
    assert got["meta"]["used_subtiles"] is True
    assert_stats_close(got, want)
    assert np.isfinite(got["tiles"]["gradient"]["tenengrad"]["std"]).all()


def test_stack_frame_equals_single_image_call():
    """Frame t of the stack call reads what ``sharpness_stats`` reads for
    that frame (the same batched cores on a batch of one): rtol 1e-12."""
    stack = _scan(T=3)
    out = tm.sharpness_stack_stats(stack, frame_chunk=2, verbose=False, device="cpu")
    one = tm.sharpness_stats(stack[2], verbose=False, device="cpu")
    for sec in ("full", "tiles"):
        ds, d1 = dict(_leaves(out[sec])), dict(_leaves(one[sec]))
        assert ds.keys() == d1.keys()
        for k, v in d1.items():
            np.testing.assert_allclose(ds[k][2], v, rtol=1e-12, atol=0, err_msg=k, equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint16])
def test_tensor_stack_equals_numpy_stack(dtype):
    stack = _as_dtype(_scan(), dtype)
    kw = dict(frame_chunk=2, verbose=False)
    host = tm.sharpness_stack_stats(stack, device="cpu", **kw)
    tensor = tm.sharpness_stack_stats(torch.from_numpy(stack), **kw)
    _assert_same_dtypes(tensor, host)
    assert_stats_close(tensor, host, rtol=0)
    assert tensor["meta"]["stack_shape"] == host["meta"]["stack_shape"] == (5, 120, 132)


@pytest.mark.parametrize(
    "kw,enabled,n_jobs",
    [(dict(), True, None), (dict(parallel=False, n_jobs=4), False, None),
     (dict(n_jobs=1), False, None), (dict(n_jobs=4), True, 4)],
)
def test_parallel_arguments_are_echoed(kw, enabled, n_jobs):
    stack = _scan(T=2)
    call = dict(metrics="laplacian", tiles=False, verbose=False, **kw)
    got = tm.sharpness_stack_stats(stack, device="cpu", **call)["meta"]["parallel"]
    assert got == {"enabled": enabled, "n_jobs": n_jobs, "device_batched": True}
    assert got == jm.sharpness_stack_stats(stack, **call)["meta"]["parallel"]


@pytest.mark.parametrize("k", range(6))
def test_stack_validation_raises_as_jax(k):
    exc, stack, kw = [
        (TypeError, [[[1.0]]], {}),
        (ValueError, np.ones((64, 64)), {}),
        (ValueError, np.ones((0, 64, 64)), {}),
        (ValueError, np.ones((2, 64, 64)), {"metrics": "focus"}),
        (TypeError, np.ones((2, 64, 64)), {"metrics": [1]}),
        (ValueError, np.ones((2, 20, 64)), {}),
    ][k]
    kw = dict(tiles=False, verbose=False, **kw)
    with pytest.raises(exc) as want:
        jm.sharpness_stack_stats(stack, **kw)
    with pytest.raises(exc) as got:
        tm.sharpness_stack_stats(stack, device="cpu", **kw)
    if exc is ValueError:
        assert str(got.value) == str(want.value)


def _leaves_of(tree):
    return dict(_leaves(tree))


def test_mesh_is_not_ported(tmp_path):
    # a two-entry CPU mesh gives the unsharded results
    from barc4dip_tpu_torch.parallel import frame_mesh

    mesh = frame_mesh(["cpu", "cpu"])
    kw = dict(tiles=False, verbose=False, device="cpu", frame_chunk=3)
    single = tm.sharpness_stack_stats(_scan(T=5), **kw)
    sharded = tm.sharpness_stack_stats(_scan(T=5), mesh=mesh, **kw)
    for path, v in _leaves(single["full"]):
        np.testing.assert_allclose(_leaves_of(sharded["full"])[path], v, rtol=1e-12, atol=1e-12,
                                   err_msg=path)
    frames = torch.from_numpy(_scan(T=5))
    out = t_common.run_stack_program(frames, lambda x: {"s": x.sum((-2, -1))}, mesh=mesh,
                                     frame_chunk=3, device="cpu")
    np.testing.assert_allclose(out["s"], frames.sum((-2, -1)).numpy(), rtol=1e-12)
    # the file-driven focus scan runs: frames from disk equal frames from memory
    from barc4dip_tpu_torch.io import save_edf

    stack = _scan(T=3).astype(np.float32)
    paths = []
    for t, frame in enumerate(stack):
        paths.append(str(tmp_path / f"scan_{t}.edf"))
        save_edf(frame, paths[-1])
    pipe = t_models.SharpnessScanPipeline(frame_chunk=2, device="cpu")
    from_files, in_memory = pipe.run_files(paths), pipe(stack)
    assert from_files["meta"]["focus"] == in_memory["meta"]["focus"]
    assert_stats_close(from_files, in_memory, rtol=0)


def test_verbose_prints_progress_and_logs(caplog, capsys):
    with caplog.at_level("INFO", logger=t_sharp.logger.name):
        tm.sharpness_stack_stats(_scan(T=2), metrics="laplacian", tiles=False, device="cpu")
    out = capsys.readouterr().out
    assert "Sharpness stats loop: [----------]   0%" in out
    assert "Sharpness stats loop: [##########] 100%" in out
    assert "> sharpness_stack_stats | frames=2 | parallel=yes" in caplog.text


# -- checkpoints --------------------------------------------------------------

_CKPT_KW = dict(metrics="gradient,autocorrelation", frame_chunk=2, verbose=False)


def _count_programs(monkeypatch):
    calls = []
    real = t_sharp.tenengrad_core
    monkeypatch.setattr(t_sharp, "tenengrad_core", lambda x: calls.append(x.shape[0]) or real(x))
    return calls


def test_resume_matches_fresh_and_computes_nothing(tmp_path, monkeypatch):
    stack = _scan()
    fresh = tm.sharpness_stack_stats(stack, device="cpu", **_CKPT_KW)
    first = tm.sharpness_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    assert len(list(tmp_path.glob("torch_sharpness_metrics_*.npz"))) == 3
    calls = _count_programs(monkeypatch)
    resumed = tm.sharpness_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    assert not calls, "a fully resumed run computes no chunk"
    assert_stats_close(first, fresh, rtol=0)
    assert_stats_close(resumed, fresh, rtol=0)
    _assert_same_dtypes(resumed, fresh)
    # the configuration holds the JAX keys only (no dtype, no container): the
    # same data as a tensor resumes the numpy stack's chunks
    as_tensor = tm.sharpness_stack_stats(torch.from_numpy(stack), checkpoint_dir=tmp_path, **_CKPT_KW)
    assert not calls and len(list(tmp_path.glob("*.npz"))) == 3
    assert_stats_close(as_tensor, fresh, rtol=0)


def test_partial_resume_and_stale_config(tmp_path, monkeypatch):
    stack = _scan()
    fresh = tm.sharpness_stack_stats(stack, device="cpu", **_CKPT_KW)
    tm.sharpness_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    files = sorted(tmp_path.glob("*.npz"))
    files[1].unlink()
    calls = _count_programs(monkeypatch)
    resumed = tm.sharpness_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    # the full frame and the 3x3 tiles of the one lost chunk of 2 frames
    assert calls == [2, 2]
    assert_stats_close(resumed, fresh, rtol=0)
    # another origin, chunk or group set is another configuration
    for change in (dict(display_origin="upper"), dict(frame_chunk=3), dict(metrics="gradient")):
        before = len(list(tmp_path.glob("*.npz")))
        tm.sharpness_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu",
                                 **{**_CKPT_KW, **change})
        assert len(list(tmp_path.glob("*.npz"))) > before, change


def test_jax_checkpoint_directory_is_not_resumed(tmp_path, monkeypatch):
    stack = _scan()
    jm.sharpness_stack_stats(stack, checkpoint_dir=tmp_path, **_CKPT_KW)
    assert sorted(tmp_path.glob("sharpness_metrics_*.npz"))
    loads = []
    real = ChunkStore.load
    monkeypatch.setattr(ChunkStore, "load", lambda self, c0: loads.append(c0) or real(self, c0))
    got = tm.sharpness_stack_stats(stack, checkpoint_dir=tmp_path, device="cpu", **_CKPT_KW)
    assert not loads
    assert len(list(tmp_path.glob("torch_sharpness_metrics_*.npz"))) == 3
    assert_stats_close(got, tm.sharpness_stack_stats(stack, device="cpu", **_CKPT_KW), rtol=0)


# -- SharpnessScanPipeline ----------------------------------------------------

def test_scan_pipeline_picks_the_focus_frame_as_jax():
    stack = _scan()
    got = t_models.SharpnessScanPipeline(device="cpu")(stack)
    want = j_pipe.SharpnessScanPipeline()(stack)
    assert got["meta"]["focus"]["best_frame"] == 2 == want["meta"]["focus"]["best_frame"]
    assert got["meta"]["focus"]["metric"] == "gradient.tenengrad"
    for k in ("series_min", "series_max"):
        assert got["meta"]["focus"][k] == pytest.approx(want["meta"]["focus"][k], rel=1e-9)
    assert sorted(got["full"]) == ["gradient", "laplacian"] and "tiles" not in got
    assert_stats_close(got, want)
    # a tensor stack and another focus operator
    pipe = t_models.SharpnessScanPipeline(
        metrics="laplacian,spectral", focus_metric=("laplacian", "laplacian_variance"),
        frame_chunk=2, device="cpu",
    )
    assert pipe(torch.from_numpy(stack))["meta"]["focus"]["best_frame"] == 2
    assert pipe(stack.tolist())["meta"]["focus"]["best_frame"] == 2


def test_scan_pipeline_rejects_a_focus_group_outside_the_metrics(monkeypatch):
    ran = []
    monkeypatch.setattr(
        "barc4dip_tpu_torch.models.pipeline.sharpness_stack_stats", lambda *a, **k: ran.append(1)
    )
    kw = dict(metrics="laplacian", focus_metric=("gradient", "tenengrad"))
    with pytest.raises(ValueError) as want:
        j_pipe.SharpnessScanPipeline(**kw)(_scan(T=2))
    with pytest.raises(ValueError) as got:
        t_models.SharpnessScanPipeline(**kw)(_scan(T=2))
    assert str(got.value) == str(want.value)
    assert not ran, "the focus operator is checked before the scan runs"


def test_scan_pipeline_all_nan_series():
    stack = np.full((3, 64, 64), np.nan)
    got = t_models.SharpnessScanPipeline(metrics="spectral", focus_metric=("spectral", "spectral_entropy"),
                                         device="cpu")(stack)
    want = j_pipe.SharpnessScanPipeline(metrics="spectral", focus_metric=("spectral", "spectral_entropy"))(stack)
    assert got["meta"]["focus"]["best_frame"] is None is want["meta"]["focus"]["best_frame"]
    assert np.isnan(got["meta"]["focus"]["series_min"]) and np.isnan(got["meta"]["focus"]["series_max"])


# -- the chunk loop and the host helpers of metrics/common.py -----------------

@pytest.mark.parametrize("frame_chunk", [1, 2, 3, 5, 9])
def test_run_stack_program_chunks_and_flip(frame_chunk):
    stack = np.arange(5 * 4 * 3, dtype=np.float64).reshape(5, 4, 3)
    seen = []

    def program(frames):
        seen.append(frames.shape[0])
        return {"a": {"top": frames[:, 0, 0], "row": frames[:, -1, :]}, "n": frames.sum((-2, -1))}

    out = t_common.run_stack_program(stack, program, frame_chunk=frame_chunk, flip=True, device="cpu")
    B = min(frame_chunk, 5)
    assert seen == [B] * (5 // B) + ([5 % B] if 5 % B else [])
    np.testing.assert_array_equal(out["a"]["top"], stack[:, -1, 0])
    np.testing.assert_array_equal(out["a"]["row"], stack[:, 0, :])
    np.testing.assert_array_equal(out["n"], stack.sum((1, 2)))
    ints = t_common.run_stack_program(
        torch.from_numpy(stack.astype(np.uint16)), program, frame_chunk=frame_chunk)
    assert ints["n"].dtype == np.float32
    np.testing.assert_array_equal(ints["a"]["top"], stack[:, 0, 0])


def test_run_stack_program_frees_the_frames_it_flipped(monkeypatch):
    """With ``flip`` the program runs on a flipped copy, and the frames
    loaded before it are freed by then: the chunk loop keeps no reference
    to them, so a chunk is alive once, not twice, while the program runs."""
    stack = np.arange(4 * 4 * 3, dtype=np.float64).reshape(4, 4, 3)
    loaded, alive = [], []
    real_flip = torch.flip

    def flip(x, dims):
        loaded.append(weakref.ref(x))
        return real_flip(x, dims)

    def program(frames):
        alive.append(loaded[-1]() is not None)
        return {"n": frames.sum((-2, -1))}

    monkeypatch.setattr(torch, "flip", flip)
    out = t_common.run_stack_program(stack, program, frame_chunk=2, flip=True, device="cpu")
    np.testing.assert_array_equal(out["n"], stack.sum((1, 2)))
    assert alive == [False, False]


def test_aggregate_subtiles_9x9_to_3x3(rng):
    sub = rng.normal(size=(9, 9))
    sub[4, 4] = np.nan
    got = t_common.aggregate_subtiles_9x9_to_3x3(sub)
    want = j_common.aggregate_subtiles_9x9_to_3x3(sub)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][0, 0] == pytest.approx(sub[:3, :3].mean())
    with pytest.raises(ValueError, match=r"\(9, 9\)"):
        t_common.aggregate_subtiles_9x9_to_3x3(np.ones((3, 3)))


@pytest.mark.parametrize("tile_mode", ["tiles_3x3", "subtiles_9x9"])
def test_tiled_scalar_fields_keeps_the_reference_signature(rng, tile_mode):
    """``compute_fn`` takes one tile and returns scalars, as in the JAX
    package, for a numpy image and for a tensor."""
    img = rng.normal(size=(95, 101))
    want = j_common.tiled_scalar_fields(
        jnp.asarray(img), tile_mode=tile_mode,
        compute_fn=lambda tile: {"mean": jnp.mean(tile), "peak": jnp.max(tile)},
    )

    def fn(tile):
        assert tile.ndim == 2
        return {"mean": tile.mean(), "peak": float(tile.max())}

    for image in (img, torch.from_numpy(img)):
        got = t_common.tiled_scalar_fields(image, tile_mode=tile_mode, compute_fn=fn)
        assert got.keys() == want.keys()
        for k in want:
            for part in ("mean", "std"):
                assert got[k][part].shape == (3, 3) and got[k][part].dtype == np.float64
                np.testing.assert_allclose(got[k][part], want[k][part], rtol=1e-12, equal_nan=True)
    with pytest.raises(ValueError, match="tile_mode"):
        t_common.tiled_scalar_fields(img, tile_mode="off", compute_fn=fn)
    with pytest.raises(ValueError, match="2D"):
        t_common.tiled_scalar_fields(img[None], tile_mode=tile_mode, compute_fn=fn)


def test_stack_time_series(rng):
    frames = [
        {"full": {"a": float(t), "n": t, "m": rng.normal(size=(2, 3))}, "label": f"f{t}",
         "ok": bool(t % 2)}
        for t in range(4)
    ]
    got = t_common.stack_time_series(frames)
    want = j_common.stack_time_series(frames)
    assert got["label"] == want["label"] == ["f0", "f1", "f2", "f3"]
    for k in ("a", "n", "m"):
        np.testing.assert_array_equal(got["full"][k], want["full"][k])
        assert got["full"][k].dtype == want["full"][k].dtype
    np.testing.assert_array_equal(got["ok"], want["ok"])
    tensors = t_common.stack_time_series([torch.full((2,), float(t)) for t in range(3)])
    np.testing.assert_array_equal(tensors, [[0, 0], [1, 1], [2, 2]])
    with pytest.raises(ValueError, match="No values"):
        t_common.stack_time_series([])
