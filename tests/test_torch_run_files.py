# SPDX-License-Identifier: CECILL-2.1
"""The pipelines' file-driven entry points on the CPU, through both packages
on the same files.

- ``SpeckleStackPipeline.run_files`` (EDF, and TIFF + EDF mixed),
  ``run_edf_files`` and ``run_hdf5``; ``SharpnessScanPipeline.run_files``;
  ``WavefrontScanPipeline.run_files``.
- Against the port's own in-memory run: **exactly** equal. Frames from
  files arrive as float32 whatever the files hold, so the in-memory twin of
  a file run is the run on ``stack.astype(np.float32)``; ``run_hdf5`` hands
  the dataset's own dtype on, so its twin is the run on the stack as stored.
- Against the JAX package on the same files: the tolerances of
  ``test_torch_pipeline.py`` (float32 compute: the bench gate's rtol 1e-4;
  a float64 HDF5 dataset: rtol 1e-8) and of ``test_torch_xst.py`` (dy/dx
  atol 5e-4 px, peak 1e-4).
- The out-of-core view is only ever sliced ``stack[c0:c1]`` / ``stack[t]``;
  a pass reads each file once plus the documented extras (a lazy map read, a
  resume's predecessor frame); ``run_hdf5`` keeps its file open for the lazy
  maps and lets go of it with the last leaf."""
import gc
import warnings

import numpy as np
import pytest
import torch

import barc4dip_tpu.io as jio
import barc4dip_tpu.models as jmodels
import barc4dip_tpu.models.pipeline as jpipe
import barc4dip_tpu_torch as tdip
import barc4dip_tpu_torch.io as tio
import barc4dip_tpu_torch.models as tmodels
import barc4dip_tpu_torch.models.pipeline as tpipe
import barc4dip_tpu_torch.signal as tsignal
from barc4dip_tpu_torch.utils import speckle_stack
from tests.test_torch_pipeline import _compare, _leaves
from tests.test_torch_xst import _compare_fields

torch.set_num_threads(2)
T, SIDE = 5, 192
CPU = dict(device="cpu")
KW = dict(frame_chunk=2)


@pytest.fixture(scope="module")
def stack():
    return speckle_stack(T, (SIDE, SIDE), seed=np.random.default_rng(77), dtype=np.uint16,
                         mean_counts=6000.0)


@pytest.fixture(scope="module")
def edf_paths(stack, tmp_path_factory):
    d = tmp_path_factory.mktemp("edf")
    paths = []
    for t, frame in enumerate(stack):
        paths.append(str(d / f"scan_{t:04d}.edf"))
        tio.save_edf(frame, paths[-1])
    return paths


@pytest.fixture(scope="module")
def in_memory(stack):
    """The port's run on the float32 stack: the twin of every file run."""
    return tmodels.SpeckleStackPipeline(**KW, **CPU)(stack.astype(np.float32))


def assert_same_results(got, want):
    """Every full / tiles / temporal leaf exactly equal (lazy maps by frame)."""
    for sec in ("full", "tiles", "temporal"):
        assert (sec in got) == (sec in want)
        if sec not in want:
            continue
        lg, lw = dict(_leaves(got[sec])), dict(_leaves(want[sec]))
        assert lg.keys() == lw.keys()
        for path, w in lw.items():
            if path.endswith("autocorr"):
                for t in (0, len(w) - 1):
                    np.testing.assert_array_equal(lg[path][t], w[t], err_msg=path)
            elif isinstance(w, np.ndarray):
                np.testing.assert_array_equal(lg[path], w, err_msg=path)
            else:
                assert lg[path] == w, path


def count_reads(monkeypatch):
    """Every ``read_edf`` / ``read_tiff`` the frame sequence makes, by path."""
    reads = []
    for name in ("read_edf", "read_tiff"):
        real = getattr(tio, name)

        def counted(path, *a, _real=real, **k):
            reads.append(path)
            return _real(path, *a, **k)

        monkeypatch.setattr(tio, name, counted)
    return reads


# -- speckle stack from files -----------------------------------------------------

def test_run_files_equals_in_memory_and_reads_each_file_once(edf_paths, in_memory, monkeypatch):
    reads = count_reads(monkeypatch)
    out = tmodels.SpeckleStackPipeline(**KW, **CPU).run_files(edf_paths)
    assert reads == edf_paths  # each file once, in order (frame 0 is kept from the sizing read)
    assert_same_results(out, in_memory)
    assert out["meta"]["stack_shape"] == (T, SIDE, SIDE)
    # a lazy map re-reads its frame: one file a map, none for the frame still cached
    del reads[:]
    maps = out["full"]["grain"]["autocorr"]
    assert maps[T - 1].shape == maps.shape[1:] and reads == []
    maps[1], maps[1], maps[3]
    assert reads == [edf_paths[1], edf_paths[3]]


def test_run_files_matches_jax(edf_paths, in_memory):
    ref = jmodels.SpeckleStackPipeline(**KW).run_files(edf_paths)
    out = dict(in_memory)
    for side in (out, ref):  # the lazy maps are held by test_torch_stack_options
        side["full"] = {**side["full"], "grain": {k: v for k, v in side["full"]["grain"].items()
                                                  if k != "autocorr"}}
    assert out["meta"]["tracking"]["roi_size_yx"] == ref["meta"]["tracking"]["roi_size_yx"]
    assert out["meta"].keys() == ref["meta"].keys()
    _compare(out, ref, rtol=1e-4, gate_semantics=True)


def test_run_edf_files_is_run_files(edf_paths, in_memory):
    pipe = tmodels.SpeckleStackPipeline(**KW, **CPU)
    assert_same_results(pipe.run_edf_files(tuple(edf_paths)), in_memory)


def test_mixed_tiff_and_edf_files(stack, edf_paths, in_memory, tmp_path, monkeypatch):
    paths = list(edf_paths)
    for t in (1, 4):
        jio.save_tiff(stack[t], tmp_path / f"scan_{t}.tif")  # uint16: stored as it is
        paths[t] = str(tmp_path / f"scan_{t}.tif")
    (tmp_path / "scan_3.TIFF").write_bytes((tmp_path / "scan_1.tif").read_bytes())
    reads = count_reads(monkeypatch)
    out = tmodels.SpeckleStackPipeline(**KW, **CPU).run_files(paths)
    assert reads == paths
    assert_same_results(out, in_memory)
    ref = jmodels.SpeckleStackPipeline(**KW).run_files(paths)
    np.testing.assert_allclose(out["temporal"]["abs"]["dx"], ref["temporal"]["abs"]["dx"], atol=5e-3)
    np.testing.assert_allclose(out["full"]["grain"]["lx"], ref["full"]["grain"]["lx"], rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(tracking_search_radius=12.0), dict(tracking_method="phase"),
                                dict(metrics="amplitude,stats", tiles=False, display_origin="upper")],
                         ids=["windowed", "phase", "subset_upper"])
def test_run_files_options_equal_in_memory(stack, edf_paths, kw):
    pipe = tmodels.SpeckleStackPipeline(frame_chunk=3, **kw, **CPU)
    assert_same_results(pipe.run_files(edf_paths), pipe(stack.astype(np.float32)))


def test_checkpointed_file_run_resumes(edf_paths, in_memory, tmp_path, monkeypatch):
    pipe = tmodels.SpeckleStackPipeline(**KW, **CPU)
    first = pipe.run_files(edf_paths, checkpoint_dir=tmp_path)
    assert_same_results(first, in_memory)
    chunks = sorted(tmp_path.glob("torch_speckle_fused_*.npz"))
    assert len(chunks) == 3
    chunks[1].unlink()  # frames 2-3 are lost
    reads = count_reads(monkeypatch)
    resumed = pipe.run_files(edf_paths, checkpoint_dir=tmp_path)
    # frame 0 (sizing, templates), then the lost chunk behind its predecessor
    assert reads == [edf_paths[0], edf_paths[1], edf_paths[2], edf_paths[3]]
    assert_same_results(resumed, in_memory)
    del reads[:]
    again = pipe.run_files(edf_paths, checkpoint_dir=tmp_path)
    assert reads == [edf_paths[0]]  # a full resume reads the sizing frame only
    assert_same_results(again, in_memory)


def test_pipelines_take_path_objects_and_reject_bad_lists(edf_paths, tmp_path):
    from pathlib import Path

    pipe = tmodels.SpeckleStackPipeline(metrics="amplitude", tiles=False, **KW, **CPU)
    out = pipe.run_files([Path(p) for p in edf_paths[:2]])
    assert out["meta"]["n_frames"] == 2
    tio.save_edf(np.zeros((4, 4), np.float32), tmp_path / "small.edf")
    for bad, exc in (([], ValueError), ([str(tmp_path / "missing.edf")], FileNotFoundError),
                     ([edf_paths[0], str(tmp_path / "small.edf")], ValueError)):
        with pytest.raises(exc) as want:
            jmodels.SpeckleStackPipeline(metrics="amplitude", tiles=False, **KW).run_files(bad)
        with pytest.raises(exc) as got:
            pipe.run_files(bad)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


# -- the frame sequence and the out-of-core view -------------------------------------

def test_frame_sequence_indexing_equals_jax(stack, edf_paths):
    js, ts = jpipe._FrameSequence(edf_paths), tpipe._FrameSequence(edf_paths)
    assert ts.shape == js.shape == (T, SIDE, SIDE) and ts.dtype == js.dtype == np.float32
    keys = [0, np.int64(2), -1, slice(1, 4), slice(None, None, 2), (3,), (slice(0, 2),),
            (1, slice(5, 9)), (2, slice(0, 4), slice(1, 3)), (slice(1, 3), slice(0, 8), slice(2, 6))]
    for key in keys:
        got, want = ts[key], js[key]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts[slice(1, 4)], stack[1:4].astype(np.float32))
    for key in ("a", ([0, 1], slice(0, 2)), [0, 1]):
        with pytest.raises(TypeError) as want:
            js[key]
        with pytest.raises(TypeError, match="unsupported index"):
            ts[key]
        assert str(want.value).startswith("unsupported index")
    assert tpipe._FrameSequence(edf_paths, dtype=np.float64)[1].dtype == np.float64


def test_frame_sequence_rejects_stacked_frames(tmp_path):
    tio.save_edf(np.zeros((4, 4), np.float32), tmp_path / "ok.edf")
    jio.save_tiff(np.zeros((2, 4, 4), np.uint16), tmp_path / "s.tif")
    assert tpipe._FrameSequence([str(tmp_path / "ok.edf")]).shape == (1, 4, 4)
    with pytest.raises(ValueError, match="empty frame path list"):
        tpipe._FrameSequence([])
    import h5py

    with h5py.File(tmp_path / "rgb.h5", "w") as f:
        f.create_dataset("d", data=np.zeros((3, 4, 4)))
    view = tpipe._NdarrayView(h5py.File(tmp_path / "rgb.h5", "r")["d"])
    assert view.shape == (3, 4, 4) and view.ndim == 3 and view.dtype == np.float64
    assert isinstance(view, np.ndarray) and view[1:3].shape == (2, 4, 4)


class _CountingSource:
    """An in-memory stack that records how it is indexed."""

    def __init__(self, data):
        self.data, self.keys = data, []
        self.shape, self.dtype = data.shape, data.dtype

    def __getitem__(self, key):
        self.keys.append(key)
        return self.data[key]


def _frames_asked(keys, n):
    """The frame indices each recorded key touches; fails on any key that
    is not ``t`` or ``c0:c1``."""
    out = []
    for key in keys:
        if isinstance(key, (int, np.integer)):
            out.append([int(key)])
        else:
            assert isinstance(key, slice) and key.step in (None, 1), key
            out.append(list(range(*key.indices(n))))
    return out


@pytest.mark.parametrize("kw", [dict(), dict(tracking_search_radius=12.0),
                                dict(tracking_method="phase"), dict(grain_maps=False)],
                         ids=["template", "windowed", "phase", "no_maps"])
def test_speckle_loop_only_slices_the_view(stack, kw):
    """``speckle_stack_stats`` over a view whose buffer is empty: every access
    is ``stack[t]`` or ``stack[c0:c1]`` of at most a chunk, each frame is
    asked for once per pass (frame 0 also for sizing, templates and its own
    predecessor), and the result equals the plain array's exactly."""
    f32 = stack.astype(np.float32)
    src = _CountingSource(f32)
    opts = dict(frame_chunk=2, verbose=False, **kw, **CPU)
    out = tdip.speckle_stack_stats(tpipe._NdarrayView(src), **opts)
    asked = _frames_asked(src.keys, T)
    assert max(len(a) for a in asked) <= 2
    assert asked == [[0], [0], [0], [0, 1], [2, 3], [4]]
    assert_same_results(out, tdip.speckle_stack_stats(f32, **opts))
    if kw.get("grain_maps", True):
        del src.keys[:]
        out["full"]["grain"]["autocorr"][3]
        assert _frames_asked(src.keys, T) == [[3]]


def test_sharpness_and_xst_loops_only_slice_the_view(stack):
    f32 = stack.astype(np.float32)
    src = _CountingSource(f32)
    out = tdip.sharpness_stack_stats(tpipe._NdarrayView(src), frame_chunk=2, tiles=False,
                                     verbose=False, **CPU)
    assert _frames_asked(src.keys, T) == [[0, 1], [2, 3], [4]]
    want = tdip.sharpness_stack_stats(f32, frame_chunk=2, tiles=False, verbose=False, **CPU)
    for path, w in _leaves(want["full"]):
        np.testing.assert_array_equal(dict(_leaves(out["full"]))[path], w, err_msg=path)

    track = dict(tile_size=17, step=16, search_radius=4, **CPU)
    for method, batch, asked in (("fft", 4, [[0], [0], [1], [2], [3], [4]]),
                                 ("pallas", 2, [[0], [0, 1], [2, 3], [4]])):
        src = _CountingSource(f32)
        got = tsignal.track_displacement_stack(tpipe._NdarrayView(src), method=method,
                                               frame_batch=batch, **track)
        assert _frames_asked(src.keys, T) == asked, method
        ref = tsignal.track_displacement_stack(f32, method=method, frame_batch=batch, **track)
        for k in ("dy", "dx", "peak"):
            np.testing.assert_array_equal(got[k], ref[k])


# -- HDF5 ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h5_path(stack, tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "run.h5"
    tio.save_h5(stack, path)
    return str(path)


def test_run_hdf5_equals_the_uint16_run_and_differs_from_float32(stack, h5_path, in_memory):
    pipe = tmodels.SpeckleStackPipeline(**KW, **CPU)
    out = pipe.run_hdf5(h5_path)
    assert_same_results(out, pipe(stack))  # the dataset's own uint16 reaches the loop
    np.testing.assert_array_equal(out["temporal"]["abs"]["dx"], in_memory["temporal"]["abs"]["dx"])
    ref = jmodels.SpeckleStackPipeline(**KW).run_hdf5(h5_path)
    np.testing.assert_allclose(out["temporal"]["abs"]["dy"], ref["temporal"]["abs"]["dy"], atol=5e-3)
    for g in ("amplitude", "stats", "bandwidth"):
        for k, v in ref["full"][g].items():
            np.testing.assert_allclose(out["full"][g][k], v, rtol=1e-4, atol=1e-6, err_msg=f"{g}.{k}")


def test_run_hdf5_float64_matches_jax(stack, tmp_path):
    st = speckle_stack(3, (SIDE, SIDE), seed=np.random.default_rng(5), dtype=np.float64)
    jio.save_h5(st, tmp_path / "f64.h5")
    kw = dict(frame_chunk=2, metrics="amplitude,grain,stats")
    out = tmodels.SpeckleStackPipeline(**kw, **CPU).run_hdf5(str(tmp_path / "f64.h5"))
    ref = jmodels.SpeckleStackPipeline(**kw).run_hdf5(str(tmp_path / "f64.h5"))
    assert out["full"]["stats"]["mean"].dtype == np.float64
    for side in (out, ref):
        side["full"]["grain"].pop("autocorr")
    _compare(out, ref, rtol=1e-8, gate_semantics=False)


def test_run_hdf5_keeps_the_file_open_for_the_lazy_maps(h5_path, in_memory):
    """A map read after the call re-reads its frame from the open file; the
    handle closes with the last leaf (no ResourceWarning, and the file can
    be opened for writing again)."""
    import h5py

    with warnings.catch_warnings():
        warnings.simplefilter("error", ResourceWarning)
        out = tmodels.SpeckleStackPipeline(**KW, **CPU).run_hdf5(h5_path)
        gc.collect()
        with pytest.raises(OSError):  # still open for reading in this process
            h5py.File(h5_path, "r+")
        got = out["full"]["grain"]["autocorr"][2]
        # uint16 frames and float32 frames of the same counts give the same map
        np.testing.assert_array_equal(got, in_memory["full"]["grain"]["autocorr"][2])
        del out
        gc.collect()
        with h5py.File(h5_path, "r+") as f:
            assert f[tio.h5.DATASET_PATH].shape == (T, SIDE, SIDE)


def test_run_hdf5_closes_the_file_when_the_run_fails(h5_path, tmp_path):
    import h5py

    tio.save_h5(np.zeros((SIDE, SIDE), np.float32), tmp_path / "two_d.h5")
    pipe = tmodels.SpeckleStackPipeline(**KW, **CPU)
    with pytest.raises(ValueError) as want:
        jmodels.SpeckleStackPipeline(**KW).run_hdf5(str(tmp_path / "two_d.h5"))
    with pytest.raises(ValueError) as got:
        pipe.run_hdf5(str(tmp_path / "two_d.h5"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="tracking method"):
        tmodels.SpeckleStackPipeline(tracking_method="optical", **CPU).run_hdf5(h5_path)
    gc.collect()
    for path in (tmp_path / "two_d.h5", h5_path):
        h5py.File(path, "r+").close()


def test_run_hdf5_big_endian_dataset(stack, tmp_path, in_memory):
    """A dataset stored big-endian reaches ``upload`` in that byte order."""
    import h5py

    with h5py.File(tmp_path / "be.h5", "w") as f:
        f.create_dataset(tio.h5.DATASET_PATH, data=stack.astype(">u2"))
    out = tmodels.SpeckleStackPipeline(**KW, **CPU).run_hdf5(str(tmp_path / "be.h5"))
    np.testing.assert_array_equal(out["temporal"]["abs"]["dx"], in_memory["temporal"]["abs"]["dx"])
    np.testing.assert_array_equal(out["full"]["grain"]["lx"], in_memory["full"]["grain"]["lx"])


# -- sharpness and wavefront scans from files ----------------------------------------------

def _focus_scan():
    from scipy.ndimage import gaussian_filter

    base = speckle_stack(1, (160, 160), seed=np.random.default_rng(9), dtype=np.float64,
                         mean_counts=3000.0)[0]
    return np.stack([gaussian_filter(base, s) for s in (2.0, 1.0, 0.0, 1.5)]).astype(np.float32)


def test_sharpness_run_files_mixed_formats(tmp_path, monkeypatch):
    scan = _focus_scan()
    paths = []
    for t, frame in enumerate(scan):
        if t % 2:
            jio.save_tiff(frame, tmp_path / f"focus_{t}.tif", dtype="float32")
            paths.append(str(tmp_path / f"focus_{t}.tif"))
        else:
            tio.save_edf(frame, tmp_path / f"focus_{t}.edf")
            paths.append(str(tmp_path / f"focus_{t}.edf"))
    kw = dict(metrics="gradient,laplacian,spectral", frame_chunk=3)
    pipe = tmodels.SharpnessScanPipeline(**kw, **CPU)
    reads = count_reads(monkeypatch)
    out = pipe.run_files(paths)
    assert reads == paths
    assert out["meta"]["focus"]["best_frame"] == 2
    mem = pipe(scan)
    assert out["meta"]["focus"] == mem["meta"]["focus"]
    ref = jmodels.SharpnessScanPipeline(**kw).run_files(paths)
    assert ref["meta"]["focus"]["best_frame"] == 2
    got, want, own = (dict(_leaves(side["full"])) for side in (out, ref, mem))
    assert got.keys() == want.keys() == own.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], own[path], err_msg=path)
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4, err_msg=path)  # float32, as the stack tests
    ckpt = pipe.run_files(paths, checkpoint_dir=tmp_path / "ck")
    again = pipe.run_files(paths, checkpoint_dir=tmp_path / "ck")
    assert ckpt["meta"]["focus"] == again["meta"]["focus"] == out["meta"]["focus"]


def test_wavefront_run_files(tmp_path, monkeypatch):
    frames = speckle_stack(4, (160, 160), seed=np.random.default_rng(10), dtype=np.float32,
                           mean_counts=3000.0)
    paths = []
    for t, frame in enumerate(frames):
        paths.append(str(tmp_path / f"xst_{t}.edf"))
        tio.save_edf(frame, paths[-1])
    kw = dict(pixel_size=1e-6, distance=0.5, wavelength=1e-10, tile_size=25, step=16, search_radius=5)
    pipe = tmodels.WavefrontScanPipeline(**kw, **CPU)
    reads = count_reads(monkeypatch)
    own = pipe.run_files(paths)  # the first file is the reference
    assert reads == paths
    mem = pipe(frames)
    ref = jmodels.WavefrontScanPipeline(**kw).run_files(paths)
    _compare_fields(own, ref)
    for k in ("dy", "dx", "peak", "wavefront", "phase"):
        np.testing.assert_array_equal(own[k], mem[k], err_msg=k)
    assert np.abs(own["dy"][0]).max() < 0.1  # frame 0 against itself
    # an explicit reference file, read through read_image
    with_ref = pipe.run_files(paths[1:], reference_path=paths[0])
    for k in ("dy", "dx", "peak"):
        np.testing.assert_array_equal(with_ref[k], own[k][1:], err_msg=k)
    _compare_fields(with_ref, jmodels.WavefrontScanPipeline(**kw).run_files(
        paths[1:], reference_path=paths[0]))
