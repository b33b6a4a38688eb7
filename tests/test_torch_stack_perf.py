# SPDX-License-Identifier: CECILL-2.1
"""``metrics.stack_fused``'s per-run record and its compute probe, on the
7-frame 160^2 spiral of ``tests/test_resident_stack.py``:

- ``LAST_RUN_PERF`` holds the JAX package's keys, the port's three
  counts of how the metric step ran (``GRAPH_KEYS``: on the CPU every step
  is eager) and the entry's two (``ENTRY_KEYS``), after every
  ``speckle_stack_stats`` call; a host stack counts
  its uploads in its own
  dtype, a tensor stack is ``resident`` with none, a resumed checkpoint runs
  no chunk, a mesh counts the port's own chunks, and the outputs of every
  run stay exactly those of the host run;
- ``device_compute_probe`` times the loop's own step over a resident
  stack: its frame count follows the JAX package's rule, and it raises on
  non-finite tracking and where no device is given and no card exists;
- every stack path runs through ``metrics.common``'s one chunk loop, once a
  call.
"""
import numpy as np
import pytest
import torch

import barc4dip_tpu.metrics as jm
import barc4dip_tpu_torch.metrics as tm
from barc4dip_tpu.metrics import stack_fused as j_fused
from barc4dip_tpu_torch import models, parallel, signal
from barc4dip_tpu_torch.geometry.roi import roi_grid_3x3
from barc4dip_tpu_torch.metrics import common, stack_fused
from barc4dip_tpu_torch.metrics.common import chunk_layout_signature
from tests.conftest import make_speckle

torch.set_num_threads(2)

KW = dict(metrics="all", tiles=False, verbose=False, frame_chunk=2, grain_maps=False)
JAX_KEYS = {"upload_s", "dispatch_s", "pull_wait_s", "upload_io_s", "upload_bytes", "pull_bytes", "chunks"}
GRAPH_KEYS = {"graph_replays", "graph_captures", "eager_steps"}
ENTRY_KEYS = {"frame0_s", "k1_cluster_launches"}
PROBE = dict(groups={"amplitude", "stats"}, mode="off", sat=65535.0, eps=1e-12, flip=True)


def _shifted_frame(field, dy, dx):
    ny, nx = field.shape
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    return np.real(np.fft.ifft2(np.fft.fft2(field) * np.exp(-2j * np.pi * (fy * dy + fx * dx))))


@pytest.fixture(scope="module")
def spiral_stack():
    base = make_speckle(np.random.default_rng(77), shape=(160, 160), grain_px=5.0)
    ts = np.arange(7)
    dys = 0.7 * ts * np.cos(ts * 0.8)
    dxs = 0.7 * ts * np.sin(ts * 0.8)
    return np.stack([_shifted_frame(base, dy, dx) for dy, dx in zip(dys, dxs)]).astype(np.float32)


@pytest.fixture(scope="module")
def host_run(spiral_stack):
    out = tm.speckle_stack_stats(spiral_stack, device="cpu", **KW)
    return out, dict(stack_fused.LAST_RUN_PERF)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_same_outputs(a, b, rtol=0.0):
    da = {p: np.asarray(v) for sec in ("full", "tiles", "temporal") if sec in a for p, v in _leaves(a[sec], sec)}
    db = {p: np.asarray(v) for sec in ("full", "tiles", "temporal") if sec in b for p, v in _leaves(b[sec], sec)}
    assert da.keys() == db.keys()
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        if rtol:
            np.testing.assert_allclose(da[k], db[k], rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_host_run_records_the_jax_keys_and_its_uploads(spiral_stack, host_run):
    jm.speckle_stack_stats(spiral_stack, **KW)
    _, perf = host_run
    assert set(j_fused.LAST_RUN_PERF) == JAX_KEYS
    assert set(perf) == JAX_KEYS | GRAPH_KEYS | ENTRY_KEYS
    T, H, W = spiral_stack.shape
    assert perf["chunks"] == len(chunk_layout_signature(T, 2)) == 4
    assert perf["eager_steps"] == 4 and perf["graph_replays"] == perf["graph_captures"] == 0
    assert perf["upload_bytes"] == spiral_stack.nbytes
    assert perf["upload_io_s"] == perf["upload_s"] > 0.0  # no card: the host's time
    assert perf["dispatch_s"] > 0.0 and perf["pull_wait_s"] >= 0.0
    # T rows of float32 columns: the packed vectors of every chunk
    assert perf["pull_bytes"] > 0 and perf["pull_bytes"] % (T * 4) == 0


def test_uint16_host_run_uploads_two_bytes_a_pixel(spiral_stack):
    stack = np.clip(spiral_stack * 1000.0, 0, 65535).astype(np.uint16)
    tm.speckle_stack_stats(stack, device="cpu", **KW)
    T, H, W = stack.shape
    assert stack_fused.LAST_RUN_PERF["upload_bytes"] == T * H * W * 2 == stack.nbytes


def test_tensor_run_is_resident_with_no_upload(spiral_stack, host_run):
    out = tm.speckle_stack_stats(torch.from_numpy(spiral_stack), **KW)
    perf = dict(stack_fused.LAST_RUN_PERF)
    assert perf.pop("resident") is True
    assert set(perf) == JAX_KEYS | GRAPH_KEYS | ENTRY_KEYS
    assert perf["upload_bytes"] == 0 and perf["upload_s"] == 0.0 and perf["upload_io_s"] == 0.0
    assert perf["chunks"] == 4 and perf["pull_bytes"] == host_run[1]["pull_bytes"]
    _assert_same_outputs(out, host_run[0])


def test_resumed_checkpoint_runs_no_chunk(spiral_stack, host_run, tmp_path):
    first = tm.speckle_stack_stats(spiral_stack, device="cpu", checkpoint_dir=tmp_path, **KW)
    assert stack_fused.LAST_RUN_PERF["chunks"] == 4
    again = tm.speckle_stack_stats(spiral_stack, device="cpu", checkpoint_dir=tmp_path, **KW)
    perf = stack_fused.LAST_RUN_PERF
    assert set(perf) == JAX_KEYS | GRAPH_KEYS | ENTRY_KEYS
    assert perf["chunks"] == 0 and perf["upload_bytes"] == 0 and perf["pull_bytes"] == 0
    assert perf["eager_steps"] == perf["graph_replays"] == perf["graph_captures"] == 0
    _assert_same_outputs(first, host_run[0])
    _assert_same_outputs(again, host_run[0])


def test_mesh_run_counts_the_ports_chunks(spiral_stack):
    """In float64, at ``tests/test_torch_parallel.py``'s 1e-12: a shard of one
    frame may round apart from a batch of two."""
    stack = spiral_stack.astype(np.float64)
    want = tm.speckle_stack_stats(stack, device="cpu", **KW)
    mesh = parallel.frame_mesh(["cpu", "cpu"])
    out = tm.speckle_stack_stats(stack, mesh=mesh, **KW)
    perf = stack_fused.LAST_RUN_PERF
    assert perf["chunks"] == len(chunk_layout_signature(7, 2, mesh)) == 4
    assert perf["upload_bytes"] == stack.nbytes
    _assert_same_outputs(out, want, rtol=1e-12)


def test_the_record_is_replaced_by_each_run(spiral_stack):
    tm.speckle_stack_stats(torch.from_numpy(spiral_stack), **KW)
    assert stack_fused.LAST_RUN_PERF["resident"] is True
    tm.speckle_stack_stats(spiral_stack[:3], device="cpu", **KW)
    assert "resident" not in stack_fused.LAST_RUN_PERF
    assert stack_fused.LAST_RUN_PERF["chunks"] == 2


def _grid(shape):
    grid, _ = roi_grid_3x3(shape, (31, 31), (16, 16), center_yx=None)
    return grid


def test_probe_runs_on_the_cpu(spiral_stack):
    out = stack_fused.device_compute_probe(
        spiral_stack, _grid(spiral_stack.shape[1:]), frame_chunk=2, device="cpu", **PROBE
    )
    assert set(out) == {"elapsed_s", "metrics_only_s", "tracking_only_s", "frames", "mpix_s"}
    assert out["frames"] >= 4
    assert np.isfinite(out["mpix_s"]) and out["mpix_s"] > 0
    assert out["metrics_only_s"] > 0 and out["tracking_only_s"] > 0
    assert out["mpix_s"] == pytest.approx(out["frames"] * 160 * 160 / 1e6 / out["elapsed_s"])


@pytest.mark.parametrize("T, frame_chunk, frames", [(7, 2, 6), (3, 4, 3)])
def test_probe_frames_follow_the_jax_rule(spiral_stack, T, frame_chunk, frames):
    """T rounds down to a multiple of B = min(frame_chunk, T): 6 of 7 frames
    at chunk 2; a stack shorter than its chunk is probed whole."""
    stack = spiral_stack[:T]
    grid = _grid(stack.shape[1:])
    got = stack_fused.device_compute_probe(stack, grid, frame_chunk=frame_chunk, device="cpu", **PROBE)
    want = j_fused.device_compute_probe(stack, grid, frame_chunk=frame_chunk, **PROBE)
    assert got["frames"] == want["frames"] == frames


def test_probe_of_a_tensor_stack_stays_on_its_device(spiral_stack):
    st = torch.from_numpy(np.clip(spiral_stack * 1000.0, 0, 65535).astype(np.uint16))
    out = stack_fused.device_compute_probe(st, _grid(st.shape[1:]), frame_chunk=2, **PROBE)
    assert out["frames"] == 6 and np.isfinite(out["mpix_s"]) and out["mpix_s"] > 0


@pytest.mark.parametrize("T, side, chunk, itemsize, frames", [
    (16, 2048, 4, 4, 16),       # Config D: every frame
    (200, 2048, 4, 4, 128),     # 2 GiB of float32 2048^2 frames
    (200, 2048, 3, 8, 63),      # float64, rounded down to the chunk
    (30000, 160, 4, 4, 20968),
    (2, 46341, 4, 8, 2),        # a frame above the cap still gives one chunk
])
def test_probe_caps_the_resident_frames_at_2_gib(T, side, chunk, itemsize, frames):
    assert stack_fused._probed_frames(T, side, side, chunk, itemsize) == frames


def test_probe_raises_on_non_finite_tracking(spiral_stack, monkeypatch):
    def nan_track(frames, prevs, tpl0, starts, s, subpixel, eps):
        nan = torch.full((frames.shape[0], 9), float("nan"), dtype=frames.dtype)
        return nan, nan, nan, nan

    monkeypatch.setattr(stack_fused, "_track_chunk", nan_track)
    with pytest.raises(RuntimeError, match="non-finite tracking"):
        stack_fused.device_compute_probe(
            spiral_stack, _grid(spiral_stack.shape[1:]), frame_chunk=2, device="cpu", **PROBE
        )


def test_probe_needs_a_device_or_a_card(spiral_stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        stack_fused.device_compute_probe(spiral_stack, _grid(spiral_stack.shape[1:]), **PROBE)


#: entry -> a call of it on a host stack
STACK_PATHS = {
    "speckle_stack_stats": lambda st: tm.speckle_stack_stats(st, device="cpu", **KW),
    "sharpness_stack_stats": lambda st: tm.sharpness_stack_stats(
        st, metrics="gradient,spectral", tiles=False, verbose=False, frame_chunk=2, device="cpu"),
    "spectral_summary_stack": lambda st: signal.spectral_summary_stack(st, frame_chunk=2, device="cpu"),
    "visibility_map": lambda st: tm.visibility_map(st, window=8, stride=4, frame_chunk=2, device="cpu"),
    "SharpnessScanPipeline": lambda st: models.SharpnessScanPipeline(frame_chunk=2, device="cpu")(st),
}


@pytest.mark.parametrize("path", sorted(STACK_PATHS))
def test_every_stack_path_runs_the_one_chunk_loop_once(spiral_stack, path, monkeypatch):
    calls = []
    real = common.run_chunks

    def counted(stack, step, **kw):
        calls.append(int(stack.shape[0]))
        return real(stack, step, **kw)

    monkeypatch.setattr(common, "run_chunks", counted)
    STACK_PATHS[path](spiral_stack)
    assert calls == [spiral_stack.shape[0]]
