# SPDX-License-Identifier: CECILL-2.1
"""``mesh=`` in the port against the JAX package's, case by case with
``tests/test_parallel.py``: the same fixtures (192^2 T = 8; 384^2 T = 11 with
``frame_chunk=4``, so the last chunk leaves shards empty), the port on
``frame_mesh(["cpu"] * 8)`` (one device named eight times: eight shards, as
the JAX tests' forced host device count gives eight devices), the JAX
package on its 8-device CPU mesh. Each sharded port run is held against the
JAX package's sharded run and against the port's own unsharded run: metrics
at 1e-12 (full frame) and 1e-10 (with tiles), trajectories at 1e-5 px, the
lazy map of frame 3 at 1e-10.
"""
import numpy as np
import pytest
import torch

import barc4dip_tpu.metrics as jm
import barc4dip_tpu.metrics.common as j_common
import barc4dip_tpu.parallel as jpar
import barc4dip_tpu.signal as jsig
import barc4dip_tpu_torch.metrics as tm
import barc4dip_tpu_torch.metrics.common as t_common
import barc4dip_tpu_torch.parallel as tpar
import barc4dip_tpu_torch.signal as tsig
from tests.conftest import make_speckle
from tests.test_parallel import _shifted_frame

CPU = dict(device="cpu")
SHIFTS = [(0.0, 0.0), (1.0, -0.5), (2.5, 1.0), (-1.0, 2.0),
          (0.5, 0.5), (3.0, -2.0), (-2.0, -1.5), (1.5, 2.5)]


@pytest.fixture(scope="module")
def mesh():
    return tpar.frame_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def stack():
    rng = np.random.default_rng(61)
    base = make_speckle(rng, shape=(192, 192), grain_px=6.0)
    return np.stack([_shifted_frame(base, dy, dx) for dy, dx in SHIFTS])


@pytest.fixture(scope="module")
def stack_256():
    rng = np.random.default_rng(62)
    base = make_speckle(rng, shape=(384, 384), grain_px=7.0)
    shifts = [(0.3 * t * np.cos(0.6 * t), 0.3 * t * np.sin(0.6 * t)) for t in range(11)]
    return np.stack([_shifted_frame(base, dy, dx) for dy, dx in shifts])


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=tol, atol=tol, err_msg=what)


def _stats_close(got, want, tol, *, skip=("autocorr", "xlag", "ylag")):
    for section in ("full", "tiles"):
        assert (section in got) == (section in want), section
        for g, fields in want.get(section, {}).items():
            for k, v in fields.items():
                if k in skip:
                    continue
                if isinstance(v, dict):
                    for kk in v:
                        _close(got[section][g][k][kk], v[kk], tol, f"{section}/{g}/{k}/{kk}")
                else:
                    _close(got[section][g][k], v, tol, f"{section}/{g}/{k}")


def _tracks_close(got, want, tol=1e-5, keys=("dx", "dy", "r")):
    for blk in ("abs", "inc"):
        for k in keys:
            _close(got["temporal"][blk][k], want["temporal"][blk][k], tol, f"{blk}/{k}")


# -- the mesh objects -------------------------------------------------------------

def test_mesh_has_8_devices(mesh):
    assert mesh.size == jpar.frame_mesh().size == 8
    assert tpar.FRAME_AXIS == jpar.FRAME_AXIS
    assert mesh.axis_names == jpar.frame_mesh().axis_names
    assert mesh.shape == dict(jpar.frame_mesh().shape)
    assert mesh.devices == (torch.device("cpu"),) * 8


def test_shard_frames_places_across_devices(stack, mesh):
    arr = np.ascontiguousarray(stack[:8], dtype=np.float32)
    sharded = tpar.shard_frames(arr, mesh)
    assert sharded.sharding == tpar.frames_sharding(mesh)
    assert sharded.sharding != tpar.replicated_sharding(mesh)
    assert len(sharded.shards) == 8 and sharded.shape == arr.shape
    assert sharded.device_set == sharded.sharding.device_set == {torch.device("cpu")}
    j_sharded = jpar.shard_frames(arr, jpar.frame_mesh())
    for k, shard in enumerate(sharded.shards):
        assert shard.dtype == torch.float32 and sharded.bounds[k] == (k, k + 1)
        np.testing.assert_array_equal(shard.numpy(), np.asarray(j_sharded.addressable_shards[k].data))
    # a tensor stack shards the same way; T not a multiple of the mesh leaves short shards
    short = tpar.shard_frames(torch.from_numpy(arr[:5]), tpar.frame_mesh(["cpu"] * 2))
    assert [tuple(s.shape)[0] for s in short.shards] == [3, 2]


def test_frame_mesh_without_a_card_raises(monkeypatch):
    """``frame_mesh()`` takes every CUDA device, and raises where there is
    none: the CPU is never chosen unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.frame_mesh()
    with pytest.raises(ValueError):
        tpar.frame_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tpar.frame_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tpar.frame_mesh(["cuda:0", "cuda:0"]).size == 2


@pytest.mark.parametrize("T,chunk,n", [(11, 4, 8), (16, 4, 2), (16, 4, 1), (7, 3, 2), (5, 8, 4), (3, 1, 8)])
def test_chunk_layout_signature_matches_jax(T, chunk, n):
    """The chunk layout under a mesh (the checkpoint's ``schedule``) is the
    JAX package's: the chunk rounded up to a multiple of the mesh size."""
    jmesh = jpar.frame_mesh(list(np.asarray(jpar.frame_mesh().devices).ravel()[:n]))
    got = t_common.chunk_layout_signature(T, chunk, tpar.frame_mesh(["cpu"] * n))
    assert got == j_common.chunk_layout_signature(T, chunk, jmesh)


# -- the stack paths ----------------------------------------------------------------

def test_sharpness_stack_sharded_matches_single(stack, mesh):
    kwargs = dict(metrics="gradient,laplacian,stats", tiles=False, verbose=False)
    single = tm.sharpness_stack_stats(stack, **kwargs, **CPU)
    sharded = tm.sharpness_stack_stats(stack, mesh=mesh, **kwargs, **CPU)
    j_sharded = jm.sharpness_stack_stats(stack, mesh=jpar.frame_mesh(), **kwargs)
    _stats_close(sharded, single, 1e-12)
    _stats_close(sharded, j_sharded, 1e-12)


def test_speckle_stack_sharded_matches_single(stack, mesh):
    kwargs = dict(metrics="amplitude,stats", tiles=False, verbose=False, frame_chunk=8)
    single = tm.speckle_stack_stats(stack, **kwargs, **CPU)
    sharded = tm.speckle_stack_stats(stack, mesh=mesh, **kwargs, **CPU)
    j_sharded = jm.speckle_stack_stats(stack, mesh=jpar.frame_mesh(), **kwargs)
    _stats_close(sharded, single, 1e-12)
    _stats_close(sharded, j_sharded, 1e-12)
    _tracks_close(sharded, single)  # the t-1 chain across shard boundaries
    _tracks_close(sharded, j_sharded)


@pytest.fixture(scope="module")
def all_metrics(stack_256, mesh):
    kwargs = dict(metrics="all", tiles=True, verbose=False, frame_chunk=4)
    return {
        "single": tm.speckle_stack_stats(stack_256, **kwargs, **CPU),
        "sharded": tm.speckle_stack_stats(stack_256, mesh=mesh, **kwargs, **CPU),
        "jax": jm.speckle_stack_stats(stack_256, mesh=jpar.frame_mesh(), **kwargs),
    }


@pytest.mark.parametrize("against", ["single", "jax"])
def test_speckle_stack_all_metrics_tiles_sharded(all_metrics, against):
    """Grain, bandwidth and the tile executor under the mesh, T = 11 not a
    multiple of 8 (chunks of 8 frames, the last with five empty shards)."""
    sharded, want = all_metrics["sharded"], all_metrics[against]
    assert "tiles" in sharded and "tiles" in want
    _stats_close(sharded, want, 1e-10)
    _tracks_close(sharded, want)
    _close(sharded["full"]["grain"]["autocorr"][3], want["full"]["grain"]["autocorr"][3], 1e-10,
           "autocorr[3]")
    assert sharded["full"]["grain"]["autocorr"].shape == (11, 384, 384)


def test_sharpness_stack_sharded_odd_T(stack_256, mesh):
    kwargs = dict(metrics="all", tiles=True, verbose=False, frame_chunk=4)
    single = tm.sharpness_stack_stats(stack_256, **kwargs, **CPU)
    sharded = tm.sharpness_stack_stats(stack_256, mesh=mesh, **kwargs, **CPU)
    _stats_close(sharded, single, 1e-10)


def test_speckle_checkpoint_resume_under_mesh(stack_256, mesh, tmp_path):
    """A second sharded run against the chunks on disk reproduces the first;
    an unsharded run's chunks are never resumed by a sharded run (its
    layout, and so its configuration, differs)."""
    kwargs = dict(metrics="amplitude,grain,stats", tiles=False, verbose=False, frame_chunk=4,
                  **CPU)
    ck = tmp_path / "ck"
    plain = tm.speckle_stack_stats(stack_256, checkpoint_dir=ck, **kwargs)
    plain_files = set(ck.rglob("*.npz"))
    assert len(plain_files) == 3  # chunks of 4 frames
    fresh = tm.speckle_stack_stats(stack_256, checkpoint_dir=ck, mesh=mesh, **kwargs)
    mesh_files = set(ck.rglob("*.npz")) - plain_files
    assert len(mesh_files) == 2  # chunks of 8 frames, written anew
    resumed = tm.speckle_stack_stats(stack_256, checkpoint_dir=ck, mesh=mesh, **kwargs)
    assert set(ck.rglob("*.npz")) == plain_files | mesh_files
    _stats_close(resumed, fresh, 1e-10)
    _stats_close(fresh, plain, 1e-10)
    _tracks_close(resumed, fresh, 1e-6, keys=("dx", "dy"))


def test_sharded_tracking_recovers_shifts(stack, mesh):
    out = tm.speckle_stack_stats(stack, metrics="stats", tiles=False, verbose=False, mesh=mesh,
                                 **CPU)
    np.testing.assert_allclose(out["temporal"]["abs"]["dy"], [s[0] for s in SHIFTS], atol=0.25)
    np.testing.assert_allclose(out["temporal"]["abs"]["dx"], [s[1] for s in SHIFTS], atol=0.25)


def test_speckle_stack_windowed_search_under_mesh(stack_256, mesh):
    kwargs = dict(metrics="amplitude,stats", tiles=False, verbose=False, frame_chunk=4)
    single_full = tm.speckle_stack_stats(stack_256, **kwargs, **CPU)
    sharded_win = tm.speckle_stack_stats(stack_256, mesh=mesh, tracking_search_radius=20,
                                         **kwargs, **CPU)
    _tracks_close(sharded_win, single_full, keys=("dx", "dy"))


def test_displacement_stack_round_robin_mesh(stack_256, mesh):
    sub = np.ascontiguousarray(stack_256[:5], dtype=np.float64)
    kw = dict(tile_size=25, step=24, search_radius=5, method="fft")
    single = tsig.track_displacement_stack(sub, **kw, **CPU)
    meshy = tsig.track_displacement_stack(sub, mesh=mesh, **kw, **CPU)
    j_meshy = jsig.track_displacement_stack(sub, mesh=jpar.frame_mesh(), **kw)
    for k in ("dy", "dx", "peak"):
        _close(meshy[k], single[k], 1e-12, k)
        _close(meshy[k], j_meshy[k], 1e-5, k)
    assert meshy["meta"]["method"] == "fft" and "frame_batch" not in meshy["meta"]


def test_spectral_summary_stack_sharded_matches_single(stack, mesh):
    single = tsig.spectral_summary_stack(stack, frame_chunk=4, **CPU)
    sharded = tsig.spectral_summary_stack(stack, frame_chunk=4, mesh=mesh, **CPU)
    j_sharded = jsig.spectral_summary_stack(stack, frame_chunk=4, mesh=jpar.frame_mesh())
    for key in ("radial_binned", "radial_interpolated"):
        _close(sharded[key], single[key], 1e-12, key)
        _close(sharded[key], j_sharded[key], 1e-12, key)


def test_spectral_summary_stack_resident_under_mesh(stack, mesh):
    """A tensor stack's shards are sliced and moved to their devices."""
    single = tsig.spectral_summary_stack(stack, frame_chunk=4, **CPU)
    resident = tsig.spectral_summary_stack(torch.from_numpy(stack), frame_chunk=4, mesh=mesh)
    for key in ("radial_binned", "radial_interpolated"):
        _close(resident[key], single[key], 1e-12, key)
