# SPDX-License-Identifier: CECILL-2.1
"""The speckle metric step as CUDA graphs (``speckles_device.metric_step``)
and the device constants it reads.

On the CPU (tier 1): the step runs eagerly and counts no replay; the
reordered step (every group but grain, then each place's autocorrelation
and widths) gives the leaves of the plain composition of the cores, bit for
bit; each cached device constant equals what the step used to upload on
every call.

On the card (marked ``cuda``, skipped without one): a replayed step equals
the eager step bit for bit; a 25-chunk stack captures once and replays the
rest, then replays every chunk; kernel K1 is launched and counted on every
call; the trajectories and leaves of a graphed run equal an eager run's; a
tail chunk of another width runs eagerly. On the card:

    python -m pytest tests/test_torch_graph_step.py -q
"""
import math

import numpy as np
import pytest
import torch

import barc4dip_tpu_torch as port
from barc4dip_tpu_torch.config import device_constant, to_compute
from barc4dip_tpu_torch.metrics import speckles_device, stack_fused
from barc4dip_tpu_torch.metrics.common import (
    apply_display_origin,
    pack_leaves,
    subtile_grids_to_3x3_device,
    tile_plan,
    tiled_scalar_fields_device,
)
from barc4dip_tpu_torch.metrics.estimators import (
    amplitude_core,
    bandwidth_core,
    distribution_moments_core,
    grain_core,
)
from barc4dip_tpu_torch.metrics.speckles_device import metric_step, speckle_device_fn
from barc4dip_tpu_torch.ops import cuda_fftp
from barc4dip_tpu_torch.ops.quantile import nanpercentiles_exact
from barc4dip_tpu_torch.ops.radialcore import (
    binned_geometry,
    interpolated_geometry,
    radial_mean_binned_core,
    radial_mean_interpolated_core,
)
from barc4dip_tpu_torch.utils import speckle_stack

torch.set_num_threads(2)

ALL = frozenset({"amplitude", "grain", "stats", "bandwidth"})
GRAPH_KEYS = {"graph_replays", "graph_captures", "eager_steps"}


def _plain_tree(groups, mode, sat, eps, imgs, int_range):
    """The metric tree as the plain composition of the cores: every group
    on the frame, then every group on each tile bucket."""
    cores = {
        "amplitude": lambda img: amplitude_core(img, integer_range=int_range),
        "grain": lambda img: grain_core(img, with_map=False),
        "stats": lambda img: distribution_moments_core(img, saturation_value=sat, eps=eps),
        "bandwidth": lambda img: bandwidth_core(img),
    }

    def scalars(img):
        return {g: core(img) for g, core in cores.items() if g in groups}

    def tile_fn(tile):
        return {f"{g}/{k}": v for g, d in scalars(tile).items() for k, v in d.items()}

    out = {"full": scalars(imgs)}
    if mode == "subtiles_9x9":
        out["tiles"] = subtile_grids_to_3x3_device(tiled_scalar_fields_device(imgs, n=9, compute_fn=tile_fn))
    elif mode == "tiles_3x3":
        out["tiles"] = {k: {"mean": v} for k, v in tiled_scalar_fields_device(imgs, n=3, compute_fn=tile_fn).items()}
    return out


def _bits(t):
    """The tensor's bit patterns, so that NaNs compare too."""
    return t.contiguous().view(torch.int64 if t.element_size() == 8 else torch.int32)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool((_bits(a) == _bits(b)).all())


@pytest.fixture()
def fresh_graphs():
    """No key sighted or captured before the test, and none left after it."""
    def clear():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        speckles_device._SEEN.clear()
        speckles_device._GRAPHED.clear()
    clear()
    yield
    clear()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["subtiles_9x9", "tiles_3x3", "off"])
@pytest.mark.parametrize("groups", [ALL, frozenset({"grain", "stats"}), frozenset({"amplitude", "bandwidth"})],
                         ids=["all", "grain-stats", "amplitude-bandwidth"])
@pytest.mark.parametrize("flip", [True, False])
def test_reordered_step_gives_the_plain_leaves(mode, groups, flip):
    frames = torch.from_numpy(speckle_stack(2, (300, 288), grain_px=5.0, mean_counts=1000.0, seed=3,
                                            dtype=np.uint16).astype(np.float32))
    int_range = (0, 65535)
    before = dict(speckles_device.GRAPH_COUNTS)
    flat, spec = metric_step(speckle_device_fn(groups, mode, 65535.0, 1e-6), frames, flip=flip,
                             int_range=int_range)
    shown = apply_display_origin(frames, display_origin="lower") if flip else frames
    want, want_spec = pack_leaves(_plain_tree(groups, mode, 65535.0, 1e-6, shown, int_range), 2, frames.dtype)
    assert spec == want_spec
    assert _same_bits(flat, want)
    assert speckles_device.GRAPH_COUNTS["eager_steps"] == before["eager_steps"] + 1
    assert speckles_device.GRAPH_COUNTS["graph_replays"] == before["graph_replays"]


def test_the_reordered_tree_keeps_the_group_order():
    frames = torch.from_numpy(speckle_stack(1, (288, 288), grain_px=5.0, seed=4).astype(np.float64))
    got = speckle_device_fn(ALL, "subtiles_9x9", 65535.0, 1e-6)(frames)
    want = _plain_tree(ALL, "subtiles_9x9", 65535.0, 1e-6, frames, None)
    assert list(got["full"]) == list(want["full"]) == ["amplitude", "grain", "stats", "bandwidth"]
    assert list(got["tiles"]) == list(want["tiles"])


def test_the_cpu_never_captures(fresh_graphs):
    stack = speckle_stack(6, (160, 160), grain_px=5.0, mean_counts=1000.0, seed=6, dtype=np.uint16)
    kw = dict(metrics="all", tiles=False, verbose=False, frame_chunk=2, grain_maps=False, device="cpu")
    for _ in range(2):
        port.speckle_stack_stats(stack, **kw)
        perf = stack_fused.LAST_RUN_PERF
        assert {k: perf[k] for k in GRAPH_KEYS} == {"graph_replays": 0, "graph_captures": 0, "eager_steps": 3}
    before = dict(speckles_device.GRAPH_COUNTS)
    for _ in range(2):
        port.speckle_stats(stack[0], device="cpu", verbose=False)
    assert speckles_device.GRAPH_COUNTS["graph_replays"] == before["graph_replays"]
    assert speckles_device.GRAPH_COUNTS["graph_captures"] == before["graph_captures"]
    assert speckles_device.GRAPH_COUNTS["eager_steps"] == before["eager_steps"] + 2
    assert not speckles_device._GRAPHED and not speckles_device._SEEN


def test_a_foreign_step_runs_eagerly():
    """Any callable that gives a metric tree runs through ``metric_step``,
    eagerly."""
    frames = torch.arange(2 * 16 * 16, dtype=torch.float32).reshape(2, 16, 16)
    flat, spec = metric_step(lambda imgs, int_range=None: {"full": {"m": {"v": imgs[:, 0, :3]}}}, frames,
                             flip=True)
    assert spec == [("full\0m\0v", (2, 3))]
    assert torch.equal(flat, torch.flip(frames, dims=[-2])[:, 0, :3])


@pytest.mark.parametrize("values, dtype", [
    ((0.0005, 0.9995), torch.float64),          # nanpercentiles_exact's levels
    (np.arange(7, dtype=np.int32) + 13.5, torch.float32),  # the tracker's ROI centres
    (np.array([3, -4, 0], np.int64), torch.float32),       # the windowed search's offsets
    ([0, 0, 1, 2], torch.int64),                 # a tile bucket's grid rows
    (0.0, torch.float32),                        # the polar samples' fill value
])
def test_device_constants_equal_the_per_call_uploads(values, dtype):
    got = device_constant(values, dtype, "cpu")
    want = torch.as_tensor(np.asarray(values), dtype=dtype, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _same_bits(got, want)
    assert device_constant(values, dtype, torch.device("cpu")) is got  # built once


def test_the_cores_read_the_constants_they_uploaded():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 64, 64)).astype(np.float32))
    q = nanpercentiles_exact(x, (0.05, 99.95))
    xs = torch.sort(x.flatten(-2), dim=-1).values
    rank = torch.tensor([0.0005, 0.9995], dtype=torch.float64) * (64 * 64 - 1)
    lo, frac = rank.floor().long(), (rank - rank.floor()).to(torch.float32)
    want = xs[:, lo] + frac * (xs[:, lo + 1] - xs[:, lo])
    assert _same_bits(q, want)
    _, r = radial_mean_interpolated_core(x)
    assert _same_bits(r, torch.as_tensor(interpolated_geometry((64, 64), None, None, None)[3], dtype=torch.float32))
    _, rc = radial_mean_binned_core(x)
    assert _same_bits(rc, torch.as_tensor(binned_geometry((64, 64), None, 1.0)[2], dtype=torch.float32))


def test_the_public_radial_axis_is_the_callers_own():
    from barc4dip_tpu_torch.maths.radial import radial_mean_interpolated

    img = np.random.default_rng(1).normal(size=(32, 32))
    _, r = radial_mean_interpolated(img, device="cpu")
    r.mul_(2.0)
    _, again = radial_mean_interpolated(img, device="cpu")
    np.testing.assert_array_equal(again.numpy(), interpolated_geometry((32, 32), None, None, None)[3])


def test_the_tile_grids_fill_every_cell_from_the_cached_indices():
    img = torch.arange(2 * 300 * 288, dtype=torch.float64).reshape(2, 300, 288)
    grids = tiled_scalar_fields_device(img, n=9, compute_fn=lambda b: {"corner": b[..., 0, 0]})
    g = grids["corner"]
    for _, _, positions in tile_plan(300, 288, 9):
        for r, c, y0, x0 in positions:
            assert torch.equal(g[:, r, c], img[:, y0, x0])
    assert not bool(torch.isnan(g).any())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _cuda_frames(dev, n, shape, seed):
    st = speckle_stack(n, shape, grain_px=8.0, mean_counts=8000.0, seed=seed, dtype=np.uint16)
    return to_compute(torch.from_numpy(st).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n, shape, mode, groups, flip", [
    (4, (2048, 2048), "subtiles_9x9", ALL, True),        # Config D's chunk
    (2, (384, 640), "tiles_3x3", frozenset({"grain", "bandwidth"}), False),
])
def test_a_replayed_step_equals_the_eager_step(dev, fresh_graphs, n, shape, mode, groups, flip):
    fn = speckle_device_fn(groups, mode, 65535.0, 1e-6)
    int_range = (0, 65535)
    chunks = [_cuda_frames(dev, n, shape, seed) for seed in (1, 2, 3)]

    def eager(frames):
        shown = apply_display_origin(frames, display_origin="lower") if flip else frames
        return pack_leaves(fn(shown, int_range=int_range), n, frames.dtype)

    before = dict(speckles_device.GRAPH_COUNTS)
    got = [metric_step(fn, f, flip=flip, int_range=int_range) for f in chunks]
    counts = {k: speckles_device.GRAPH_COUNTS[k] - before[k] for k in before}
    assert counts == {"graph_replays": 2, "graph_captures": 1, "eager_steps": 1}
    for (flat, spec), frames in zip(got, chunks):
        want, want_spec = eager(frames)
        assert spec == want_spec
        assert _same_bits(flat, want)
    # a replay's vector is the caller's own: the next replay leaves it alone
    assert not _same_bits(got[1][0], got[2][0])


def _stack_kw(dev, frame_chunk=4):
    return dict(metrics="all", tiles=True, verbose=False, frame_chunk=frame_chunk, grain_maps=False, device=dev)


@pytest.mark.cuda
def test_a_stack_captures_once_and_replays_the_rest(dev, fresh_graphs):
    stack = speckle_stack(100, (512, 512), grain_px=8.0, mean_counts=8000.0, seed=7, dtype=np.uint16)
    counts = []
    for _ in range(2):
        cuda_fftp.reset_counts()
        port.speckle_stack_stats(stack, **_stack_kw(dev))
        perf = stack_fused.LAST_RUN_PERF
        counts.append(({k: perf[k] for k in GRAPH_KEYS}, dict(cuda_fftp.LAUNCHES)))
    assert counts[0][0] == {"graph_replays": 24, "graph_captures": 1, "eager_steps": 1}
    assert counts[1][0] == {"graph_replays": 25, "graph_captures": 0, "eager_steps": 0}
    # K1a on each chunk's frames, K1b on its two banks: every call, replayed or not;
    # 512 rows never take pass 1's cluster route
    assert counts[0][1] == counts[1][1] == {"cols": 75, "rows": 25, "rows_ncc": 50, "cols_cluster": 0}


@pytest.mark.cuda
def test_graphed_trajectories_equal_an_eager_run(dev, fresh_graphs, monkeypatch):
    stack = speckle_stack(24, (512, 512), grain_px=8.0, mean_counts=8000.0, seed=9, dtype=np.uint16)
    port.speckle_stack_stats(stack, **_stack_kw(dev))  # sights the key
    graphed = port.speckle_stack_stats(stack, **_stack_kw(dev))
    assert stack_fused.LAST_RUN_PERF["graph_replays"] == 6
    monkeypatch.setattr(speckles_device, "_graphs_for", lambda *a: None)
    eager = port.speckle_stack_stats(stack, **_stack_kw(dev))
    assert stack_fused.LAST_RUN_PERF["eager_steps"] == 6

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
                yield f"{prefix}{k}", v

    for sec in ("full", "tiles", "temporal"):
        a, b = dict(leaves(graphed[sec])), dict(leaves(eager[sec]))
        assert a.keys() == b.keys() and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{sec}/{k}")


@pytest.mark.cuda
def test_a_tail_chunk_runs_eagerly(dev, fresh_graphs):
    stack = speckle_stack(10, (256, 256), grain_px=8.0, mean_counts=8000.0, seed=5, dtype=np.uint16)
    port.speckle_stack_stats(stack, **_stack_kw(dev))
    perf = stack_fused.LAST_RUN_PERF
    # chunks of 4, 4 and 2: the first sights the key of 4, the second captures it, the tail of 2 is new
    assert {k: perf[k] for k in GRAPH_KEYS} == {"graph_replays": 1, "graph_captures": 1, "eager_steps": 2}


@pytest.mark.cuda
def test_the_single_image_entry_replays_from_its_second_call(dev, fresh_graphs):
    frame = speckle_stack(1, (512, 512), grain_px=8.0, mean_counts=8000.0, seed=3, dtype=np.uint16)[0]
    before = dict(speckles_device.GRAPH_COUNTS)
    outs = [port.speckle_stats(frame, device=dev, verbose=False) for _ in range(3)]
    counts = {k: speckles_device.GRAPH_COUNTS[k] - before[k] for k in before}
    assert counts == {"graph_replays": 2, "graph_captures": 1, "eager_steps": 1}
    for out in outs[1:]:
        for g, fields in outs[0]["full"].items():
            for k, v in fields.items():
                if isinstance(v, float):
                    assert v == out["full"][g][k] or (math.isnan(v) and math.isnan(out["full"][g][k])), (g, k)
