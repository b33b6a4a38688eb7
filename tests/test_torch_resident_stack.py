# SPDX-License-Identifier: CECILL-2.1
"""Config D on a float32 stack that already lies on its device: a tensor
stack runs the chunk loop's resident route, a numpy stack the upload route,
and on the same values the two give the same leaves, bit for bit (every
``full``, ``tiles`` and ``temporal`` leaf and a lazy grain map). The
resident route counts its frames in ``resident_frames`` and uploads nothing;
each of its loads is a ``load.resident`` span, and frame 0's pull to the
host for the ROI grid's sizing a ``frame0.pull`` span, in a CPU trace.

Small size: 6 frames of 256^2 (whole counts plus a uniform offset, as
calibrated frames), chunks of 4, 9x9 subtiles of 28 px (``MIN_TILE_PX``
lowered by monkeypatch)."""
import json

import numpy as np
import pytest
import torch

import barc4dip_tpu_torch as port
from barc4dip_tpu_torch.metrics import speckles, stack_fused
from barc4dip_tpu_torch.utils import speckle_stack

torch.set_num_threads(2)
T, SIDE, CHUNK = 6, 256, 4
KW = dict(metrics="all", tiles=True, frame_chunk=CHUNK, verbose=False)
COUNTS = speckle_stack(T, (SIDE, SIDE), grain_px=4.0, mean_counts=8000.0, seed=25, dtype=np.uint16)
HOST = COUNTS.astype(np.float32) + np.random.default_rng(25).uniform(-0.5, 0.5, COUNTS.shape).astype(np.float32)
CHUNKS = -(-T // CHUNK)


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(speckles, "MIN_TILE_PX", 28)
        host = port.speckle_stack_stats(HOST, device="cpu", **KW)
        host_perf = dict(stack_fused.LAST_RUN_PERF)
        resident = port.speckle_stack_stats(torch.from_numpy(HOST.copy()), **KW)
        resident_perf = dict(stack_fused.LAST_RUN_PERF)
    return host, host_perf, resident, resident_perf


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("section", ["full", "tiles", "temporal"])
def test_the_tensor_route_gives_the_numpy_routes_leaves(runs, section):
    host, _, resident, _ = runs
    want = {k: v for k, v in _leaves(host[section]) if k != "grain/autocorr"}
    got = {k: v for k, v in _leaves(resident[section]) if k != "grain/autocorr"}
    assert got.keys() == want.keys() and got
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=f"{section}/{k}")
        else:
            assert got[k] == v, k


def test_the_values_are_not_whole_counts_and_the_tiles_are_subtiles(runs):
    assert HOST.dtype == np.float32 and np.mean(HOST != np.round(HOST)) > 0.99
    # 9x9 subtiles pooled into 3x3: a spread over each 3x3 block of subtiles
    std = runs[2]["tiles"]["stats"]["mean"]["std"]
    assert std.shape == (T, 3, 3) and np.isfinite(std).all()


def test_a_lazy_grain_map_is_the_numpy_routes(runs):
    host, _, resident, _ = runs
    for t in (0, T - 1):
        np.testing.assert_array_equal(resident["full"]["grain"]["autocorr"][t], host["full"]["grain"]["autocorr"][t])


def test_the_resident_route_counts_its_frames_and_uploads_nothing(runs):
    _, host_perf, _, resident_perf = runs
    assert resident_perf["resident"] is True and resident_perf["resident_frames"] == T
    assert resident_perf["upload_bytes"] == 0 and resident_perf["upload_s"] == 0.0
    assert resident_perf["chunks"] == CHUNKS
    assert "resident" not in host_perf and host_perf["resident_frames"] == 0
    assert host_perf["upload_bytes"] == HOST.nbytes


def _spans(tmp_path, call):
    """[(name, parent)] of the program's spans in a CPU trace of ``call()``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    raw = sorted((e["ts"], -(e["ts"] + e["dur"]), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    spans, stack = [], []
    for ts, neg_end, name in raw:  # one thread: the innermost open span is the parent
        while stack and stack[-1][1] <= ts:
            stack.pop()
        spans.append((name, stack[-1][0] if stack else None))
        stack.append((name, -neg_end))
    return spans


def test_the_resident_route_has_its_spans(tmp_path):
    stack = torch.from_numpy(HOST.copy())
    kw = dict(KW, tiles=False, grain_maps=False)
    spans = _spans(tmp_path, lambda: port.speckle_stack_stats(stack, **kw))
    # a chunk's load, and in the first chunk frame 0 and frame 0's predecessor (itself) for the tracker
    assert [p for n, p in spans if n == "load.resident"] == ["chunk"] * (CHUNKS + 2)
    assert [p for n, p in spans if n == "frame0.pull"] == ["entry.frame0"]
    assert "upload" not in {n for n, _ in spans}
    # a host stack takes neither span
    names = {n for n, _ in _spans(tmp_path, lambda: port.speckle_stack_stats(HOST, device="cpu", **kw))}
    assert "upload" in names and not names & {"load.resident", "frame0.pull"}
