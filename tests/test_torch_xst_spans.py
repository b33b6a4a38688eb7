# SPDX-License-Identifier: CECILL-2.1
"""The XST path's spans and counters, read from a CPU ``torch.profiler``
Chrome trace: the flat-field's ``ffc.calib`` (with ``config.upload``'s
``upload`` inside it, one a raw flat or dark frame), ``ffc.upload`` (with an
``upload`` inside it for each chunk of the images) and ``k2`` inside
``entry.flat_field_correction``; the wavefront scan's
``entry.track_displacement_stack``, ``xst.batch`` (one a batch), ``k3`` (one
a K3 call), ``pull.wait`` (one a batch) and ``xst.integrate`` inside
``entry.wavefront_scan``; ``normalize.LAST_RUN_PERF`` and
``xst.LAST_RUN_PERF`` reset for each call and carrying their keys; and the
same outputs, bit for bit, with and without a profiler."""
import json

import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.models import WavefrontScanPipeline
from barc4dip_tpu_torch.preprocessing import normalize
from barc4dip_tpu_torch.signal import xst
from barc4dip_tpu_torch.utils import speckle_field

torch.set_num_threads(2)
SIDE, T = 128, 5
GEOMETRY = dict(tile_size=17, step=8, search_radius=4, method="pallas")  # K3's plain version on the CPU
BATCHES = 2  # 5 frames in batches of 4 (the last one padded)

rng = np.random.default_rng(11)
BASE = speckle_field((SIDE + 8, SIDE + 8), grain_px=3.0, mean_counts=2000.0, seed=12)
RAW = np.stack([BASE[4 + t % 3:4 + t % 3 + SIDE, 4:4 + SIDE] for t in range(T + 1)]).astype(np.uint16) + 100
FLATS = (2000.0 + rng.normal(0, 3, size=(2, SIDE, SIDE))).astype(np.uint16)
DARKS = (100.0 + rng.normal(0, 2, size=(2, SIDE, SIDE))).astype(np.uint16)
FLATS[:, 5, 7] = 90  # a dead pixel


def scan():
    kw = dict(flats=FLATS, darks=DARKS, bad_pixel_removal=True, as_numpy=False, device="cpu")
    ref = normalize.flat_field_correction(RAW[0], **kw)
    stack = normalize.flat_field_correction(RAW[1:], **kw)
    out = WavefrontScanPipeline(pixel_size=1e-6, distance=0.5, wavelength=1e-10, device="cpu", **GEOMETRY)(stack, ref)
    return {"ref": ref, "stack": stack, **{k: out[k] for k in ("dy", "dx", "peak", "wavefront", "phase")}}


def _spans(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = scan()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    raw = sorted((e["ts"], -(e["ts"] + e["dur"]), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    spans, stack = [], []
    for ts, neg_end, name in raw:  # one thread: the innermost open span is the parent
        while stack and stack[-1][1] <= ts:
            stack.pop()
        spans.append((ts, -neg_end, name, stack[-1][0] if stack else None))
        stack.append((name, -neg_end))
    return spans, out


#: the images' chunks: the reference is one, the T-frame stack T / 4 rounded up
IMAGE_CHUNKS = 1 + -(-T // normalize.UPLOAD_CHUNK_FRAMES)

#: (span, its parent) -> how many a scan holds
EXPECTED = {
    ("entry.flat_field_correction", None): 2,
    ("ffc.calib", "entry.flat_field_correction"): 2,
    ("upload", "ffc.calib"): 2 * (FLATS.shape[0] + DARKS.shape[0]),  # one a raw flat or dark frame
    ("ffc.upload", "entry.flat_field_correction"): 2,
    ("upload", "ffc.upload"): IMAGE_CHUNKS,  # one a chunk of raw image frames
    ("k2", "entry.flat_field_correction"): 2,
    ("entry.wavefront_scan", None): 1,
    ("entry.track_displacement_stack", "entry.wavefront_scan"): 1,
    ("xst.batch", "entry.track_displacement_stack"): BATCHES,
    ("k3", "xst.batch"): BATCHES,
    ("pull.wait", "entry.track_displacement_stack"): BATCHES,
    ("xst.integrate", "entry.wavefront_scan"): 1,
}


def test_each_span_nests_in_its_entry_once_a_call_or_batch(tmp_path):
    assert T % normalize.UPLOAD_CHUNK_FRAMES != 0  # a short last chunk
    spans, _ = _spans(tmp_path)
    pairs = [(name, parent) for _, _, name, parent in spans]
    assert set(pairs) == set(EXPECTED)
    for pair, count in EXPECTED.items():
        assert pairs.count(pair) == count, pair
    roots = [(s, e) for s, e, _, parent in spans if parent is None]
    for s, e, name, parent in spans:
        if parent is not None:
            assert sum(r0 <= s and e <= r1 for r0, r1 in roots) == 1, name


def test_counters_are_reset_for_each_call_and_carry_their_keys():
    normalize.flat_field_correction(RAW, flats=FLATS, darks=DARKS, device="cpu")
    perf = dict(normalize.LAST_RUN_PERF)
    assert set(perf) == {"calib_s", "calib_bytes", "calib_device_frames", "upload_s", "upload_device_frames"}
    assert perf["calib_bytes"] == FLATS.nbytes + DARKS.nbytes and perf["calib_s"] > 0 and perf["upload_s"] > 0
    assert perf["calib_device_frames"] == FLATS.shape[0] + DARKS.shape[0]
    assert perf["upload_device_frames"] == RAW.shape[0]
    normalize.flat_field_correction(RAW[0], flats=FLATS[0], device="cpu")
    assert normalize.LAST_RUN_PERF["calib_bytes"] == FLATS[0].nbytes
    assert normalize.LAST_RUN_PERF["calib_device_frames"] == 0
    assert normalize.LAST_RUN_PERF["upload_device_frames"] == 1
    normalize.flat_field_correction(torch.from_numpy(RAW), flats=FLATS[0], device="cpu")
    assert normalize.LAST_RUN_PERF["upload_device_frames"] == 0

    scan()
    perf = dict(xst.LAST_RUN_PERF)
    assert set(perf) == {"batches", "frames", "pull_wait_s", "integrate_s"}
    assert perf["batches"] == BATCHES and perf["frames"] == T and perf["pull_wait_s"] > 0 and perf["integrate_s"] > 0
    xst.track_displacement_field(RAW[1].astype(np.float32), RAW[0].astype(np.float32), device="cpu", **GEOMETRY)
    assert xst.LAST_RUN_PERF == {**xst.LAST_RUN_PERF, "batches": 1, "frames": 1, "integrate_s": 0.0}
    xst.track_displacement_stack(RAW[1:4].astype(np.float32), RAW[0], device="cpu", frame_batch=1, **GEOMETRY)
    assert (xst.LAST_RUN_PERF["batches"], xst.LAST_RUN_PERF["frames"]) == (3, 3)


@pytest.mark.parametrize("profiled_first", [True, False])
def test_outputs_are_equal_with_and_without_a_profiler(profiled_first, tmp_path):
    def traced():
        return _spans(tmp_path)[1]

    first, second = (traced(), scan()) if profiled_first else (scan(), traced())
    assert set(first) == set(second)
    for k in first:
        a, b = (np.asarray(x) for x in (first[k], second[k]))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
