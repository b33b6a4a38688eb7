# SPDX-License-Identifier: CECILL-2.1
"""The raw XST wavefront scan cell of the benchmark (``xst_2k.scan32``) on the
CPU at a small size: the port against the plain reference
(``perfbench/reference/xst.py``) stage by stage, the whole cell's
``correct`` with and without planted faults, the pool's determinism, the
reference's imports and the cell's four per-layer readers.

Small size: 160^2 frames, 3 frames a scan, 2 flats, 2 darks, 1% dead
pixels, tile 17, step 8, radius 4; a wavefront of R = 20 m, whose slopes
at 160^2 stand out of the tracking's noise as R = 100 m does at 2048^2."""
import ast
import json
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.maths import integrate_gradients
from barc4dip_tpu_torch.preprocessing import normalize
from barc4dip_tpu_torch.signal import xst
from perfbench import run
from perfbench.reference import xst as ref_xst
from perfbench.reference.common import Precision
from perfbench.trace import Trace

torch.set_num_threads(2)
CELL = "xst_2k.scan32"
SEED = 2**33 + 19
GEOMETRY = dict(tile_size=17, step=8, search_radius=4)
F64 = Precision("float64")


def small_args():
    args = json.loads(json.dumps(run.load_cell(CELL)["traffic"]["args"]))
    args["pipeline"].update(GEOMETRY)
    return args


OVERRIDES = {"detector": {"height": 160, "width": 160},
             "calibration": {"flats": 2, "darks": 2, "dead_fraction": 0.01},
             "optics": {"radius_m": 20.0}}
TRAFFIC = {"frames": 3, "pool": 2, "warmup_calls": 1, "trace": {"plain": 1, "attributed": 1}}


def small_cell():
    spec = run.load_cell(CELL)
    config, traffic = spec["config"], spec["traffic"]
    for key, val in OVERRIDES.items():
        config[key].update(val)
    traffic.update(TRAFFIC, args=small_args())
    return config, traffic


def small_pool(seed=SEED):
    config, traffic = small_cell()
    return run.load_module("gen", "xst_scan").make_pool(seed, config, traffic, torch.device("cpu"))


@pytest.fixture(scope="module")
def pool():
    return small_pool()


def tiny_run(**kw):
    return run.run_cell(CELL, SEED, 0.0, False, "cpu",
                        overrides={**OVERRIDES, "traffic": {**TRAFFIC, "args": small_args()}}, **kw)


def port_ffc(item, raw, **kw):
    return normalize.flat_field_correction(raw, flats=item["flats"], darks=item["darks"], device="cpu",
                                           as_numpy=False, **kw)


def reference_ffc(item):
    cal = ref_xst.calibration(item["flats"], item["darks"], F64, "cpu")
    return cal, ref_xst.flat_field(item["stack"], cal, F64, "cpu")["frames"], ref_xst.flat_field(
        item["ref"], cal, F64, "cpu")["frames"]


# -- the port against the reference, stage by stage ---------------------------------


def test_flat_field_matches_the_reference(pool):
    """float32 against float64: a handful of rounded operations on values
    of a few thousand counts, each within 2^-24 of its own size, and the
    medians of float32 values; 1e-5 of the image's median magnitude leaves
    ten times the room of their sum. The bad mask is exact: the port's zeroed
    pixels without the repair are the reference's bad pixels, which are the
    dead pixels the generator made."""
    for item in pool:
        cal, want, _ = reference_ffc(item)
        got = port_ffc(item, item["stack"], bad_pixel_removal=True, scale="flat_median").double()
        scale = float(want.abs().median())
        assert float((got - want).abs().max()) <= 1e-5 * scale
        zeroed = port_ffc(item, item["stack"], bad_pixel_removal=False, scale="flat_median")
        np.testing.assert_array_equal((zeroed == 0).all(0).numpy(), cal["bad"].numpy())
        np.testing.assert_array_equal(cal["bad"].numpy(), item["dead"])


@pytest.mark.parametrize("method", ["pallas", "fft"])
def test_tracking_matches_the_reference(pool, method):
    """The same integer peak at every node (subpixel off, exact), and
    subpixel fields within 1e-4 px: float32 sums move an NCC value near the
    peak by ~1e-6, which the Newton step divides by a curvature of order
    0.1 to 1, so ~1e-5 px, and ten times that is left. ``pallas`` is K3's
    plain version here."""
    item = pool[0]
    _, frames, ref = reference_ffc(item)
    for subpixel in (False, True):
        want = ref_xst.track(frames, ref, F64, tile=17, step=8, radius=4, subpixel=subpixel)
        got = xst.track_displacement_stack(frames.float(), ref.float(), method=method, subpixel=subpixel,
                                           device="cpu", **GEOMETRY)
        if not subpixel:
            np.testing.assert_array_equal(got["dy"], want["dy"])
            np.testing.assert_array_equal(got["dx"], want["dx"])
        else:
            for k in ("dy", "dx"):
                assert np.abs(got[k] - want[k]).max() <= 1e-4, k
        assert np.abs(got["peak"] - want["peak"]).max() <= 1e-5


def test_integration_matches_float64():
    """The same least squares in float64 on both sides: within 1e-12 of
    the largest height."""
    rng = np.random.default_rng(3)
    gy, gx = rng.normal(size=(2, 3, 24, 20))
    want = ref_xst.integrate(gy, gx, 0.5, F64)
    for t in range(3):
        got = integrate_gradients(gy[t], gx[t], dy=0.5, dx=0.5).numpy()
        assert np.abs(got - want[t]).max() <= 1e-12 * np.abs(want[t]).max()


def test_reference_median_and_neighbourhoods_match_scipy():
    from scipy.ndimage import median_filter

    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 9, 7)))
    want = median_filter(x.numpy(), size=(1, 3, 3), mode="reflect")
    np.testing.assert_array_equal(ref_xst.median3x3(x).numpy(), want)
    idx = torch.tensor([0, 6, 31, 62])
    nb = ref_xst.neighbourhoods(x, idx).sort(-1).values[..., 4]
    np.testing.assert_array_equal(nb.numpy(), ref_xst.median3x3(x).reshape(2, -1)[:, idx].numpy())


# -- the whole cell ---------------------------------------------------------------


def test_the_cell_is_correct_on_the_cpu():
    line = tiny_run()
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == set(run.load_cell(CELL)["traffic"]["limits"])
    assert line["checks"]["repair_misses"]["value"] == 0 and line["checks"]["node_moved_pct"]["value"] == 0


def _moved_frame(orig):
    def track(*a, **kw):
        out = orig(*a, **kw)
        out["dy"] = out["dy"].copy()
        out["dy"][1] += 1.0
        return out
    return track


def _ffc_with(**changed):
    orig = normalize.flat_field_correction

    def ffc(images, **kw):
        return orig(images, **{**kw, **changed})
    return ffc


FAULTS = {
    "one frame's field moved by 1 px": (xst, "track_displacement_stack",
                                        lambda: _moved_frame(xst.track_displacement_stack)),
    "the darks ignored": (normalize, "flat_field_correction", lambda: _ffc_with(darks=None)),
    "the repair skipped": (normalize, "flat_field_correction", lambda: _ffc_with(bad_pixel_removal=False)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_refused(fault, monkeypatch):
    module, name, make = FAULTS[fault]
    monkeypatch.setattr(module, name, make())
    line = tiny_run()
    assert line["failed"] == 0 and line["correct"] is False


def test_the_bfloat16_control_is_refused(pool):
    config, traffic = small_cell()
    entry = run.load_module("entries", "wavefront_scan")
    numbers = entry.control(pool, traffic["args"], "cpu", Precision("bfloat16"), random.Random(1), config)
    limits = traffic["limits"]
    assert set(numbers) == set(limits)
    assert any(not np.isfinite(v) or v > limits[n] for n, v in numbers.items()), numbers


def test_the_pool_is_the_same_for_one_seed(pool):
    again, other = small_pool(), small_pool(SEED + 1)
    for a, b, c in zip(pool, again, other):
        for key in ("ref", "stack", "flats", "darks", "dead"):
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
        assert torch.equal(a["sample"], b["sample"])
        assert a["ref"].tobytes() != c["ref"].tobytes()
    item = pool[0]
    assert item["stack"].dtype == item["flats"].dtype == np.uint16 and item["stack"].shape == (3, 160, 160)
    assert set(item["dead"].flatten().nonzero()[0]) <= set(item["sample"].tolist())


def test_the_frames_move_as_the_truth_says(pool):
    """Without noise the generator's frame equals the reference's field
    evaluated at p - d(p), and at d = 0 its own field: the move is exact."""
    gen = run.load_module("gen", "xst_scan")
    spec = torch.fft.fft2(torch.from_numpy(np.random.default_rng(5).normal(size=(16, 12))).to(torch.complex128))
    spec[8, :] = 0
    spec[:, 6] = 0
    py, px = torch.arange(16.0, dtype=torch.float64), torch.arange(12.0, dtype=torch.float64)
    np.testing.assert_allclose(gen.field_at(spec, py, px).numpy(), torch.fft.ifft2(spec).numpy(), atol=1e-12)
    whole = gen.field_at(spec, py + 3.0, px - 2.0).numpy()
    np.testing.assert_allclose(whole, np.roll(torch.fft.ifft2(spec).numpy(), (-3, 2), axis=(0, 1)), atol=1e-12)


def test_the_reference_loads_neither_jax_nor_the_port():
    path = run.BENCH / "reference" / "xst.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
            [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n.split(".")[0] in ("barc4dip_tpu_torch",) + run.FORBIDDEN for n in names)
    code = (f"import sys; sys.path.insert(0, {str(run.ROOT)!r}); import perfbench.reference.xst; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', 'barc4dip_tpu', "
            "'barc4dip_tpu_torch'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr[-2000:]


# -- the per-layer readers ---------------------------------------------------------


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


PORT = "/x/barc4dip_tpu_torch"
EVENTS = [
    _ev("user_annotation", "perfbench.window", 0, 1000),
    _ev("python_function", f"{PORT}/ops/densetrack.py(150): _pallas_corr", 100, 200),
    _ev("python_function", f"{PORT}/ops/rank.py(17): median_filter2d", 400, 100),
    _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 600, 5, corr=3),
    _ev("kernel", "densetrack_sums", 120, 400, corr=1),
    _ev("kernel", "median3x3", 530, 50, corr=2),
    _ev("kernel", "other", 700, 100, corr=3),
]


def _record(tr, calls=()):
    config, traffic = run.load_cell(CELL)["config"], run.load_cell(CELL)["traffic"]
    return {"plain": tr, "attributed": tr, "calls": list(calls), "config": config, "traffic": traffic, "log": print}


def test_roofline_readers_on_a_synthetic_trace():
    tr = Trace(EVENTS, frames=32, calls=1)
    k3 = run.load_module("layer_metrics", "k3_roofline_pct")
    k2 = run.load_module("layer_metrics", "k2_roofline_pct")
    assert k3.nodes(2048, 2048, 33, 10, 16) == 125 * 125
    nbytes, flops = k3.frame_work(2048, 2048, 33, 10, 16)
    assert flops == 2.0 * 15625 * 441 * 1089
    assert k3.read(_record(tr)) == pytest.approx(100 * max(32 * flops / 67e12, 32 * nbytes / 3.35e12) / 400e-6)
    assert k2.read(_record(tr)) == pytest.approx(100 * 33 * 2048 * 2048 * 8 / 3.35e12 / 50e-6)
    bare = Trace(EVENTS[:1] + EVENTS[3:], frames=32, calls=1)
    assert k3.read(_record(bare)) is None and k2.read(_record(bare)) is None


@pytest.mark.parametrize("metric,key", [("calib_host_pct", "calib_s"), ("ffc_upload_pct", "upload_s")])
def test_counter_readers(metric, key):
    reader = run.load_module("layer_metrics", metric)
    calls = [{"seconds": 2.0, "profiled": False, "counters": {key: 0.5}},
             {"seconds": 9.0, "profiled": True, "counters": {key: 9.0}},
             {"seconds": 2.0, "profiled": False, "counters": {key: 1.5}}]
    assert reader.read(_record(None, calls)) == pytest.approx(50.0)
    # the parent's port carries no counter: no reading, and no error
    assert reader.read(_record(None, [{"seconds": 2.0, "profiled": False, "counters": None}])) is None
