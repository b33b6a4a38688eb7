"""Each entry's reference computes what the program computes: the plain
reference against ``barc4dip_tpu_torch`` on the CPU at a tiny size, on
float64 frames (the port keeps float64), so that any gap beyond round-off
is a difference of definition. On the card the reference is not held to
the port's code: it runs in float64 against the port's float32."""
import numpy as np
import pytest
import torch

import barc4dip_tpu_torch as port
from perfbench import compare
from perfbench.entries import sharpness_report, sharpness_stack_stats, speckle_stack_stats, speckle_stats
from perfbench.gen import speckle as gen
from perfbench.reference.common import Precision
from perfbench.reference import tracking
from perfbench.reference.speckle import grain_map

CPU = torch.device("cpu")
F64 = Precision("float64")
TIGHT = 1e-9


def stack(side, T=3, seed=11, grain=8.0):
    dys, dxs = gen.spiral(T, 0.35, 0.7)
    data = gen.speckle_stack(gen.generator(seed, CPU), T, side, side, grain_px=grain, mean_counts=8000.0,
                             dys=dys, dxs=dxs, device=CPU)
    return {"data": data, "truth": {"dy": dys, "dx": dxs}}


def gaps(prog, ref):
    assert set(ref) <= set(prog)
    return max(float(v.max()) for v in compare.value_gaps(prog, ref).values())


@pytest.mark.parametrize("side", [384, 1152])  # 3x3 tiles; 9x9 subtiles (128 px)
def test_speckle_stats_reference(side):
    item = {"data": stack(side, T=1)["data"][0].astype(np.float64)}
    out = port.speckle_stats(item["data"], verbose=False, device="cpu")
    assert gaps(compare.program_leaves(out), speckle_stats.reference(item, {"tiles": True}, CPU, F64)) < TIGHT
    got = np.asarray(out["full"]["grain"]["autocorr"])
    assert np.max(np.abs(got - grain_map(F64.frames(item["data"], CPU), F64))) < TIGHT


def test_speckle_stack_stats_reference_and_truth():
    item = stack(384, T=5)
    args = {"metrics": "all", "tiles": True, "frame_chunk": 2, "verbose": False}
    out = port.speckle_stack_stats(item["data"].astype(np.float64), device="cpu", **args)
    ref = speckle_stack_stats.reference(item, args, CPU, F64)
    assert gaps(compare.program_leaves(out), ref) < TIGHT
    assert speckle_stack_stats.truth_gap(out, item["truth"]) < 0.05
    track = tracking.temporal(tracking.track_stack(item["data"], CPU, F64))
    assert out["meta"]["tracking"]["roi_size_yx"][0] == tracking.roi_grid(F64.frames(item["data"][0], CPU), F64, 3.0, 0.5)[1]
    assert speckle_stack_stats.track_gap(out["temporal"], track) < 1e-6  # the result is float32
    got = np.asarray(out["full"]["grain"]["autocorr"][3])
    assert np.max(np.abs(got - grain_map(F64.frames(item["data"][3], CPU), F64))) < TIGHT


def test_sharpness_report_reference():
    item = {"data": stack(384, T=1, grain=4.0)["data"][0].astype(np.float64)}
    out = sharpness_report.call(port, item, {"verbose": False}, "cpu")
    ref = sharpness_report.reference(item, {}, CPU, F64)
    assert gaps(compare.program_leaves(out["stats"]), ref) < TIGHT
    assert sharpness_report.summary_values(out["report"])
    assert sharpness_report.report_misses(out["report"], ref, 1e-6) == 0


def test_sharpness_stack_stats_reference_and_best_frame():
    config = {"detector": {"height": 256, "width": 256},
              "content": {"grain_px": 4.0, "mean_counts": 1000.0, "blur_sigma_step_px": 0.8}}
    (item,) = gen.make_pool(3, config, {"input": "focus_scan", "frames": 7, "pool": 1}, CPU)
    item = {**item, "data": item["data"].astype(np.float64)}
    args = {"metrics": "gradient,laplacian,spectral", "tiles": False, "verbose": False}
    out = port.sharpness_stack_stats(item["data"], device="cpu", **args)
    ref = sharpness_stack_stats.reference(item, args, CPU, F64)
    got = compare.program_leaves(out)
    assert gaps(got, ref) < TIGHT
    assert sharpness_stack_stats.best_frame(got) == sharpness_stack_stats.best_frame(ref) == 3


def test_a_report_that_prints_another_number_is_a_miss():
    ref = {"full/gradient/tenengrad": np.array([1234.5]), "full/gradient/ex": np.array([600.0])}
    assert sharpness_report.report_misses("> tenengrad: 1234.5 | ex: 600.0", ref, 1e-6) == 0
    assert sharpness_report.report_misses("> tenengrad: 1234.5 | ex: 600.4", ref, 1e-6) == 1


def test_gaps_are_judged_in_each_fields_units():
    ref = {"full/stats/skewness": np.array([2.0, 0.0]), "tiles/stats/skewness/mean": np.zeros((2, 3, 3)) + 2.0,
           "tiles/stats/skewness/std": np.zeros((2, 3, 3)) + 0.01, "full/stats/SNRdB": np.array([0.1, -0.1])}
    prog = {k: v.copy() for k, v in ref.items()}
    prog["full/stats/skewness"][1] = 2e-6  # judged against the field's scale (2), not against 0
    prog["tiles/stats/skewness/std"][0, 0, 0] += 2e-6
    prog["full/stats/SNRdB"][0] += 20 / np.log(10) * 1e-6  # 1e-6 relative of std/mean
    assert gaps(prog, ref) == pytest.approx(1e-6)
    prog["full/stats/SNRdB"][1] = np.nan
    assert compare.value_gaps(prog, ref)["full/stats/SNRdB"][1] == np.inf


def test_discrete_field_counts_moved_values():
    ref = {"full/bandwidth/f95": np.array([0.1, 0.1, 0.1, 0.1]), "full/bandwidth/feq": np.ones(4)}
    prog = {"full/bandwidth/f95": np.array([0.1, 0.1, 0.1, 0.1001]), "full/bandwidth/feq": np.ones(4)}
    n = compare.judge([(prog, ref)])
    assert n["f95_moved_pct"] == 25.0 and n["leaf_gap"] == 0.0
