"""The comparison refuses what it has to refuse. Each test drives a whole run
of a cell on the CPU at a tiny size (the harness's look for a card is
skipped) with the timed path broken underneath, and sees ``correct`` come
out false: an answer altered where it is produced; half of a batch left out
and the mean of the rest taken in its place; a step that returns its state
unchanged (the cells that carry state from chunk to chunk). No cell runs
across chips, so none can leave an exchange out. Then the control: the
reference, computed in the precision below the program's, put in the
program's place, fails the cell's limits."""
import random

import numpy as np
import pytest
import torch

from barc4dip_tpu_torch.metrics import sharpness, speckles, speckles_device, stack_fused
from perfbench import run
from perfbench.reference.common import Precision

from .test_perfbench_line import SMALL, TINY, tiny_run

SPECKLE = ("speckle_2k.stack100", "speckle_2k.image")
SHARP = ("sharpness_2k.image", "sharpness_2k.scan11")


def alter(fn, group, field):
    """``fn``'s metric step with one value moved by a part in a hundred."""
    def step(*a, **kw):
        out = fn(*a, **kw)
        out["full"][group][field] = out["full"][group][field] * 1.01
        return out
    return step


def halve(fn):
    """``fn``'s metric step on the first half of the batch, the rest of the
    batch given the mean of that half."""
    def step(imgs, *a, **kw):
        b = imgs.shape[0]
        out = fn(imgs[: max(1, b // 2)], *a, **kw)

        def fill(v):
            if isinstance(v, dict):
                return {k: fill(x) for k, x in v.items()}
            return torch.cat([v, v.mean(0, keepdim=True).expand(b - v.shape[0], *v.shape[1:])])
        return fill(out)
    return step


def mean_over_half(grids: dict) -> dict:
    """3x3 pooling of 9x9 subtiles over the first half of each block."""
    out = {}
    for k, g in grids.items():
        blocks = g.reshape(*g.shape[:-2], 3, 3, 3, 3).transpose(-3, -2).reshape(*g.shape[:-2], 3, 3, 9)[..., :4]
        out[k] = {"mean": blocks.mean(-1), "std": blocks.std(-1, correction=0)}
    return out


def over(line, number):
    c = line["checks"][number]
    return not c["value"] <= c["limit"]


SUBTILES = {"detector": {"height": 1152, "width": 1152}}  # 9x9 subtiles of 128 px


def speckle_fn(patch):
    def make(*a, **kw):
        return patch(orig_speckle_fn(*a, **kw))
    return make


orig_speckle_fn = speckles_device.speckle_device_fn
orig_sharp_fn = sharpness._sharpness_device_fn


@pytest.mark.parametrize("cell", SPECKLE)
def test_an_altered_speckle_answer_is_refused(cell, monkeypatch):
    fn = speckle_fn(lambda f: alter(f, "amplitude", "visibility"))
    monkeypatch.setattr(speckles, "speckle_device_fn", fn)
    monkeypatch.setattr(stack_fused, "speckle_device_fn", fn)
    assert tiny_run(cell)["correct"] is False


@pytest.mark.parametrize("cell", SHARP)
def test_an_altered_sharpness_answer_is_refused(cell, monkeypatch):
    monkeypatch.setattr(sharpness, "_sharpness_device_fn",
                        lambda *a, **kw: alter(orig_sharp_fn(*a, **kw), "gradient", "tenengrad"))
    assert tiny_run(cell)["correct"] is False


def test_an_altered_trajectory_is_refused(monkeypatch):
    orig = stack_fused._refine
    monkeypatch.setattr(stack_fused, "_refine", lambda *a, **kw: tuple(v + 0.1 for v in orig(*a, **kw)))
    line = tiny_run("speckle_2k.stack100")
    assert line["correct"] is False and over(line, "track_gap_px") and over(line, "spiral_gap_px")


def test_half_of_a_chunk_is_refused(monkeypatch):
    fn = speckle_fn(halve)
    monkeypatch.setattr(stack_fused, "speckle_device_fn", fn)
    assert tiny_run("speckle_2k.stack100")["correct"] is False


def test_half_of_a_scan_chunk_is_refused(monkeypatch):
    monkeypatch.setattr(sharpness, "_sharpness_device_fn", lambda *a, **kw: halve(orig_sharp_fn(*a, **kw)))
    assert tiny_run("sharpness_2k.scan11")["correct"] is False


@pytest.mark.parametrize("cell", ["speckle_2k.image", "sharpness_2k.image"])
def test_half_of_the_subtiles_is_refused(cell, monkeypatch):
    monkeypatch.setattr(speckles_device, "subtile_grids_to_3x3_device", mean_over_half)
    monkeypatch.setattr(sharpness, "subtile_grids_to_3x3_device", mean_over_half)
    line = run.run_cell(cell, 2**33 + 3, 0.0, False, "cpu",
                        overrides={**SUBTILES, "traffic": {**TINY[cell], "pool": 1}})
    assert line["correct"] is False


def test_a_stale_tracking_reference_is_refused(monkeypatch):
    """The incremental reference is not moved on: every frame of a chunk is
    tracked against the frame before the chunk."""
    orig = stack_fused._track_chunk
    monkeypatch.setattr(stack_fused, "_track_chunk",
                        lambda frames, prevs, *a: orig(frames, prevs[:1].expand_as(prevs), *a))
    line = tiny_run("speckle_2k.stack100")
    assert line["correct"] is False and over(line, "track_gap_px") and over(line, "spiral_gap_px")


def test_a_scan_chunk_that_returns_the_last_state_is_refused(monkeypatch):
    """Each chunk of the scan's loop returns the first chunk's results."""
    orig = sharpness.run_stack_program

    def stale(stack, program, **kw):
        first = {}

        def step(frames):
            if not first:
                first["out"] = program(frames)
            return first["out"]
        return orig(stack, step, **kw)

    monkeypatch.setattr(sharpness, "run_stack_program", stale)
    cell = "sharpness_2k.scan11"
    line = run.run_cell(cell, 2**33 + 3, 0.0, False, "cpu",
                        overrides={**SMALL, "traffic": {**TINY[cell], "frames": 8,
                                                        "args": {**run.load_cell(cell)["traffic"]["args"],
                                                                 "frame_chunk": 4}}})
    assert line["correct"] is False


def test_a_tracker_that_loses_a_tenth_of_a_pixel_on_one_roi_is_refused(monkeypatch):
    """One ROI of nine read 0.1 px off, on every frame: the spiral, whose
    truth the estimator's own bias blurs, may let it pass; the reference
    tracker does not."""
    orig = stack_fused._refine

    def refine(*a, **kw):
        py, px = orig(*a, **kw)
        return py, px + 0.1 * (torch.arange(py.shape[-1]) == 4).to(px.dtype)

    monkeypatch.setattr(stack_fused, "_refine", refine)
    line = tiny_run("speckle_2k.stack100")
    assert line["correct"] is False and over(line, "track_gap_px")


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_refused(cell):
    """The reference in bfloat16 in the program's place reads over at least
    one limit."""
    spec = run.load_cell(cell)
    traffic = {**spec["traffic"], **TINY[cell]}
    config = {**spec["config"], "detector": {**spec["config"]["detector"], **SMALL["detector"]}}
    pool = run.load_module("gen", traffic["input"]).make_pool(2**33 + 9, config, traffic, torch.device("cpu"))
    entry = run.load_module("entries", traffic["entry"])
    numbers = entry.control(pool, traffic["args"], "cpu", Precision("bfloat16"), random.Random(1), config)
    limits = traffic["limits"]
    assert any(not np.isfinite(v) or v > limits[n] for n, v in numbers.items()), numbers
