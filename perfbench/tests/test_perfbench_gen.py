"""The seeded generator repeats from a seed, differs across seeds, moves
the stack along the spiral and focuses the scan at its middle frame."""
import numpy as np
import torch

from perfbench.gen import speckle as gen

CPU = torch.device("cpu")
CONFIG = {"detector": {"height": 96, "width": 128},
          "content": {"grain_px": 6.0, "mean_counts": 4000.0, "spiral_amplitude": 0.35,
                      "spiral_omega": 0.7, "blur_sigma_step_px": 0.8}}


def pool(seed, **traffic):
    return gen.make_pool(seed, CONFIG, traffic, CPU)


def test_same_seed_same_inputs_other_seed_other_inputs():
    big = 2**33 + 5  # seeds beyond 32 signed bits
    a = pool(big, input="stack", frames=3, pool=2)
    b = pool(big, input="stack", frames=3, pool=2)
    c = pool(big + 1, input="stack", frames=3, pool=2)
    assert all(np.array_equal(x["data"], y["data"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["data"], c[0]["data"])
    assert not np.array_equal(a[0]["data"], a[1]["data"])
    assert a[0]["data"].dtype == np.uint16 and a[0]["data"].shape == (3, 96, 128)


def test_stack_follows_the_spiral():
    (item,) = pool(7, input="stack", frames=4, pool=1)
    dy, dx = item["truth"]["dy"], item["truth"]["dx"]
    assert np.allclose(dy, 0.35 * np.arange(4) * np.cos(0.7 * np.arange(4)))
    # frame 0 is unshifted; an integer part of the shift shows as a roll
    f = item["data"].astype(np.float64)
    assert abs(f.mean() - 4000.0) < 200.0
    assert np.corrcoef(f[0].ravel(), f[1].ravel())[0, 1] > 0.3


def test_frames_and_focus_scan():
    frames = pool(9, input="frame", pool=5)
    assert len(frames) == 5 and frames[0]["data"].shape == (96, 128)
    (scan,) = pool(9, input="focus_scan", frames=7, pool=1)
    s = scan["data"].astype(np.float64)
    contrast = s.std(axis=(1, 2)) / s.mean(axis=(1, 2))
    assert scan["truth"]["best_frame"] == 3 and int(np.argmax(contrast)) == 3
    assert np.all(np.diff(contrast[:4]) > 0) and np.all(np.diff(contrast[3:]) < 0)
