# SPDX-License-Identifier: CECILL-2.1
"""The port stands without jax: importing it and driving it on the CPU (a
tiny stack at the defaults, one lazy map read, a tensor stack,
``speckle_stats``, ``full_step_fn`` and a tiny XST scan) pulls in neither
jax nor the JAX package, and launches no kernel. ``chip_smoke.py`` needs a
card, reports the one card it used, and reads lazy maps only by frame."""
import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import numpy as np
import barc4dip_tpu_torch as port
from barc4dip_tpu_torch import maths, models, preprocessing, signal
from barc4dip_tpu_torch.ops import _nvcc, cuda_densetrack, cuda_fftp, cuda_median, densetrack, rank
from barc4dip_tpu_torch.utils import dtype, range, speckle_stack

import torch
stack = speckle_stack(2, (128, 128), seed=3, dtype=np.uint16, mean_counts=4000.0)
out = port.speckle_stack_stats(stack, verbose=False, device="cpu")
assert np.all(np.isfinite(out["full"]["grain"]["lx"]))
assert np.isfinite(out["full"]["grain"]["autocorr"][1]).all()
res = port.speckle_stack_stats(torch.from_numpy(stack), verbose=False)
assert np.array_equal(res["temporal"]["abs"]["dy"], out["temporal"]["abs"]["dy"])
one = port.speckle_stats(stack[0], verbose=False, device="cpu")
assert np.isfinite(np.asarray(one["full"]["grain"]["autocorr"])).all()
f = torch.from_numpy(stack.astype(np.float32))
starts = np.stack(np.meshgrid([20, 50, 80], [20, 50, 80], indexing="ij"), -1).reshape(9, 2)
step = models.full_step_fn(17, starts)
fs = step(f, f, torch.full((128, 128), 2.0), torch.zeros(128, 128), f[0, :17, :17].expand(9, 17, 17))
assert torch.isfinite(fs["dy_abs"]).all()
flat = np.full((128, 128), 2.0, np.float32)
flat[5, 7] = 0.0
ff = preprocessing.flat_field_correction(stack, flats=flat, bad_pixel_removal=True)
wf = models.WavefrontScanPipeline(pixel_size=1e-6, distance=0.5, tile_size=17, search_radius=4)(
    ff, ff[0])
assert np.all(np.isfinite(wf["wavefront"]))
wf = models.WavefrontScanPipeline(pixel_size=1e-6, distance=0.5, tile_size=17, search_radius=4,
                                  method="pallas")(ff, ff[0])
assert np.all(np.isfinite(wf["wavefront"]))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "barc4dip_tpu.")) or m == "barc4dip_tpu")
assert not bad, bad
assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0}, cuda_fftp.LAUNCHES
assert cuda_median.LAUNCHES == {"median3x3": 0}, cuda_median.LAUNCHES
assert cuda_densetrack.LAUNCHES == {"ncc_sums": 0}, cuda_densetrack.LAUNCHES
assert not (cuda_median.PLAIN_BY_SHAPE or cuda_densetrack.PLAIN_BY_SHAPE)
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_needs_a_card():
    """Without CUDA the smoke script fails and prints no result line."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_contract_line_reports_the_one_card_used(monkeypatch):
    """The last line names one card even where the host has several."""
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert smoke.contract_line("NVIDIA H100 80GB HBM3") == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_chip_smoke_reads_lazy_maps_by_frame():
    """``metric_leaves`` reads a lazy map stack's frames 0..k-1 only (the
    whole stack would compute every frame's map on the card), and
    ``golden_form`` reduces a map to the bench golden's sample and summary."""
    import numpy as np

    from barc4dip_tpu_torch.utils import LazyMapStack

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fetched = []

    def fetch(t):
        fetched.append(t)
        return np.full((96, 96), float(t), np.float32)

    out = {"full": {"grain": {"lx": np.arange(6.0), "autocorr": LazyMapStack(6, (96, 96), np.float32, fetch),
                              "xlag": np.zeros((6, 96))}},
           "tiles": {"grain": {"lx": {"mean": np.ones((6, 3, 3))}}}}
    leaves = smoke.metric_leaves(out, 2)
    assert fetched == [0, 1]
    assert leaves["full.grain.autocorr"].shape == (2, 96, 96)
    assert leaves["full.grain.lx"].tolist() == [0.0, 1.0]
    assert leaves["tiles.grain.lx.mean"].shape == (2, 3, 3)
    golden = smoke.golden_form(leaves)
    assert golden["full.grain.autocorr.sample4096"].shape == (4096,)
    np.testing.assert_allclose(golden["full.grain.autocorr.summary"], [0.5, np.sqrt(0.5), 1.0])
    assert "full.grain.autocorr" not in golden and "full.grain.xlag" in golden
