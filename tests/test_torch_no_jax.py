# SPDX-License-Identifier: CECILL-2.1
"""The port stands without jax: importing it (and driving a tiny stack and
a tiny XST scan on the CPU) pulls in neither jax nor the JAX package, and
launches no kernel. ``chip_smoke.py`` needs a card and reports the one card
it used."""
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

stack = speckle_stack(2, (128, 128), seed=3, dtype=np.uint16, mean_counts=4000.0)
out = port.speckle_stack_stats(stack, grain_maps=False, tiles=False, verbose=False, device="cpu")
assert np.all(np.isfinite(out["full"]["grain"]["lx"]))
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
