# SPDX-License-Identifier: CECILL-2.1
"""Every example of the port (``examples/cuda/ex_*.py``) runs headless on
the CPU at the smoke-test sizes (``BARC4DIP_EX_FAST=1``, ``--device cpu``)
with an output directory, so the plotting branches run too; ``ex_00``'s
dataset round-trips through the port's readers and
``barc4dip-cuda-speckles``. The JAX package's examples
(``tests/test_examples.py``) glob ``examples/ex_*.py`` only, so these add
no case there."""
import runpy
import sys
from pathlib import Path

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

HERE = Path(__file__).resolve().parents[1] / "examples"
EXAMPLES = sorted((HERE / "cuda").glob("ex_*.py"))


def test_examples_are_the_jax_packages_eight():
    assert [p.name for p in EXAMPLES] == [p.name for p in sorted(HERE.glob("ex_*.py"))]


def _run(path, out_dir, monkeypatch):
    monkeypatch.setenv("BARC4DIP_EX_FAST", "1")
    monkeypatch.setattr(sys, "argv", [str(path), str(out_dir), "--device", "cpu"])
    try:
        runpy.run_path(str(path), run_name="__main__")
    except SystemExit as exc:  # ex_06 exits with the batch script's code
        assert not exc.code, f"{path.name} exited with {exc.code}"


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs_headless(path, tmp_path, monkeypatch, capsys):
    _run(path, tmp_path, monkeypatch)
    out = capsys.readouterr().out
    assert out.strip(), f"{path.name} produced no output"
    if path.stem != "ex_00_generate_dataset":
        assert "wrote" in out or "barc4dip-cuda-batch rc=0" in out, out[-2000:]
    checks = {
        "ex_01_sharpness_scan": "best-focus frame: 2 (true: 2)",
        "ex_02_speckle_statistics": "# Speckle summary",
        "ex_03_fourier_analysis": "scan radial profiles: (4, ",
        "ex_05_preprocessing": "register_stack: measured",
        "ex_06_batch_streaming": "barc4dip-cuda-batch rc=0",
        "ex_07_wavefront_sensing": "curvature radius: fitted",
    }
    if path.stem in checks:
        assert checks[path.stem] in out, out[-2000:]
    if path.stem == "ex_04_stack_tracking":
        err = float(out.split("max trajectory error: ")[1].split(" px")[0])
        assert err < 0.1
    assert any(tmp_path.iterdir())


def test_example_main_returns_its_checks(monkeypatch):
    """Each script's ``main(out_dir, device=...)`` returns the numbers it
    prints, which is how ``chip_smoke.py`` checks them on the card."""
    monkeypatch.setenv("BARC4DIP_EX_FAST", "1")
    g = runpy.run_path(str(HERE / "cuda" / "ex_04_stack_tracking.py"), run_name="example")
    res = g["main"](None, device="cpu")
    assert res["err_px"] < 0.1 and res["window_delta_px"] < 1e-3 and res["mesh"] is None
    g = runpy.run_path(str(HERE / "cuda" / "ex_01_sharpness_scan.py"), run_name="example")
    res = g["main"](None, device="cpu")
    assert res["best"] == res["true"]


def test_ex00_dataset_is_consumable(tmp_path, monkeypatch, capsys):
    """The generated dataset round-trips through the port's readers and
    ``barc4dip-cuda-speckles``."""
    _run(EXAMPLES[0], tmp_path, monkeypatch)
    assert EXAMPLES[0].stem == "ex_00_generate_dataset"

    import barc4dip_tpu_torch as dip

    stack = dip.read_image(str(tmp_path / "speckle_stack.h5"))
    assert stack.ndim == 3 and stack.shape[0] == 4 and stack.dtype == np.uint16
    edf = dip.read_image(str(tmp_path / "scan_0002.edf"))
    np.testing.assert_array_equal(edf, stack[2])
    flat = dip.read_image(str(tmp_path / "flat.tif"))
    assert flat.shape == stack.shape[1:]

    from barc4dip_tpu_torch.report.cli import main as cli_main

    capsys.readouterr()
    rc = cli_main([
        "-s", str(tmp_path / "speckle_stack.h5"), "-n", "0",
        "-f", str(tmp_path / "flat.tif"), "-d", str(tmp_path / "dark.tif"), "--device", "cpu",
    ])
    assert rc == 0
    assert "# Speckle summary" in capsys.readouterr().out
