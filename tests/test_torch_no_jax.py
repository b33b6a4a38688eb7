# SPDX-License-Identifier: CECILL-2.1
"""The port stands without jax: importing it (and driving a tiny stack on
the CPU) pulls in neither jax nor the JAX package, and launches no kernel."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import numpy as np
import barc4dip_tpu_torch as port
from barc4dip_tpu_torch.ops import cuda_fftp
from barc4dip_tpu_torch.utils import speckle_stack

stack = speckle_stack(2, (128, 128), seed=3, dtype=np.uint16, mean_counts=4000.0)
out = port.speckle_stack_stats(stack, grain_maps=False, tiles=False, verbose=False, device="cpu")
assert np.all(np.isfinite(out["full"]["grain"]["lx"]))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "barc4dip_tpu.")) or m == "barc4dip_tpu")
assert not bad, bad
assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0}, cuda_fftp.LAUNCHES
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
