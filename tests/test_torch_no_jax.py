# SPDX-License-Identifier: CECILL-2.1
"""The port stands without jax: importing it and driving it on the CPU (a
tiny stack at the defaults, one lazy map read, a tensor stack,
``speckle_stats``, ``full_step_fn``, a tiny XST scan, the sharpness calls,
a focus scan, a report, an EDF written and read back, both console scripts,
the pipelines' ``run_files``, the signal layer and the metric extensions,
the rest of preprocessing, a sharded stack on a CPU mesh, the ``ops`` and
``utils`` exports, the stack loop's record and its compute probe, the
plotting package and the port's examples)
pulls in neither jax nor the JAX package,
and launches no kernel; its ``io`` imports with ``h5py`` and Pillow hidden.
``chip_smoke.py`` needs a
card, reports the one card it used, and reads lazy maps only by frame."""
import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["h5py"] = sys.modules["PIL"] = None  # hidden while the port is imported
import numpy as np
import barc4dip_tpu_torch as port
assert "matplotlib" not in sys.modules  # plotting is imported on first use
import barc4dip_tpu_torch.io
from barc4dip_tpu_torch import geometry, io, maths, metrics, models, preprocessing, report, signal
from barc4dip_tpu_torch.geometry import crop, masks, roi
from barc4dip_tpu_torch.maths import radial, stats
from barc4dip_tpu_torch.metrics import frc, maps, perceptual
from barc4dip_tpu_torch.ops import corrcore, fftcore, symmetry, upsampled_dft
from barc4dip_tpu_torch.preprocessing import distortion, enhancement, filters, registration
from barc4dip_tpu_torch.signal import corr, fft, summary, tracking
from barc4dip_tpu_torch.io import edf, h5, native, rw, tiff, uti_EdfFile
from barc4dip_tpu_torch.report import batch_cli, cli
from barc4dip_tpu_torch.utils import profiling
del sys.modules["h5py"], sys.modules["PIL"]
from barc4dip_tpu_torch.metrics import sharpness
from barc4dip_tpu_torch.ops import _nvcc, cuda_densetrack, cuda_fftp, cuda_median, densetrack, rank
from barc4dip_tpu_torch.ops import eig, stencils
from barc4dip_tpu_torch.utils import dtype, range, speckle_stack, time

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
ff = preprocessing.flat_field_correction(stack, flats=flat, bad_pixel_removal=True, device="cpu")
wf = models.WavefrontScanPipeline(pixel_size=1e-6, distance=0.5, tile_size=17, search_radius=4,
                                  device="cpu")(ff, ff[0])
assert np.all(np.isfinite(wf["wavefront"]))
wf = models.WavefrontScanPipeline(pixel_size=1e-6, distance=0.5, tile_size=17, search_radius=4,
                                  method="pallas", device="cpu")(ff, ff[0])
assert np.all(np.isfinite(wf["wavefront"]))
sharp = port.sharpness_stats(stack[0], tiles=False, verbose=False, device="cpu")
assert np.isfinite(sharp["full"]["autocorrelation"]["seq"])
assert port.logbook_report(sharp).strip()
assert sharpness.eigenvalues(stack[0], device="cpu")["e1"] > 0
scan = models.SharpnessScanPipeline()(torch.from_numpy(stack))
assert scan["meta"]["focus"]["best_frame"] in (0, 1)
assert report.logbook_report(port.sharpness_stack_stats(stack, verbose=False, device="cpu")).strip()
import contextlib, os, tempfile
with tempfile.TemporaryDirectory() as tmp:
    paths = []
    for t, frame in enumerate(stack):
        paths.append(os.path.join(tmp, f"f{t}.edf"))
        io.save_edf(frame, paths[-1])
    assert np.array_equal(port.read_image(paths), stack)
    sink = open(os.path.join(tmp, "out.txt"), "w")
    with contextlib.redirect_stdout(sink), profiling.StageTimer(sync=False).stage("cli"):
        assert cli.main(["-s", paths[0], "--device", "cpu"]) == 0
        assert batch_cli.main([*paths, "--device", "cpu"]) == 0
    sink.close()
    assert "# Speckle summary" in open(os.path.join(tmp, "out.txt")).read()
    files = models.SpeckleStackPipeline(device="cpu").run_files(paths)
    assert np.array_equal(files["temporal"]["abs"]["dy"], out["temporal"]["abs"]["dy"])
frame = stack[0].astype(np.float32)
summ = signal.spectral_summary(stack[0], device="cpu")
assert np.isfinite(summ["radial_binned"]).all() and summ["autocorr"].shape == (128, 128)
assert np.isfinite(signal.spectral_summary_stack(stack, device="cpu")["radial_interpolated"]).all()
assert signal.pull_centrosymmetric(summ["psd"]).shape == (128, 128)
dy, dx, peak, snr = signal.template_matching(frame[50:79, 50:79], frame, subpixel=False, device="cpu")
assert (dy, dx) == (1.0, 1.0) and peak > 0.99
assert np.isfinite(signal.track_translation(frame[32:96, 32:96], frame, device="cpu")).all()
assert np.isfinite(metrics.visibility_map(stack[0], device="cpu")).all()
assert np.isfinite(metrics.fourier_ring_correlation(stack[0], stack[1], device="cpu")["frc"][1:]).all()
assert 0.0 < perceptual.ssim(stack[0], stack[1], device="cpu") < 1.0
assert maths.width_at_fraction(summ["radial_binned"], device="cpu")[0] > 0
assert geometry.pad_to_square(torch.zeros(3, 5)).shape == (5, 5)
dec = preprocessing.deconvolve_psf(stack, sigma=1.0, method="rl", num_iter=3, device="cpu")
assert dec.shape == stack.shape and np.isfinite(dec).all()
assert preprocessing.deconvolve_psf(stack[0], sigma=1.0, method="uw", device="cpu").dtype == np.float32
assert preprocessing.clahe(stack[0], device="cpu").dtype == np.uint16
assert preprocessing.correct_distortion(stack, k1=0.01, device="cpu").shape == stack.shape
aligned, shifts = preprocessing.register_stack(stack, reference="previous", device="cpu")
assert aligned.shape == stack.shape and shifts["dy"][0] == 0.0
assert preprocessing.shift_stack(stack, 1.0, 2.0, shift_mode="roll", device="cpu").shape == stack.shape
from barc4dip_tpu_torch import parallel
mesh = parallel.frame_mesh(["cpu", "cpu"])
sh = port.speckle_stack_stats(stack, verbose=False, mesh=mesh)
assert np.array_equal(sh["temporal"]["abs"]["dy"], out["temporal"]["abs"]["dy"])
assert parallel.shard_frames(stack, mesh).sharding == parallel.frames_sharding(mesh)
from barc4dip_tpu_torch import config, ops
from barc4dip_tpu_torch.metrics import stack_fused
from barc4dip_tpu_torch.utils import to_uint16
assert ops.zscore2d(torch.from_numpy(frame)).shape == frame.shape and config.SATURATION_VALUE == 65535.0
assert to_uint16(frame, device="cpu").dtype == np.uint16
assert stack_fused.LAST_RUN_PERF["chunks"] == 1 and stack_fused.LAST_RUN_PERF["upload_bytes"] == stack.nbytes
grid = metrics.tracking_grid_from_frame0(stack)[0]
probe = stack_fused.device_compute_probe(stack, grid, groups={"amplitude", "stats"}, mode="off", sat=65535.0,
                                         eps=1e-12, flip=False, frame_chunk=2, device="cpu")
assert probe["frames"] == 2 and probe["mpix_s"] > 0
assert "matplotlib" not in sys.modules
import matplotlib
matplotlib.use("Agg")
assert port.plotting.plt_image(torch.from_numpy(frame)) is not None
assert isinstance(port.__version__, str)
import glob, os, runpy
os.environ["BARC4DIP_EX_FAST"] = "1"
scripts = sorted(glob.glob("examples/cuda/ex_*.py"))
assert len(scripts) == 8, scripts
for path in scripts:
    runpy.run_path(path, run_name="example")  # imports only
ex04 = runpy.run_path("examples/cuda/ex_04_stack_tracking.py", run_name="example")
assert ex04["main"](None, device="cpu")["err_px"] < 0.1
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "barc4dip_tpu.")) or m == "barc4dip_tpu")
assert not bad, bad
assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0, "cols_cluster": 0}, cuda_fftp.LAUNCHES
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


def test_k1_passes_needs_a_card_and_imports_no_jax():
    """The K1 timing script fails without CUDA and prints no timing; loaded
    with the port's kernel module it pulls in nothing of JAX. Its variant
    plans split each side into ranks of whole 16-value threads, and the
    source it copies still has the launcher and the C block it cuts at."""
    proc = subprocess.run(
        [sys.executable, "k1_passes.py"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert "pass1_ms" not in proc.stdout
    probe = ("import runpy, sys; mod = runpy.run_path('k1_passes.py', run_name='k1'); "
             "import barc4dip_tpu_torch.ops.cuda_fftp; "
             "print(sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'barc4dip_tpu.')) "
             "or k == 'barc4dip_tpu'))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    spec = importlib.util.spec_from_file_location("k1_passes", REPO / "k1_passes.py")
    k1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k1)
    for (h, _w, _nb), plans in k1.VARIANT_SIDES.items():
        assert 2048 < h <= 8192 and h % 128 == 0
        for q, cc in plans:
            assert q in (8, 16) and h % (16 * q) == 0 and cc * h // q // 16 <= 1024
    src = (REPO / "barc4dip_tpu_torch" / "csrc" / "fftp_corr.cu").read_text()
    assert "int launch_cluster(" in src.split('extern "C" {')[0]


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


def test_chip_smoke_writes_baseline_tiffs_both_codecs_read(tmp_path):
    """``write_baseline_tiff`` (``struct`` only) gives a file that Pillow and,
    where g++ is present, the native codec decode to the frame; a report's
    date-and-time line is the one line ``_without_stamp`` drops."""
    import numpy as np
    from PIL import Image

    from barc4dip_tpu_torch.io import native

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    arr = np.random.default_rng(0).integers(0, 65535, size=(37, 50)).astype(np.uint16)
    smoke.write_baseline_tiff(tmp_path / "b.tif", arr)
    with Image.open(tmp_path / "b.tif") as img:
        np.testing.assert_array_equal(np.array(img), arr)
    if native.native_available():
        got = native.read_tiff_native(tmp_path / "b.tif")
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, arr)
    report = "# Speckle summary\n2026-01-02 | 03:04:05\n\n## Metadata\n- 2026-01-02 | 03:04:05 px\n"
    assert smoke._without_stamp(report) == ["# Speckle summary", "", "## Metadata", "- 2026-01-02 | 03:04:05 px"]
