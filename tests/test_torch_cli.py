# SPDX-License-Identifier: CECILL-2.1
"""The port's console scripts, in process (``main(argv)`` with
``--device cpu``), against the JAX package's on the same files, and the
device rule they inherit.

- ``barc4dip-cuda-speckles``: stdout is compared with ``barc4dip-speckles``'
  as text: the timestamp line apart, the non-numeric text is equal and every
  number agrees at rtol 1e-6 (float64 files compute in float64 in both
  packages). A float32 file computes in float32 on both sides, where a value
  may print one unit of its last digit apart: that case allows just that.
- ``barc4dip-cuda-batch``: the JSON summary leaf by leaf (rtol 1e-6 for
  float64 stacks; the calibrated run computes in float32 and is held at
  1e-4), the ``.npz`` keys, the report, exit code 2 for missing inputs,
  ``--register`` against the JAX script, ``--mesh`` as the port specifies
  it.
- The device rule: with no card, ``device=None`` raises everywhere and
  ``device="cpu"`` / ``--device cpu`` runs."""
import json
import re

import numpy as np
import pytest
import torch

import barc4dip_tpu.io as jio
import barc4dip_tpu_torch as tdip
import barc4dip_tpu_torch.io as tio
from barc4dip_tpu_torch.metrics import perceptual
from barc4dip_tpu.report.batch_cli import main as j_batch
from barc4dip_tpu.report.cli import main as j_cli
from barc4dip_tpu_torch.models import SharpnessScanPipeline, SpeckleStackPipeline, WavefrontScanPipeline
from barc4dip_tpu_torch.report import batch_cli, cli
from tests.conftest import make_speckle

torch.set_num_threads(2)
CPU = ["--device", "cpu"]
_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
_STAMP = re.compile(r"^\d{4}-\d{2}-\d{2} \| \d{2}:\d{2}:\d{2}$")


def assert_reports_equal(got: str, want: str, *, last_digit: bool = False):
    """Same text around the numbers; numbers at rtol 1e-6 (``last_digit``:
    or one unit of the last printed digit apart)."""
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if _STAMP.match(w):
            assert _STAMP.match(g)
            continue
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w)
        for a, b in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
            if a == b:
                continue
            tol = 1e-6 * abs(float(b))
            if last_digit:
                decimals = len(b.split(".")[1]) if "." in b and "e" not in b.lower() else 0
                tol = max(tol, 1.0001 * 10.0 ** -decimals)
            assert abs(float(a) - float(b)) <= tol, (g, w)


@pytest.fixture(scope="module")
def field():
    return make_speckle(np.random.default_rng(41), shape=(400, 400), grain_px=5.0)


def _both_clis(argv, capsys):
    assert j_cli(argv) == 0
    want = capsys.readouterr().out
    assert cli.main([*argv, *CPU]) == 0
    return capsys.readouterr().out, want


_CLI_CASES = {
    "default_trio": [],
    "all_no_tiles": ["--all", "--no_tiles"],
    "complete_notes": ["--all", "--complete", "--notes"],
}


@pytest.mark.parametrize("case", sorted(_CLI_CASES))
@pytest.mark.parametrize("fmt", ["edf_float64", "h5_float64", "tif_float32"])
def test_speckles_cli_equals_jax(field, tmp_path, capsys, case, fmt):
    if fmt == "edf_float64":
        path = tmp_path / "speckle.edf"
        tio.save_edf(field, path)
    elif fmt == "h5_float64":
        path = tmp_path / "speckle.h5"
        jio.save_h5(np.stack([field * 0.5, field]), path)
    else:
        path = tmp_path / "speckle.tif"
        jio.save_tiff(field.astype(np.float32) / field.max(), path, dtype="float32")
    argv = ["-s", str(path), *_CLI_CASES[case]] + (["-n", "1"] if fmt == "h5_float64" else [])
    got, want = _both_clis(argv, capsys)
    assert got.startswith("# Speckle summary")
    assert ("## Bandwidth (full image)" in got) == ("--all" in argv)
    assert ("Visibility (tiles)" in got) == ("--no_tiles" not in argv)
    assert ("Notes:" in got) == ("--notes" in argv)
    assert_reports_equal(got, want, last_digit=(fmt == "tif_float32"))


def test_speckles_cli_writes_the_report_file(field, tmp_path, capsys):
    tio.save_edf(field, tmp_path / "s.edf")
    out = tmp_path / "rep.md"
    assert cli.main(["-s", str(tmp_path / "s.edf"), "-o", str(out), *CPU]) == 0
    assert out.read_text(encoding="utf-8") == capsys.readouterr().out
    # the report equals the direct call's, as a string
    stats = tdip.speckle_stats(tio.read_image(str(tmp_path / "s.edf")),
                               metrics=("amplitude", "grain", "stats"), verbose=False, device="cpu")
    lines = tdip.logbook_report(stats).splitlines()
    assert [ln for ln in out.read_text().splitlines() if not _STAMP.match(ln)] \
        == [ln for ln in lines if not _STAMP.match(ln)]


def test_speckles_cli_h5_with_flat_and_dark(tmp_path, capsys):
    rng = np.random.default_rng(42)
    base = make_speckle(rng, shape=(256, 256), grain_px=5.0).astype(np.float32)
    jio.save_h5(np.stack([base, base * 1.1]), tmp_path / "s.h5")
    jio.save_tiff(rng.normal(2000.0, 50.0, size=(256, 256)).astype(np.float32), tmp_path / "flat.tif")
    tio.save_edf(np.full((256, 256), 3.0, np.float32), tmp_path / "dark.edf")
    argv = ["-s", str(tmp_path / "s.h5"), "-n", "1", "-f", str(tmp_path / "flat.tif"),
            "-d", str(tmp_path / "dark.edf")]
    got, want = _both_clis(argv, capsys)
    assert "- Image shape: 256 x 256 px" in got
    assert_reports_equal(got, want, last_digit=True)  # the flat-field computes in float32


def test_cli_parsers_equal_jax_apart_from_device():
    from barc4dip_tpu.report import batch_cli as jb
    from barc4dip_tpu.report import cli as jc

    for port, ref, argv in ((cli, jc, ["-s", "x.tif"]), (batch_cli, jb, ["x.h5"])):
        got, want = vars(port._build_parser().parse_args(argv)), vars(ref._build_parser().parse_args(argv))
        assert got.pop("device") is None
        assert got == want
        assert "explicit device" in port._build_parser().format_help()
    assert cli._DEFAULT_GROUPS == jc._DEFAULT_GROUPS
    assert cli._build_parser().prog == "barc4dip-cuda-speckles"
    assert batch_cli._build_parser().prog == "barc4dip-cuda-batch"


# -- batch CLI ------------------------------------------------------------------------

def assert_summaries_close(got, want, rtol=1e-6, atol=1e-9):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_summaries_close(got[k], want[k], rtol, atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_summaries_close(a, b, rtol, atol)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    else:
        assert got == want


def _run_batch(main, argv, out_json):
    assert main([*argv, "--out", str(out_json)]) == 0
    return json.loads(out_json.read_text())


def test_batch_cli_h5_speckle_equals_jax(tmp_path):
    rng = np.random.default_rng(43)
    base = make_speckle(rng, shape=(160, 160), grain_px=6.0)
    jio.save_h5(np.stack([np.roll(base, (t, -t), axis=(0, 1)) * (1 + 0.01 * t) for t in range(4)]),
                tmp_path / "run.h5")
    common = [str(tmp_path / "run.h5"), "--metrics", "amplitude,stats", "--no-tiles",
              "--frame-chunk", "2"]
    got = _run_batch(batch_cli.main, [*common, *CPU, "--checkpoint-dir", str(tmp_path / "ck_t"),
                                      "--npz", str(tmp_path / "t.npz"), "--report", str(tmp_path / "t.md")],
                     tmp_path / "t.json")
    want = _run_batch(j_batch, [*common, "--checkpoint-dir", str(tmp_path / "ck_j"),
                                "--npz", str(tmp_path / "j.npz"), "--report", str(tmp_path / "j.md")],
                      tmp_path / "j.json")
    assert got["kind"] == "speckle_stack_stats" and got["n_frames"] == 4
    assert "amplitude.visibility" in got["metric_series"]
    assert_summaries_close(got, want)
    with np.load(tmp_path / "t.npz") as t_npz, np.load(tmp_path / "j.npz") as j_npz:
        assert sorted(t_npz.files) == sorted(j_npz.files)
        assert t_npz["temporal/abs/dx"].shape == (4,)
        for k in j_npz.files:
            np.testing.assert_allclose(t_npz[k], j_npz[k], rtol=1e-6, atol=1e-9, err_msg=k)
    assert_reports_equal((tmp_path / "t.md").read_text(), (tmp_path / "j.md").read_text())
    assert (tmp_path / "t.md").read_text().startswith("# Speckle stack summary")
    assert len(list((tmp_path / "ck_t").glob("torch_speckle_fused_*.npz"))) == 2
    # the resume loads the chunks and gives the same summary
    again = _run_batch(batch_cli.main, [*common, *CPU, "--checkpoint-dir", str(tmp_path / "ck_t")],
                       tmp_path / "t2.json")
    assert again == got
    # --mesh on one device shards nothing, as in the JAX script
    assert _run_batch(batch_cli.main, [*common, *CPU, "--mesh"], tmp_path / "t3.json") == got


def test_batch_cli_streams_edf_files_and_prints_to_stdout(tmp_path, capsys):
    rng = np.random.default_rng(47)
    base = make_speckle(rng, shape=(160, 160), grain_px=6.0)
    stack = np.stack([np.roll(base, (t, 2 * t), axis=(0, 1)) for t in range(3)])
    for t, frame in enumerate(stack):
        tio.save_edf(frame, tmp_path / f"scan_{t:03d}.edf")
    argv = [str(tmp_path / "scan_*.edf"), "--metrics", "amplitude", "--no-tiles", "--frame-chunk", "2"]
    assert batch_cli.main([*argv, *CPU, "--npz", str(tmp_path / "t.npz")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert j_batch(argv) == 0
    assert_summaries_close(got, json.loads(capsys.readouterr().out), rtol=1e-4, atol=1e-4)  # float32 frames
    np.testing.assert_allclose(got["tracking"]["final_dx_px"], 4.0, atol=0.05)
    np.testing.assert_allclose(got["tracking"]["final_dy_px"], 2.0, atol=0.05)
    # the .npz holds what run_files returns
    paths = sorted(str(p) for p in tmp_path.glob("scan_*.edf"))
    direct = SpeckleStackPipeline(metrics="amplitude", tiles=False, frame_chunk=2,
                                  device="cpu").run_files(paths)
    with np.load(tmp_path / "t.npz") as npz:
        np.testing.assert_array_equal(npz["temporal/abs/dx"], direct["temporal"]["abs"]["dx"])
        np.testing.assert_array_equal(npz["full/amplitude/visibility"],
                                      direct["full"]["amplitude"]["visibility"])


def test_batch_cli_reads_no_lazy_map(tmp_path, capsys, monkeypatch):
    """The summary, the ``.npz`` and the report leave the per-frame grain
    maps unread (each would cost a device pass and a file read); the JSON is
    the JAX script's all the same, which reads them all."""
    base = make_speckle(np.random.default_rng(49), shape=(160, 160), grain_px=6.0)
    for t in range(2):
        tio.save_edf(base * (1 + 0.1 * t), tmp_path / f"scan_{t}.edf")
    argv = [str(tmp_path / "scan_*.edf"), "--metrics", "grain", "--no-tiles"]
    assert j_batch(argv) == 0
    want = json.loads(capsys.readouterr().out)

    def no_map(*a, **k):
        raise AssertionError("a lazy grain map was read")

    monkeypatch.setattr("barc4dip_tpu_torch.metrics.speckles._grain_map", no_map)
    assert batch_cli.main([*argv, *CPU, "--npz", str(tmp_path / "t.npz"),
                           "--report", str(tmp_path / "t.md")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert "grain.lx" in got["metric_series"] and "grain.autocorr" not in got["metric_series"]
    assert_summaries_close(got, want, rtol=1e-4, atol=1e-4)  # float32 frames from files
    with np.load(tmp_path / "t.npz") as npz:
        assert "full/grain/lx" in npz.files and "full/grain/autocorr" not in npz.files


def test_batch_cli_sharpness_glob_equals_jax(tmp_path, capsys):
    from scipy.ndimage import gaussian_filter

    base = make_speckle(np.random.default_rng(44), shape=(160, 160), grain_px=4.0)
    for t, s in enumerate((2.0, 0.0, 1.0)):
        jio.save_tiff((gaussian_filter(base, s) / base.max() * 30000).astype(np.float32),
                      tmp_path / f"scan_{t}.tif")
    argv = [str(tmp_path / "scan_*.tif"), "--kind", "sharpness", "--metrics", "gradient", "--no-tiles"]
    assert batch_cli.main([*argv, *CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    assert j_batch(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["kind"] == "sharpness_stack_stats" and got["focus"]["best_frame"] == 1
    assert_summaries_close(got, want, rtol=2e-4)  # float32 frames, as the sharpness stack tests


def test_batch_cli_sharpness_from_h5_and_other_extensions(tmp_path, capsys):
    base = make_speckle(np.random.default_rng(48), shape=(160, 160), grain_px=4.0)
    jio.save_h5(np.stack([base, base * 1.5]), tmp_path / "scan.h5")
    argv = [str(tmp_path / "scan.h5"), "--kind", "sharpness", "--metrics", "gradient,laplacian", "--no-tiles"]
    assert batch_cli.main([*argv, *CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    assert j_batch(argv) == 0
    assert_summaries_close(got, json.loads(capsys.readouterr().out))
    # files the streaming path does not take (.spe) load through read_image
    from tests.test_io import TestWrappedContainers

    for t in range(2):
        TestWrappedContainers()._write_spe(tmp_path / f"f{t}.spe",
                                           (base * (100 + t)).astype(np.uint16))
    for kind in ("speckle", "sharpness"):
        argv = [str(tmp_path / "f0.spe"), str(tmp_path / "f1.spe"), "--kind", kind, "--no-tiles",
                "--metrics", "amplitude" if kind == "speckle" else "gradient"]
        assert batch_cli.main([*argv, *CPU]) == 0
        assert json.loads(capsys.readouterr().out)["n_frames"] == 2


def test_batch_cli_search_radius(tmp_path):
    base = make_speckle(np.random.default_rng(44), shape=(160, 160), grain_px=6.0).astype(np.float32)
    jio.save_h5(np.stack([np.roll(base, (t, -t), axis=(0, 1)) for t in range(3)]), tmp_path / "run.h5")
    common = [str(tmp_path / "run.h5"), "--metrics", "amplitude,stats", "--no-tiles",
              "--frame-chunk", "2", *CPU]
    full = _run_batch(batch_cli.main, common, tmp_path / "full.json")["tracking"]
    win = _run_batch(batch_cli.main, [*common, "--search-radius", "12"], tmp_path / "win.json")["tracking"]
    ref = _run_batch(j_batch, [*common[:-2], "--search-radius", "12"], tmp_path / "ref.json")["tracking"]
    for key in ("final_dy_px", "final_dx_px", "mean_r_px", "max_r_px"):
        np.testing.assert_allclose(win[key], full[key], atol=1e-5)
        np.testing.assert_allclose(win[key], ref[key], atol=5e-3)


def test_batch_cli_flat_field_equals_jax_and_missing_calibration(tmp_path, capsys):
    rng = np.random.default_rng(46)
    base = make_speckle(rng, shape=(160, 160), grain_px=6.0).astype(np.float32)
    gain = np.broadcast_to(np.linspace(0.5, 2.0, 160, dtype=np.float32)[:, None], (160, 160)).copy()
    dark = np.full((160, 160), 700.0, np.float32)
    jio.save_h5(np.stack([base * (1 + 0.01 * t) * gain + dark for t in range(3)]), tmp_path / "run.h5")
    jio.save_tiff(gain * 100.0 + dark, tmp_path / "flat.tif")
    jio.save_tiff(dark, tmp_path / "dark.tif")
    common = [str(tmp_path / "run.h5"), "--metrics", "amplitude,stats", "--no-tiles", "--frame-chunk", "2"]
    cal = ["--flat", str(tmp_path / "flat.tif"), "--dark", str(tmp_path / "dark.tif")]
    raw = _run_batch(batch_cli.main, [*common, *CPU], tmp_path / "raw.json")
    got = _run_batch(batch_cli.main, [*common, *cal, *CPU], tmp_path / "cal.json")
    want = _run_batch(j_batch, [*common, *cal], tmp_path / "ref.json")
    assert_summaries_close(got, want, rtol=1e-4, atol=1e-3)
    vis_true = float(base.std() / base.mean())
    assert abs(got["metric_series"]["amplitude.visibility"]["mean"] - vis_true) < 0.02
    assert abs(raw["metric_series"]["amplitude.visibility"]["mean"] - vis_true) > 0.1
    # a missing calibration file is a clean exit code 2, with the JAX script's message
    for main, extra in ((j_batch, []), (batch_cli.main, CPU)):
        assert main([str(tmp_path / "run.h5"), "--flat", str(tmp_path / "nope.tif"), *extra]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err[1] == err[0].replace("barc4dip-batch", "barc4dip-cuda-batch")


@pytest.mark.parametrize("argv, what", [(["missing_0.edf", "missing_1.edf"], "input file(s) not found"),
                                        (["nothing_*.edf"], "no files match")])
def test_batch_cli_missing_inputs_exit_2(tmp_path, capsys, monkeypatch, argv, what):
    monkeypatch.chdir(tmp_path)
    assert j_batch(argv) == 2
    want = capsys.readouterr().err
    assert batch_cli.main([*argv, *CPU]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert captured.err == want.replace("barc4dip-batch", "barc4dip-cuda-batch") and what in captured.err


def test_batch_cli_register_and_mesh_are_not_ported(tmp_path, monkeypatch):
    """``--register`` is ported: a missing input exits 2 like any other run
    (its drift removal is ``test_batch_cli_register_removes_drift``).
    ``--mesh`` raises only where several CUDA devices are visible."""
    assert batch_cli.main(["missing.h5", "--register", "first", *CPU]) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        batch_cli.main(["missing.h5", "--mesh", "--device", "cuda"])
    assert batch_cli.main(["missing.h5", "--mesh", *CPU]) == 2  # the CPU is one device


def test_batch_cli_register_removes_drift(tmp_path):
    """The port of tests/test_report_cli.py's case: ``--register`` aligns a
    drifting stack before analysis, the summary carries the measured shifts
    and the residual tracking drops to ~0; against the JAX script, the
    ``registration`` block agrees within 1e-4 px."""
    rng = np.random.default_rng(45)
    base = make_speckle(rng, shape=(160, 160), grain_px=6.0).astype(np.float32)
    stack = np.stack([np.roll(base, (2 * t, -3 * t), axis=(0, 1)) for t in range(4)])
    jio.save_h5(stack, tmp_path / "run.h5")

    outs = {}
    for tag, extra in (("raw", []), ("reg", ["--register", "first"]), ("jax", ["--register", "first"])):
        out_json = tmp_path / f"{tag}.json"
        argv = [str(tmp_path / "run.h5"), "--metrics", "amplitude,stats", "--no-tiles",
                "--frame-chunk", "2", "--out", str(out_json), *extra]
        assert (j_batch(argv) if tag == "jax" else batch_cli.main([*argv, *CPU])) == 0
        outs[tag] = json.loads(out_json.read_text())

    assert outs["raw"]["tracking"]["max_r_px"] > 5.0
    reg = outs["reg"]["registration"]
    assert reg["reference"] == "first"
    np.testing.assert_allclose(reg["final_dy_px"], 6.0, atol=0.05)
    np.testing.assert_allclose(reg["final_dx_px"], -9.0, atol=0.05)
    assert outs["reg"]["tracking"]["max_r_px"] < 0.1
    assert "registration" not in outs["raw"]
    for k, v in outs["jax"]["registration"].items():
        assert reg[k] == v if isinstance(v, str) else abs(reg[k] - v) <= 1e-4, k


# -- the device rule ------------------------------------------------------------------

@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rule")
    stack = tdip.utils.speckle_stack(2, (160, 160), seed=3, dtype=np.uint16, mean_counts=4000.0)
    paths = []
    for t, frame in enumerate(stack):
        paths.append(str(d / f"f{t}.edf"))
        tio.save_edf(frame, paths[-1])
    return stack, paths


_RULE_CASES = {
    "speckle_stats": lambda st, p, dev: tdip.speckle_stats(st[0], tiles=False, verbose=False, **dev),
    "sharpness_stats": lambda st, p, dev: tdip.sharpness_stats(st[0], tiles=False, verbose=False, **dev),
    "distribution_moments": lambda st, p, dev: tdip.distribution_moments(st[0], **dev),
    "speckle_stack_stats": lambda st, p, dev: tdip.speckle_stack_stats(st, tiles=False, verbose=False, **dev),
    "speckle_pipeline": lambda st, p, dev: SpeckleStackPipeline(tiles=False, **dev)(st),
    "speckle_pipeline_flats": lambda st, p, dev: SpeckleStackPipeline(tiles=False, metrics="stats", **dev)(
        st, flats=np.full(st.shape[1:], 2.0, np.float32)),
    "speckle_pipeline_run_files": lambda st, p, dev: SpeckleStackPipeline(tiles=False, **dev).run_files(p),
    "sharpness_pipeline": lambda st, p, dev: SharpnessScanPipeline(**dev)(st),
    "wavefront_pipeline": lambda st, p, dev: WavefrontScanPipeline(
        pixel_size=1e-6, distance=0.5, tile_size=17, search_radius=4, **dev)(st),
    "flat_field_correction": lambda st, p, dev: tdip.preprocessing.flat_field_correction(
        st, flats=np.full(st.shape[1:], 2.0, np.float32), **dev),
    "to_uint16": lambda st, p, dev: tdip.utils.dtype.to_uint16(st.astype(np.float32), **dev),
    "percentile_range": lambda st, p, dev: tdip.utils.range.percentile_minmax_range(st[0], **dev),
    "fft2d": lambda st, p, dev: tdip.signal.fft2d(st[0], **dev),
    "psd1d": lambda st, p, dev: tdip.signal.psd1d(st[0, 0], **dev),
    "psd2d": lambda st, p, dev: tdip.signal.psd2d(st[0], **dev),
    "xcorr1d": lambda st, p, dev: tdip.signal.xcorr1d(st[0, 0], st[1, 0], **dev),
    "xcorr2d": lambda st, p, dev: tdip.signal.xcorr2d(st[0], st[1], **dev),
    "autocorr2d": lambda st, p, dev: tdip.signal.autocorr2d(st[0], **dev),
    "spectral_summary": lambda st, p, dev: tdip.signal.spectral_summary(st[0], **dev),
    "spectral_summary_stack": lambda st, p, dev: tdip.signal.spectral_summary_stack(st, **dev),
    "template_matching": lambda st, p, dev: tdip.signal.template_matching(st[0, 60:101, 60:101], st[1], **dev),
    "phase_correlation": lambda st, p, dev: tdip.signal.phase_correlation(st[0, 40:120, 40:120], st[1], **dev),
    "phase_correlation_skimage": lambda st, p, dev: tdip.signal.phase_correlation(
        st[0, 40:120, 40:120], st[1], backend="skimage", **dev),
    "track_translation": lambda st, p, dev: tdip.signal.track_translation(st[0, 40:120, 40:120], st[1], **dev),
    "radial_mean_binned": lambda st, p, dev: tdip.maths.radial_mean_binned(st[0], **dev),
    "radial_mean_interpolated": lambda st, p, dev: tdip.maths.radial_mean_interpolated(st[0], **dev),
    "width_at_fraction": lambda st, p, dev: tdip.maths.width_at_fraction(st[0, 0], **dev),
    "distance_at_fraction_from_peak": lambda st, p, dev: tdip.maths.distance_at_fraction_from_peak(st[0, 0], **dev),
    "visibility_map": lambda st, p, dev: tdip.metrics.visibility_map(st, **dev),
    "fourier_ring_correlation": lambda st, p, dev: tdip.metrics.fourier_ring_correlation(st[0], st[1], **dev),
    "psnr": lambda st, p, dev: perceptual.psnr(st[0], st[1], **dev),
    "ssim": lambda st, p, dev: perceptual.ssim(st[0], st[1], **dev),
    "ms_ssim": lambda st, p, dev: perceptual.ms_ssim(st[0], st[1], levels=2, **dev),
    "speckles_cli": lambda st, p, dev: cli.main(["-s", p[0], "--no_tiles", *(["--device", "cpu"] if dev else [])]),
    "batch_cli": lambda st, p, dev: batch_cli.main(
        [*p, "--no-tiles", "--metrics", "amplitude", *(["--device", "cpu"] if dev else [])]),
    "batch_cli_register": lambda st, p, dev: batch_cli.main(
        [*p, "--no-tiles", "--metrics", "amplitude", "--register", "previous",
         *(["--device", "cpu"] if dev else [])]),
    "deconvolve_psf": lambda st, p, dev: tdip.preprocessing.deconvolve_psf(st, sigma=1.0, **dev),
    "clahe": lambda st, p, dev: tdip.preprocessing.clahe(st[0], tile_grid_size=(2, 2), **dev),
    "correct_distortion": lambda st, p, dev: tdip.preprocessing.correct_distortion(st, k1=0.01, **dev),
    "shift_stack": lambda st, p, dev: tdip.preprocessing.shift_stack(st, 1.5, -0.5, **dev),
    "register_stack": lambda st, p, dev: tdip.preprocessing.register_stack(st, **dev),
}


@pytest.mark.parametrize("case", sorted(_RULE_CASES))
def test_no_device_means_the_card_and_raises_without_one(no_card, small_files, capsys, case):
    """Nothing picks the CPU unasked: with no card, ``device=None`` (or no
    ``--device``) raises a RuntimeError that names the way out, and the same
    call with ``device="cpu"`` (``--device cpu``) runs."""
    import barc4dip_tpu_torch.preprocessing  # noqa: F401 - reached as an attribute above
    import barc4dip_tpu_torch.utils.dtype  # noqa: F401
    import barc4dip_tpu_torch.utils.range  # noqa: F401

    stack, paths = small_files
    call = _RULE_CASES[case]
    with pytest.raises(RuntimeError, match=r'device="cpu"') as err:
        call(stack, paths, {})
    if case.endswith("_cli"):
        assert "--device cpu" in str(err.value)
    assert capsys.readouterr().out == ""
    assert call(stack, paths, {"device": "cpu"}) is not None


def test_resolve_device(no_card, monkeypatch):
    from barc4dip_tpu_torch.config import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda:1")) == torch.device("cuda", 1)  # named, not checked here
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        resolve_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    # a tensor input computes where it lives, whatever ``device`` would mean
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.from_numpy(tdip.utils.speckle_stack(2, (160, 160), seed=3, dtype=np.float32))
    assert tdip.speckle_stats(x[0], tiles=False, verbose=False)["meta"]["kind"] == "speckles"
    assert SpeckleStackPipeline(tiles=False, metrics="stats")(x)["meta"]["n_frames"] == 2
