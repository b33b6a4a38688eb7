# SPDX-License-Identifier: CECILL-2.1
"""``logbook_report`` of the port against the JAX package's: the same string
for the same stats dict, for every registered kind (speckles, sharpness,
both stacks, the wavefront scan and its three parts), ``complete`` and ``notes`` on and off. The
report prints the time it was made, so both sides run under one clock.
"""
import numpy as np
import pytest

import barc4dip_tpu.metrics as jm
import barc4dip_tpu.report.markdown as j_md
import barc4dip_tpu_torch.metrics as tm
import barc4dip_tpu_torch.report as t_report
import barc4dip_tpu_torch.report.markdown as t_md
from barc4dip_tpu_torch import models as t_models
from barc4dip_tpu_torch.signal import xst as t_xst
from tests.conftest import make_speckle


@pytest.fixture(autouse=True)
def _one_clock(monkeypatch):
    monkeypatch.setattr(j_md, "now", lambda: 1.7e9)
    monkeypatch.setattr(t_md, "now", lambda: 1.7e9)
    for pkg in ("barc4dip_tpu", "barc4dip_tpu_torch"):
        monkeypatch.setattr(f"{pkg}.metrics.sharpness.MIN_TILE_PX", 32)
        monkeypatch.setattr(f"{pkg}.metrics.speckles.MIN_TILE_PX", 32)


def _frames(T=3, shape=(144, 150)):
    rng = np.random.default_rng(5)
    base = make_speckle(rng, shape=shape, grain_px=5.0)
    return np.stack([np.roll(base, (t, -t), axis=(0, 1)) * (1 + 0.02 * t) for t in range(T)])


def _stats(kind):
    """A stats dict of each registered kind, computed by the port."""
    frames = _frames()
    if kind == "speckles":
        return tm.speckle_stats(frames[0], verbose=False, device="cpu")
    if kind == "sharpness":
        return tm.sharpness_stats(frames[0], verbose=False, device="cpu")
    if kind == "sharpness_stack_stats":
        return tm.sharpness_stack_stats(frames, verbose=False, device="cpu")
    if kind == "speckle_stack_stats":
        return tm.speckle_stack_stats(frames, verbose=False, device="cpu")
    track = dict(tile_size=17, step=16, search_radius=3)
    if kind == "wavefront_scan":
        return t_models.WavefrontScanPipeline(
            pixel_size=1e-6, distance=0.5, wavelength=1e-10, device="cpu", **track)(frames, frames[0])
    if kind == "displacement_stack":
        return t_xst.track_displacement_stack(frames, frames[0], device="cpu", **track)
    field = t_xst.track_displacement_field(frames[1], frames[0], device="cpu", **track)
    if kind == "displacement_field":
        return field
    if kind == "wavefront":
        return t_xst.wavefront_from_displacements(field, pixel_size=1e-6, distance=0.5)
    raise AssertionError(kind)


_KINDS = ["speckles", "sharpness", "sharpness_stack_stats", "speckle_stack_stats",
          "wavefront_scan", "wavefront", "displacement_field", "displacement_stack"]


def test_every_registered_kind_is_covered():
    assert sorted(t_md._LOGBOOK_FORMATTERS) == sorted(j_md._LOGBOOK_FORMATTERS) == sorted(_KINDS)


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("notes", [False, True])
@pytest.mark.parametrize("kind", _KINDS)
def test_logbook_report_equals_jax(kind, notes, complete):
    stats = _stats(kind)
    assert stats["meta"]["kind"] == kind
    got = t_report.logbook_report(stats, complete=complete, notes=notes)
    want = j_md.logbook_report(stats, complete=complete, notes=notes)
    assert got == want
    assert got.strip() and len(got.splitlines()) > 3


def test_logbook_report_of_the_jax_dict_and_a_file(tmp_path):
    """The JAX package's own sharpness dict reads the same through both
    formatters (Config A: ``logbook_report(sharpness_stats(image))``), and
    a report path writes the returned text."""
    stats = jm.sharpness_stats(_frames()[0], verbose=False)
    got = t_report.logbook_report(stats, tmp_path / "a.md")
    assert got == j_md.logbook_report(stats)
    assert (tmp_path / "a.md").read_text().strip() == got.strip()


def test_logbook_report_errors_and_registry():
    for bad in ({}, {"meta": {}}, {"meta": {"kind": "  "}}, {"meta": {"kind": "nope"}}):
        with pytest.raises((ValueError, TypeError, KeyError)) as want:
            j_md.logbook_report(bad)
        with pytest.raises(type(want.value)) as got:
            t_report.logbook_report(bad)
        assert str(got.value) == str(want.value)

    @t_report.register_formatter(" Custom ")
    def _custom(stats, *, complete=False, notes=False):
        return f"custom {complete} {notes}"

    try:
        assert t_report.logbook_report({"meta": {"kind": "CUSTOM"}}, notes=True) == "custom False True"
    finally:
        t_md._LOGBOOK_FORMATTERS.pop("custom")
