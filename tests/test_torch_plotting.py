# SPDX-License-Identifier: CECILL-2.1
"""The port's ``plotting`` against the JAX package's (Agg backend): the ten
cases of ``tests/test_plotting.py``, each figure rendered by both packages
from the same numpy inputs and compared pixel for pixel
(``_scaffold.rgba_capture``), then rendered again by the port from CPU
tensors and lazy maps (``utils.lazy``), which it brings to the host first,
with the same pixels."""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import barc4dip_tpu.plotting as jp
import barc4dip_tpu_torch.plotting as tp
from barc4dip_tpu.plotting import _scaffold as j_sc
from barc4dip_tpu_torch.plotting import _scaffold as t_sc
from barc4dip_tpu_torch.utils import LazyMap, LazyMapStack
from tests.conftest import make_speckle
from tests.test_plotting import _fake_stack_stats


@pytest.fixture(autouse=True)
def _close_all():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(51)
    return make_speckle(rng, shape=(200, 240), grain_px=5.0)


def _pixels_equal(jfig, tfig):
    a, b = j_sc.rgba_capture(jfig), t_sc.rgba_capture(tfig)
    assert a.shape == b.shape and np.array_equal(a, b)


def _lazy(a):
    return LazyMap(a.shape, a.dtype, lambda: a)


def _same(name, *args, inputs=(), **kw):
    """``name`` from both packages on numpy ``args``, then from the port on
    each form in ``inputs`` (callables mapping args to args): equal pixels."""
    want = getattr(jp, name)(*args, **kw)
    _pixels_equal(want, getattr(tp, name)(*args, **kw))
    for form in inputs:
        _pixels_equal(want, getattr(tp, name)(*form(*args), **kw))


def _tensor_first(a, *rest):
    return (torch.from_numpy(np.ascontiguousarray(a)), *rest)


def _lazy_first(a, *rest):
    return (_lazy(a), *rest)


def test_plt_image_variants(field):
    forms = (_tensor_first, _lazy_first)
    _same("plt_image", field, "title", cmap="srw", cbar_label="a.u.", inputs=forms)
    _same("plt_image", field, roi=(slice(20, 80), slice(30, 90)), inputs=forms)
    _same("plt_image", field, roi=np.s_[20:80, 30:90], roi_zoom=True, display_origin="upper",
          inputs=forms)
    with pytest.raises(ValueError):
        tp.plt_image(torch.zeros((2, 3, 4)))


def test_plt_tiles_metric(field):
    mean = np.arange(9, dtype=float).reshape(3, 3)
    stats = {
        "meta": {"display_origin": "lower", "units": {"grain": {"lx": "px"}}},
        "tiles": {"grain": {"lx": {"mean": mean, "std": np.ones((3, 3)) * 0.1}}},
    }
    forms = (_tensor_first, _lazy_first)
    _same("plt_tiles_metric", field, stats, "grain.lx", inputs=forms)
    _same("plt_tiles_metric", field, stats, ("grain", "lx"), normalize=True, show_std=False,
          inputs=forms)
    with pytest.raises(KeyError):
        tp.plt_tiles_metric(torch.from_numpy(field), stats, "grain.bogus")


def test_plt_histogram(field):
    u16 = (field / field.max() * 40000).astype(np.uint16)
    _same("plt_histogram", u16, logy=True, cumulative=True, percentiles=(5.0, 95.0),
          inputs=(lambda a: (torch.from_numpy(a.astype(np.int32)),), _lazy_first))
    with pytest.raises(ValueError):
        tp.plt_histogram(u16, bin_min=10, bin_max=5)
    with pytest.raises(TypeError):  # what is neither an array nor a tensor stays refused
        tp.plt_histogram(u16.tolist())


def test_plt_spectrum1d():
    r = np.linspace(0, 50, 200)
    curve = np.exp(-r / 10)
    both = (lambda c, x: (torch.from_numpy(c), torch.from_numpy(x)),)
    _same("plt_spectrum1d", curve, r, logy=True, cumulative=True, percentiles=(50.0,),
          inputs=both)
    _same("plt_spectrum1d", curve, r, mask_center=True, inputs=both)
    with pytest.raises(ValueError):
        tp.plt_spectrum1d(curve, r[:-1])


def test_plt_spectrum2d_real_and_complex(field):
    kw = dict(cuts=True, log_intensity=True, mask_center=True)
    want = jp.plt_spectrum2d(field, **kw)
    for data in (field, torch.from_numpy(field), _lazy(field)):
        got = tp.plt_spectrum2d(data, **kw)
        assert got["phase"] is None
        for key in ("intensity", "intensity_cuts"):
            _pixels_equal(want[key], got[key])
    F = np.fft.fftshift(np.fft.fft2(field))
    want = jp.plt_spectrum2d(F, cuts=True, show_phase=True)
    got = tp.plt_spectrum2d(torch.from_numpy(F), cuts=True, show_phase=True,
                            x=torch.arange(F.shape[1], dtype=torch.float64))
    for key in ("intensity", "intensity_cuts", "phase", "phase_cuts"):
        _pixels_equal(want[key], got[key])


def test_plt_displacement_modes():
    ss = _fake_stack_stats()
    _same("plt_displacement", ss, kind="trajectory")
    _same("plt_displacement", ss, kind="timeseries", uncertainty="band")
    _same("plt_displacement", ss, temporal="inc", kind="timeseries")
    want = jp.plt_displacement(xarr=np.arange(5.0), yarr=np.arange(5.0))
    _pixels_equal(want, tp.plt_displacement(xarr=torch.arange(5.0, dtype=torch.float64),
                                            yarr=torch.arange(5.0, dtype=torch.float64)))
    with pytest.raises(ValueError):
        tp.plt_displacement(ss, xarr=np.arange(5.0), yarr=np.arange(5.0))
    with pytest.raises(ValueError):
        tp.plt_displacement(xarr=np.arange(5.0), yarr=np.arange(5.0), uncertainty="band")


def test_plt_stack_metric_scopes():
    ss = _fake_stack_stats()
    _same("plt_stack_metric", ss, "amplitude.visibility", scope="full")
    _same("plt_stack_metric", ss, "amplitude.visibility", scope="tiles", uncertainty="band")
    _same("plt_stack_metric", ss, ("amplitude", "visibility"), scope="both")
    with pytest.raises(ValueError):
        tp.plt_stack_metric(ss, "amplitude.visibility", scope="bogus")


def test_plt_tiles_metric_stack_gif_and_png(tmp_path):
    """The port's stats of a 3-frame stack, rendered by both packages: the
    same GIF frames; the stack as a CPU tensor and as a lazy map stack too."""
    from PIL import Image

    from barc4dip_tpu_torch.metrics import speckle_stack_stats

    rng = np.random.default_rng(17)
    base = make_speckle(rng, shape=(384, 384), grain_px=6.0).astype(np.float32)
    stack = np.stack([base * (1 + 0.05 * t) for t in range(3)])
    stats = speckle_stack_stats(stack, metrics="amplitude", tiles=True, verbose=False,
                                frame_chunk=3, device="cpu")

    def frames_of(path):
        with Image.open(path) as im:
            out = []
            for i in range(im.n_frames):
                im.seek(i)
                out.append(np.array(im.convert("RGB")))
            return out

    want = jp.plt_tiles_metric_stack(stack, stats, "amplitude.visibility",
                                     str(tmp_path / "j.gif"), fps=2)
    lazy = LazyMapStack(3, stack.shape[1:], stack.dtype, lambda t: stack[t])
    for i, form in enumerate((stack, torch.from_numpy(stack), lazy)):
        gif = tmp_path / f"t{i}.gif"
        assert tp.plt_tiles_metric_stack(form, stats, "amplitude.visibility", str(gif),
                                         fps=2) == [str(gif)]
        got, ref = frames_of(gif), frames_of(want[0])
        assert len(got) == len(ref) == 3
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))

    pngs = tp.plt_tiles_metric_stack(torch.from_numpy(stack), stats, ("amplitude", "visibility"),
                                     str(tmp_path / "seq.png"), frames=[0, 2])
    assert len(pngs) == 2
    assert pngs[0].endswith("seq_0000.png") and pngs[1].endswith("seq_0002.png")
    with pytest.raises(KeyError):
        tp.plt_tiles_metric_stack(stack, stats, "amplitude.nope", str(tmp_path / "x.gif"))
    with pytest.raises(ValueError):
        tp.plt_tiles_metric_stack(stack[:2], stats, "amplitude.visibility", str(tmp_path / "x.gif"))


def test_plt_displacement_field(tmp_path):
    gy, gx = 9, 11
    field = {
        "dy": np.random.default_rng(0).normal(size=(gy, gx)),
        "dx": np.random.default_rng(1).normal(size=(gy, gx)),
        "y": np.linspace(20, 200, gy),
        "x": np.linspace(20, 240, gx),
    }
    as_tensors = {k: torch.from_numpy(v) for k, v in field.items()}
    want = jp.plt_displacement_field(field, quiver_step=2, title="test field")
    _pixels_equal(want, tp.plt_displacement_field(field, quiver_step=2, title="test field"))
    got = tp.plt_displacement_field(as_tensors, quiver_step=2, title="test field")
    _pixels_equal(want, got)
    tp.savefig(got, str(tmp_path / "field.png"))
    assert (tmp_path / "field.png").exists()

    stack_field = {
        "dy": np.stack([field["dy"]] * 3),
        "dx": np.stack([field["dx"]] * 3),
        "y": field["y"], "x": field["x"],
    }
    _same("plt_displacement_field", stack_field, frame=1)
    with pytest.raises(ValueError, match="frame="):
        tp.plt_displacement_field(stack_field)
    with pytest.raises(ValueError, match="displacement stacks"):
        tp.plt_displacement_field(field, frame=0)


def test_plt_radial_waterfall():
    curves = np.abs(np.random.default_rng(3).normal(size=(6, 40))) + 0.1
    _same("plt_radial_waterfall", curves, logz=True, zlabel="autocorr",
          inputs=(_tensor_first,))
    out = {"radial_interpolated": curves, "r_interpolated": np.linspace(0, 20, 40)}
    _same("plt_radial_waterfall", out,
          inputs=(lambda o: ({k: torch.from_numpy(v) for k, v in o.items()},),))
    with pytest.raises(ValueError):
        tp.plt_radial_waterfall(torch.from_numpy(curves[0]))


def test_plotting_exports_match_jax():
    assert sorted(tp.__all__) == sorted(jp.__all__)
