# SPDX-License-Identifier: CECILL-2.1
"""The port's slice as a whole: ``speckle_stack_stats`` through both
packages on the same 3 x 384^2 spiral stack (tiles_3x3, template tracking,
chunks of 2 frames).

- float64 stack: every ``full`` / ``tiles`` / ``temporal`` leaf at rtol 1e-8
  of the leaf's scale, and the tracking geometry identical;
- uint16 stack, float32 on both sides: the bench's value-gate semantics at
  rtol 1e-4 (a ``std`` leaf against its parent's scale, SNRdB in absolute
  dB), and the abs trajectory within 0.05 px of the known motion;
- a grid of dtypes, display origins, tiling and metric subsets with chunks
  that do not divide T (tolerances in the test);
- ``mesh`` beside every other option: a run on a three-entry CPU mesh equals
  the unsharded run.
"""
import numpy as np
import pytest
import torch

import barc4dip_tpu as jdip
import barc4dip_tpu_torch as tdip
from barc4dip_tpu_torch.utils import speckle_stack, spiral_motion

torch.set_num_threads(2)
T, SIDE = 3, 384
KW = dict(grain_maps=False, frame_chunk=2, verbose=False)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _rel_err(a, b, scale=None):
    """max|a - b| over the finite cells, relative to ``scale`` (default:
    the leaf's own magnitude); a finiteness mismatch is an error of inf."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    fin = np.isfinite(b)
    if not np.array_equal(np.isfinite(a), fin):
        return np.inf
    if not fin.any():
        return 0.0
    if scale is None:
        scale = max(np.abs(a[fin]).max(), np.abs(b[fin]).max())
    return 0.0 if scale == 0 else float(np.abs(a[fin] - b[fin]).max() / scale)


def _compare(out, ref, rtol, gate_semantics):
    got = {}
    want = {}
    for sec in ("full", "tiles", "temporal"):
        assert (sec in out) == (sec in ref), sec
        if sec not in ref:
            continue
        got.update({f"{sec}.{p}": v for p, v in _leaves(out[sec]) if "qc" not in p})
        want.update({f"{sec}.{p}": v for p, v in _leaves(ref[sec]) if "qc" not in p})
    assert set(got) == set(want)
    worst = {}
    for path, rv in want.items():
        scale = None
        if gate_semantics and path.endswith(".SNRdB"):
            err = np.abs(np.asarray(got[path]) - np.asarray(rv)).max() * np.log(10.0) / 20.0
            worst[path] = err
            continue
        if gate_semantics:
            head, _, leaf = path.rpartition(".")
            parent = (head + ".mean" if leaf == "std"
                      else f"{head}.{leaf[4:]}" if leaf.startswith("std_") else None)
            if parent in want:
                pv = np.asarray(want[parent], np.float64)
                scale = np.abs(pv[np.isfinite(pv)]).max()
        worst[path] = _rel_err(got[path], rv, scale)
    bad = {p: e for p, e in worst.items() if not e <= rtol}
    assert not bad, bad


@pytest.fixture(scope="module")
def stacks():
    return {
        np.float64: speckle_stack(T, (SIDE, SIDE), seed=np.random.default_rng(1234), dtype=np.float64),
        np.uint16: speckle_stack(T, (SIDE, SIDE), seed=np.random.default_rng(1234),
                                 dtype=np.uint16, mean_counts=8000.0),
    }


def test_float64_stack_matches_jax(stacks):
    st = stacks[np.float64]
    out = tdip.speckle_stack_stats(st, device="cpu", **KW)
    ref = jdip.speckle_stack_stats(st, **KW)
    assert out["meta"]["tracking"]["roi_size_yx"] == ref["meta"]["tracking"]["roi_size_yx"]
    assert out["meta"]["tracking"]["roi_step_yx"] == ref["meta"]["tracking"]["roi_step_yx"]
    for k, v in ref["meta"]["grain0"].items():
        np.testing.assert_allclose(out["meta"]["grain0"][k], v, rtol=1e-8)
    assert out["meta"].keys() == ref["meta"].keys()
    _compare(out, ref, rtol=1e-8, gate_semantics=False)


def test_uint16_stack_matches_jax_and_tracks(stacks):
    st = stacks[np.uint16]
    out = tdip.speckle_stack_stats(st, device="cpu", **KW)
    ref = jdip.speckle_stack_stats(st, **KW)
    assert out["meta"]["tracking"]["roi_size_yx"] == ref["meta"]["tracking"]["roi_size_yx"]
    _compare(out, ref, rtol=1e-4, gate_semantics=True)
    dys, dxs = spiral_motion(T)
    err = np.hypot(out["temporal"]["abs"]["dy"] - dys, out["temporal"]["abs"]["dx"] - dxs)
    assert np.nanmax(err) <= 0.05
    assert out["full"]["stats"]["mean"].dtype == np.float32


def test_tracking_grid_matches_jax(stacks):
    from barc4dip_tpu.metrics.speckles import tracking_grid_from_frame0 as j_grid
    from barc4dip_tpu_torch.metrics.speckles import tracking_grid_from_frame0 as t_grid

    for st in stacks.values():
        g, labels, side, step, _ = t_grid(st)
        rg, rlabels, rside, rstep, _ = j_grid(st)
        assert (side, step) == (rside, rstep)
        assert g.tolist() == rg.tolist()
        assert labels.tolist() == rlabels.tolist()


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(grain_maps=True), dict(checkpoint_dir=True),
     dict(tracking_search_radius=8.0), dict(tracking_method="phase")],
)
def test_uncovered_arguments_raise(stacks, kwargs, tmp_path):
    """``mesh`` composes with every other option: on a three-entry CPU mesh (chunks of 3 frames, one a
    shard) the run equals the unsharded run, and a checkpointed mesh run
    writes chunks under its own layout."""
    from barc4dip_tpu_torch.parallel import frame_mesh

    st = stacks[np.float64]
    kw = {**KW, **kwargs}
    if kw.get("checkpoint_dir"):
        kw["checkpoint_dir"] = tmp_path / "ckpt"
    single = tdip.speckle_stack_stats(st, device="cpu", **{**kw, "checkpoint_dir": None})
    sharded = tdip.speckle_stack_stats(st, device="cpu", mesh=frame_mesh(["cpu"] * 3), **kw)
    assert (tmp_path / "ckpt").exists() == bool(kwargs.get("checkpoint_dir"))
    for path, v in _leaves({k: single[k] for k in ("full", "tiles", "temporal") if k in single}):
        if "qc" in path or "autocorr" in path:
            continue
        got = _leaves_dict(sharded)[path]
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(v, float),
                                   rtol=1e-12, atol=1e-12, err_msg=path)


def _leaves_dict(out):
    return dict(_leaves({k: out[k] for k in ("full", "tiles", "temporal") if k in out}))


def test_bad_input_raises(stacks):
    with pytest.raises(TypeError):
        tdip.speckle_stack_stats([[[1.0]]], **KW)
    with pytest.raises(ValueError):
        tdip.speckle_stack_stats(torch.zeros(128, 128), **KW)
    with pytest.raises(ValueError):
        tdip.speckle_stack_stats(np.zeros((128, 128)), **KW)
    with pytest.raises(ValueError):
        tdip.speckle_stack_stats(stacks[np.float64], tracking_method="optical", **KW)
    with pytest.raises(TypeError, match="uint64"):
        tdip.speckle_stack_stats(torch.zeros(2, 128, 128, dtype=torch.uint64), **KW)


@pytest.fixture(scope="module")
def grid_stacks():
    kw = dict(seed=np.random.default_rng(1), mean_counts=8000.0)
    return {dt: speckle_stack(5, (SIDE, SIDE), dtype=dt, **kw) for dt in (np.float64, np.float32, np.uint16)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint16])
@pytest.mark.parametrize("origin", ["upper", "lower"])
@pytest.mark.parametrize("metrics,tiles", [("all", True), (["grain"], False),
                                           ("amplitude,stats", True), ("bandwidth", False)])
def test_options_grid_matches_jax(grid_stacks, dtype, origin, metrics, tiles):
    """Both packages across dtypes, display origins, tiling and metric
    subsets, with chunks of 2 that do not divide T = 5: the metric leaves
    at rtol 1e-8 (float64) or the bench gate's 1e-4 (float32 compute); the
    trajectories at 1e-8 of their scale (float64), else within 5e-3 px of
    the JAX package's and 1e-4 px of the port's own float64 run."""
    st = grid_stacks[dtype]
    kw = dict(metrics=metrics, tiles=tiles, display_origin=origin, grain_maps=False,
              frame_chunk=2, verbose=False)
    out = tdip.speckle_stack_stats(st, device="cpu", **kw)
    ref = jdip.speckle_stack_stats(st, **kw)
    assert out["meta"].keys() == ref["meta"].keys()
    if dtype == np.float64:
        _compare(out, ref, rtol=1e-8, gate_semantics=False)
        return
    metric_out = {k: v for k, v in out.items() if k != "temporal"}
    metric_ref = {k: v for k, v in ref.items() if k != "temporal"}
    _compare({**metric_out, "temporal": {}}, {**metric_ref, "temporal": {}}, rtol=1e-4,
             gate_semantics=True)
    own64 = tdip.speckle_stack_stats(st.astype(np.float64), device="cpu", **kw)
    for blk in ("abs", "inc"):
        for c in ("dy", "dx"):
            got = out["temporal"][blk][c]
            np.testing.assert_allclose(got, ref["temporal"][blk][c], rtol=0, atol=5e-3)
            np.testing.assert_allclose(got, own64["temporal"][blk][c], rtol=0, atol=1e-4)
