# SPDX-License-Identifier: CECILL-2.1
"""Port parity of ``models.full_step_fn``, the flagship per-chunk step
(flat-field, amplitude, grain, moments, abs/inc NCC tracking), against the
JAX one at B = 2 on 256^2 float64 frames: every output at rtol 1e-9 (atol
1e-9 px for the shifts), including the flat-field's ``den <= 0 -> 1``
guard on a few dead pixels."""
import numpy as np
import torch

import jax

from barc4dip_tpu.models.pipeline import full_step_fn as j_step_fn
from barc4dip_tpu_torch.geometry import roi_grid_3x3
from barc4dip_tpu_torch.metrics.tracking_batch import _grid_geometry
from barc4dip_tpu_torch.models import full_step_fn as t_step_fn
from tests.conftest import make_speckle

torch.set_num_threads(2)


def _inputs():
    rng = np.random.default_rng(2024)
    base = make_speckle(rng, shape=(256, 256), grain_px=5.0) * 1000.0
    frames = np.stack([np.roll(base, (t, -2 * t), axis=(0, 1)) for t in range(1, 3)])
    prevs = np.stack([base, frames[0]])
    flat = rng.normal(2.0, 0.05, size=(256, 256))
    dark = rng.normal(0.1, 0.01, size=(256, 256))
    flat[10, 20] = flat[200, 31] = 0.05  # flat - dark <= 0: the guard reads 1
    grid, _ = roi_grid_3x3((256, 256), (31, 31), (16, 16), center_yx=None)
    starts, _, s = _grid_geometry(grid)
    corrected0 = (base - dark) / np.where(flat - dark <= 0, 1.0, flat - dark)
    tpl0 = np.stack([corrected0[y : y + s, x : x + s] for y, x in starts])
    return frames * flat + dark, prevs * flat + dark, flat, dark, tpl0, starts, s


def test_full_step_fn_matches_jax():
    frames, prevs, flat, dark, tpl0, starts, s = _inputs()
    want = jax.device_get(jax.jit(j_step_fn(s, starts))(frames, prevs, flat, dark, tpl0))
    got = t_step_fn(s, starts)(*(torch.from_numpy(a) for a in (frames, prevs, flat, dark, tpl0)))
    assert got.keys() == want.keys()
    for g in ("amplitude", "grain", "stats"):
        assert got[g].keys() == want[g].keys(), g
        for k, w in want[g].items():
            np.testing.assert_allclose(got[g][k].numpy(), w, rtol=1e-9, atol=1e-12, err_msg=f"{g}.{k}")
    for k in ("dy_abs", "dx_abs", "dy_inc", "dx_inc"):
        assert got[k].shape == (2, 9)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-9, err_msg=k)
    # the motion is known: abs rolls by (t, -2t), inc by (1, -2)
    np.testing.assert_allclose(got["dy_abs"].numpy(), [[1] * 9, [2] * 9], atol=0.05)
    np.testing.assert_allclose(got["dx_inc"].numpy(), -2.0, atol=0.05)
