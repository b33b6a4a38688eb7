# SPDX-License-Identifier: CECILL-2.1
"""Port parity of the metric step: ``speckle_device_fn`` (all four groups,
full frame plus tiles) against the JAX one, leaf by leaf, on a float64
speckle field at rtol 1e-9; the port runs two frames as one batch."""
import numpy as np
import pytest
import torch

import jax

from barc4dip_tpu.metrics.speckles_device import speckle_device_fn as j_fn
from barc4dip_tpu_torch.metrics.speckles_device import int_value_hint
from barc4dip_tpu_torch.metrics.speckles_device import speckle_device_fn as t_fn
from tests.conftest import make_speckle

torch.set_num_threads(2)
GROUPS = frozenset({"amplitude", "grain", "stats", "bandwidth"})


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("mode", ["subtiles_9x9", "tiles_3x3"])
def test_speckle_device_fn_matches_jax(rng, mode):
    frames = np.stack([make_speckle(rng, shape=(288, 288), grain_px=5.0) for _ in range(2)])
    frames[1] *= 1000.0
    got = dict(_leaves(t_fn(GROUPS, mode, 65535.0, 1e-6)(torch.from_numpy(frames))))
    jit = jax.jit(j_fn(GROUPS, mode, 65535.0, 1e-6, False))
    for k in range(2):
        ref = dict(_leaves(jax.device_get(jit(frames[k]))))
        assert set(got) == set(ref)
        for path, rv in ref.items():
            rv = np.asarray(rv, np.float64)
            gv = got[path][k].numpy()
            assert gv.shape == rv.shape, path
            fin = np.isfinite(rv)
            np.testing.assert_array_equal(np.isfinite(gv), fin, err_msg=path)
            np.testing.assert_allclose(gv[fin], rv[fin], rtol=1e-9, atol=1e-12, err_msg=path)


def test_int_value_hint():
    assert int_value_hint(np.uint16) == (0, 65535)
    assert int_value_hint(np.int8) == (-128, 127)
    assert int_value_hint(np.float32) is None
    assert int_value_hint(np.int32) is None
