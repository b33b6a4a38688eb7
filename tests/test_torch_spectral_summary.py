# SPDX-License-Identifier: CECILL-2.1
"""Port parity: ``spectral_summary``, ``spectral_summary_stack`` and
``pull_centrosymmetric`` of ``barc4dip_tpu_torch.signal`` against the JAX
package's on the same seeded numpy input (CPU, ``device="cpu"``), and
against the port's own separate calls.

Tolerances: float64 images against JAX x64 at rtol 1e-9 of each map's or
curve's peak, float32 and integer images (both compute in float32) at 2e-5;
host axes exactly equal. On the CPU the summary equals the port's composed
calls exactly (the ring sums add in a fixed order there).
"""
import numpy as np
import pytest
import torch

from barc4dip_tpu import signal as j_sig
from barc4dip_tpu.ops import symmetry as j_sym
from barc4dip_tpu_torch import maths as t_maths
from barc4dip_tpu_torch import signal as t_sig
from barc4dip_tpu_torch.ops import cuda_fftp
from barc4dip_tpu_torch.ops import symmetry as t_sym
from tests.conftest import make_speckle
from tests.test_torch_ops import close

torch.set_num_threads(2)
F64, F32 = 1e-9, 2e-5
CPU = {"device": "cpu"}
MAPS = ("psd", "autocorr")
CURVES = ("radial_binned", "radial_interpolated")
AXES = ("fx", "fy", "xlag", "ylag", "r_binned", "r_interpolated")


@pytest.mark.parametrize("shape", [(96, 80), (128, 128), (65, 77)])
@pytest.mark.parametrize("kind", ["float64", "float32", "uint16"])
def test_spectral_summary_every_key(rng, shape, kind):
    img = (make_speckle(rng, shape=shape, grain_px=4.0) * 3000 + 200).astype(kind)
    tol = F64 if kind == "float64" else F32
    kw = dict(dx=0.5, dy=0.25)
    got = t_sig.spectral_summary(img, **kw, **CPU)
    want = j_sig.spectral_summary(img.astype(np.float32) if kind == "uint16" else img, **kw)
    assert sorted(got) == sorted(want) == sorted(MAPS + CURVES + AXES)
    for k in MAPS:
        assert isinstance(got[k], torch.Tensor)
        close(got[k], want[k], tol)
    for k in CURVES:
        assert isinstance(got[k], np.ndarray)
        close(got[k], want[k], tol)
    for k in AXES:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("scale", [True, False])
def test_spectral_summary_equals_the_separate_calls(rng, scale):
    img = rng.normal(size=(96, 80)).astype(np.float32) + 2.0
    x, y = np.arange(80) * 0.5, np.arange(96) * 0.25
    s = t_sig.spectral_summary(img, x=x, y=y, scale=scale, **CPU)
    P, fx, fy = t_sig.psd2d(img, x=x, y=y, scale=scale, **CPU)
    ac, xlag, ylag = t_sig.autocorr2d(img, x=x, y=y, **CPU)
    rb, r_b = t_maths.radial_mean_binned(ac)
    ri, r_i = t_maths.radial_mean_interpolated(ac)
    assert torch.equal(s["psd"], P) and torch.equal(s["autocorr"], ac)
    for got, want in ((s["fx"], fx), (s["fy"], fy), (s["xlag"], xlag), (s["ylag"], ylag),
                      (s["radial_binned"], rb.numpy()), (s["radial_interpolated"], ri.numpy()),
                      (s["r_binned"], r_b.numpy().astype(np.float64)),
                      (s["r_interpolated"], r_i.numpy().astype(np.float64))):
        np.testing.assert_array_equal(got, want)


def test_spectral_summary_errors_match_jax(rng):
    for arg in (np.zeros((2, 8, 8)), np.zeros((8, 8), np.complex64)):
        with pytest.raises(ValueError) as want:
            j_sig.spectral_summary(arg)
        with pytest.raises(ValueError) as got:
            t_sig.spectral_summary(arg, **CPU)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="real-valued"):
        t_sig.spectral_summary(torch.zeros(8, 8, dtype=torch.complex64))
    r1 = t_sig.spectral_summary(np.ones((16, 16), np.float32), **CPU)["r_binned"]
    r1[:] = -1.0  # the caller's copy: the cached geometry stays as it was
    assert t_sig.spectral_summary(np.ones((16, 16), np.float32), **CPU)["r_binned"][0] == 0.5


def _stack(rng, T=5, shape=(160, 192)):
    base = make_speckle(rng, shape=shape, grain_px=4.0)
    return np.stack([base * (1 + 0.1 * k) for k in range(T)]) * 4000.0


@pytest.mark.parametrize("kind, chunk", [("float32", 2), ("float32", 8), ("uint16", 3), ("float64", 2)])
def test_spectral_summary_stack_against_jax(rng, kind, chunk):
    """T = 5: chunks of 2 and 3 leave a tail, a chunk of 8 holds all."""
    stack = _stack(rng).astype(kind)
    got = t_sig.spectral_summary_stack(stack, frame_chunk=chunk, **CPU)
    want = j_sig.spectral_summary_stack(stack, frame_chunk=chunk)
    assert sorted(got) == sorted(want)
    for k in CURVES:
        assert got[k].shape == want[k].shape and got[k].shape[0] == 5
        close(got[k], want[k], F32)  # the JAX stack call computes in float32
    for k in ("r_binned", "r_interpolated"):
        np.testing.assert_array_equal(got[k], want[k])
    # each frame equals its own single-image call
    for k_frame in (0, 2, 4):
        single = t_sig.spectral_summary(stack[k_frame], **CPU)
        for k in CURVES:
            close(got[k][k_frame], single[k], 1e-6 if kind != "float64" else 1e-12)


def test_spectral_summary_stack_tensor_uint16_and_chunk_sizes_agree(rng):
    stack = _stack(rng, T=5, shape=(128, 128)).astype(np.uint16)
    host = t_sig.spectral_summary_stack(stack, frame_chunk=2, **CPU)
    dev = t_sig.spectral_summary_stack(torch.from_numpy(stack), frame_chunk=2)  # sliced where it lives
    as_f32 = t_sig.spectral_summary_stack(stack.astype(np.float32), frame_chunk=2, **CPU)
    for k in CURVES:
        np.testing.assert_array_equal(host[k], dev[k])
        np.testing.assert_array_equal(host[k], as_f32[k])  # uint16 -> float32 is lossless
        assert host[k].dtype == np.float32
    whole = t_sig.spectral_summary_stack(stack, frame_chunk=8, **CPU)
    for k in CURVES:
        close(whole[k], host[k], 1e-6)
    assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0, "cols_cluster": 0}  # CPU tensors: the plain version


def test_spectral_summary_stack_errors():
    with pytest.raises(ValueError, match="3D"):
        t_sig.spectral_summary_stack(np.zeros((8, 8), np.float32), **CPU)
    # under a mesh: the same curves
    from barc4dip_tpu_torch.parallel import frame_mesh

    frames = np.random.default_rng(5).random((3, 16, 16))
    sharded = t_sig.spectral_summary_stack(frames, mesh=frame_mesh(["cpu"] * 2), frame_chunk=2, **CPU)
    single = t_sig.spectral_summary_stack(frames, frame_chunk=2, **CPU)
    np.testing.assert_allclose(sharded["radial_binned"], single["radial_binned"], rtol=1e-12)
    with pytest.raises(ValueError, match="dx and dy"):
        t_sig.spectral_summary_stack(np.zeros((2, 8, 8), np.float32), dx=0.0, **CPU)


# -- pull_centrosymmetric ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (63, 64), (64, 62), (63, 61)])
@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_pull_matches_full_pull_and_jax(shape, kind):
    img = np.random.default_rng(5).normal(size=shape).astype(kind)
    for (dev_map, _, _), (j_map, _, _) in ((t_sig.psd2d(img, **CPU), j_sig.psd2d(img)),
                                           (t_sig.autocorr2d(img, **CPU), j_sig.autocorr2d(img))):
        full = dev_map.numpy()
        half = t_sig.pull_centrosymmetric(dev_map)
        assert half.shape == full.shape and half.dtype == full.dtype
        np.testing.assert_allclose(half, full, rtol=0, atol=200 * np.finfo(full.dtype).eps * np.abs(full).max())
        close(half, j_sig.pull_centrosymmetric(j_map), F64 if kind == "float64" else F32)


@pytest.mark.parametrize("shape", [(96, 96), (65, 80), (3, 32, 48)])
def test_pull_u16_within_half_a_code(shape):
    img = np.random.default_rng(7).normal(size=shape)
    ac = torch.stack([t_sig.autocorr2d(f, **CPU)[0] for f in img.reshape(-1, *shape[-2:])]).reshape(shape)
    exact = t_sig.pull_centrosymmetric(ac)
    coded = t_sig.pull_centrosymmetric(ac, quantize="u16")
    assert coded.dtype == np.float32 and coded.shape == exact.shape
    half = exact[..., : t_sym.HALF_ROWS(shape[-2]), :]
    span = half.max() - half.min()
    # round-to-nearest code, then float32 arithmetic on the host
    assert np.abs(coded - exact).max() <= span / (2 * 65535) * (1 + 1e-3) + 4 * np.finfo(np.float32).eps
    if len(shape) == 2:
        want = j_sig.pull_centrosymmetric(j_sig.autocorr2d(img)[0], quantize="u16")
        np.testing.assert_allclose(coded, want, rtol=0, atol=span / 65535 * 1.001)
    with pytest.raises(ValueError, match="quantize must be"):
        t_sig.pull_centrosymmetric(ac, quantize="u8")


def test_pull_u16_codes_cover_the_whole_range():
    """A ramp from lo to hi uses code 0, code 65535 and the codes above
    32767 that a signed 16-bit narrowing would wrap."""
    ramp = torch.linspace(-3.0, 5.0, 65536, dtype=torch.float64).reshape(1, -1).repeat(2, 1)
    got = t_sym.pull_centrosymmetric(ramp, quantize="u16")
    np.testing.assert_allclose(got[0], ramp[0].numpy(), rtol=0, atol=8.0 / (2 * 65535) * 1.01)
    flat = t_sym.pull_centrosymmetric(torch.full((4, 6), 2.5), quantize="u16")
    np.testing.assert_array_equal(flat, np.full((4, 6), 2.5, np.float32))  # hi == lo: span 1, codes 0


def test_mirror_rectangular_batched_and_validation():
    rng = np.random.default_rng(6)
    for N0, N1 in ((32, 48), (33, 48), (32, 47), (33, 47)):
        half = rng.normal(size=(3, t_sym.HALF_ROWS(N0), N1))
        np.testing.assert_array_equal(
            t_sym.mirror_centrosymmetric(half, N0), j_sym.mirror_centrosymmetric(half, N0))
        assert t_sym.HALF_ROWS(N0) == j_sym.HALF_ROWS(N0)
    for mod in (j_sym, t_sym):
        with pytest.raises(ValueError, match="half map"):
            mod.mirror_centrosymmetric(np.zeros((5, 16)), 16)
