# SPDX-License-Identifier: CECILL-2.1
"""Stack registration: the port (``barc4dip_tpu_torch/preprocessing/
registration.py``) against the JAX package on the same seeded numpy
stacks, with the cases of tests/test_registration.py.

The frames are a band-limited speckle field translated by known shifts
plus white noise: phase correlation whitens the spectrum, and on
noise-free band-limited speckle most of it is round-off, so two float32
runs may pick different peaks. With the noise both packages measure the
same shifts within 1e-4 px and align to within 2e-5 of the frame's max.
``roll`` is bit-exact and chunk-invariant."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import barc4dip_tpu.preprocessing as jpre
import barc4dip_tpu_torch.preprocessing as tpre
from barc4dip_tpu.utils.synthetic import speckle_field

torch.set_num_threads(2)
CPU = dict(device="cpu")  # the port runs on the CPU only where it is asked to
SHIFT_TOL = 1e-4
ALIGN_TOL = 2e-5

SHIFTS_INT = [(0, 0), (3, -2), (-5, 7), (10, 4)]
SHIFTS_SUB = [(0.0, 0.0), (1.3, -2.6), (-3.4, 4.75), (6.2, -0.8)]
DRIFT = [(0.0, 0.0), (1.2, -0.7), (2.5, -1.3), (3.9, -2.2), (5.1, -2.8)]


def _field(n=96, seed=3):
    f = speckle_field((n, n), grain_px=6.0, seed=seed).astype(np.float32)
    return f / f.mean()


def _noisy(stack, seed=11, sigma=0.05):
    rng = np.random.default_rng(seed)
    return (stack + rng.normal(0, sigma, size=stack.shape)).astype(np.float32)


def _roll_stack(ref, shifts):
    return np.stack([np.roll(ref, (int(dy), int(dx)), axis=(0, 1)) for dy, dx in shifts])


def _fourier_stack(ref, shifts):
    fy = np.fft.fftfreq(ref.shape[0])[:, None]
    fx = np.fft.fftfreq(ref.shape[1])[None, :]
    F = np.fft.fft2(ref)
    return np.stack(
        [np.fft.ifft2(F * np.exp(-2j * np.pi * (fy * dy + fx * dx))).real for dy, dx in shifts]
    ).astype(np.float32)


def _compare(got, want):
    (ga, gs), (wa, ws) = got, want
    ga = ga.numpy() if isinstance(ga, torch.Tensor) else ga
    wa = np.asarray(wa)
    assert ga.shape == wa.shape and ga.dtype == np.float32
    assert gs["reference"] == ws["reference"]
    assert gs["dy"].dtype == gs["dx"].dtype == np.float32
    np.testing.assert_allclose(gs["dy"], ws["dy"], rtol=0, atol=SHIFT_TOL)
    np.testing.assert_allclose(gs["dx"], ws["dx"], rtol=0, atol=SHIFT_TOL)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=ALIGN_TOL * np.abs(wa).max())


def test_integer_shifts_roll_mode_exact_roundtrip():
    ref = _field()
    stack = _roll_stack(ref, SHIFTS_INT)
    kw = dict(reference="first", subpixel=False, shift_mode="roll", frame_chunk=3)
    aligned, shifts = tpre.register_stack(stack, **kw, **CPU)
    np.testing.assert_array_equal(shifts["dy"], [s[0] for s in SHIFTS_INT])
    np.testing.assert_array_equal(shifts["dx"], [s[1] for s in SHIFTS_INT])
    np.testing.assert_array_equal(aligned, np.broadcast_to(ref, stack.shape))
    _compare((aligned, shifts), jpre.register_stack(stack, **kw))


MEAN_SHIFTS = [(-2.0, 1.0), (0.0, 0.0), (2.0, -1.0)]
CASE_SHIFTS = {"first": SHIFTS_SUB, "mean": MEAN_SHIFTS, "previous": DRIFT}


@pytest.mark.parametrize("reference", ["first", "mean", "previous"])
@pytest.mark.parametrize("shift_mode", ["fourier", "roll"])
def test_register_matches_the_jax_package(reference, shift_mode):
    stack = _noisy(_fourier_stack(_field(), CASE_SHIFTS[reference]))
    kw = dict(reference=reference, shift_mode=shift_mode, frame_chunk=2)
    got = tpre.register_stack(stack, **kw, **CPU)
    assert isinstance(got[0], np.ndarray)
    _compare(got, jpre.register_stack(stack, **kw))


@pytest.mark.parametrize("reference", ["first", "mean", "previous"])
def test_register_recovers_known_shifts(reference):
    """The noise-free cases of tests/test_registration.py on the port:
    "first" within 0.05 px, "previous" within 0.08 (its errors add over
    frames), "mean" in the pairwise differences within 0.1 px."""
    ref = _field()
    shifts = np.array(CASE_SHIFTS[reference])
    aligned, got = tpre.register_stack(_fourier_stack(ref, shifts), reference=reference,
                                       frame_chunk=2, **CPU)
    d = np.stack([got["dy"], got["dx"]], axis=1)
    if reference == "mean":
        np.testing.assert_allclose(d - d[1], shifts - shifts[1], atol=0.1)
        return
    assert np.hypot(*(d - shifts).T).max() < (0.08 if reference == "previous" else 0.05)
    assert got["dy"][0] == got["dx"][0] == 0.0
    err = np.abs(aligned - ref[None]).max() / np.abs(ref).max()
    assert err < (0.03 if reference == "previous" else 0.02), err


@pytest.mark.parametrize("upsample_factor, subpixel", [(1, True), (7, True), (20, False)])
def test_upsample_factor_and_integer_measurement(upsample_factor, subpixel):
    stack = _noisy(_fourier_stack(_field(seed=4), SHIFTS_SUB), seed=12)
    kw = dict(upsample_factor=upsample_factor, subpixel=subpixel, frame_chunk=3)
    _compare(tpre.register_stack(stack, **kw, **CPU), jpre.register_stack(stack, **kw))


def test_tensor_input_stays_a_tensor_and_matches_numpy():
    stack = _noisy(_fourier_stack(_field(), SHIFTS_SUB))
    a_np, s_np = tpre.register_stack(stack, frame_chunk=2, **CPU)
    for reference in ("first", "mean", "previous"):
        a_t, s_t = tpre.register_stack(torch.from_numpy(stack), reference=reference, frame_chunk=2)
        assert isinstance(a_t, torch.Tensor) and a_t.dtype == torch.float32
        if reference == "first":
            np.testing.assert_array_equal(a_t.numpy(), a_np)
            np.testing.assert_array_equal(s_t["dy"], s_np["dy"])
        _compare((a_t, s_t), jpre.register_stack(jnp.asarray(stack), reference=reference, frame_chunk=2))


def test_shift_stack_fourier_matches_numpy_and_jax():
    ref = _field(n=64)
    ours = tpre.shift_stack(ref, 2.3, -1.7, **CPU)  # 2D single-frame path
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, _fourier_stack(ref, [(2.3, -1.7)])[0], atol=2e-5)
    np.testing.assert_allclose(ours, np.asarray(jpre.shift_stack(ref, 2.3, -1.7)), rtol=0,
                               atol=ALIGN_TOL * np.abs(ref).max())


def test_shift_stack_roll_is_lossless_and_chunk_invariant():
    ref = _field(n=64)
    stack = np.stack([ref, ref * 2.0, ref + 1.0, ref - 0.5, ref * 0.3])
    dy = np.array([1, -2, 0, 5, -7.5], np.float32)  # -7.5 rounds half to even: -8
    dx = np.array([-3, 4, 0.5, -1, 6], np.float32)  # 0.5 rounds to 0
    a = tpre.shift_stack(stack, dy, dx, shift_mode="roll", frame_chunk=2, **CPU)
    b = tpre.shift_stack(torch.from_numpy(stack), dy, dx, shift_mode="roll", frame_chunk=5).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, np.asarray(jpre.shift_stack(stack, dy, dx, shift_mode="roll", frame_chunk=2)))
    for t in range(5):
        np.testing.assert_array_equal(
            a[t], np.roll(stack[t], (int(np.round(dy[t])), int(np.round(dx[t]))), axis=(0, 1))
        )


def test_register_then_speckle_stack_chain():
    """Align, then compute stack metrics on the registered frames: the
    residual temporal drift is ~0."""
    from barc4dip_tpu_torch.metrics import speckle_stack_stats

    stack = _fourier_stack(_field(n=128), SHIFTS_SUB)
    aligned, _ = tpre.register_stack(stack, **CPU)
    out = speckle_stack_stats(
        np.ascontiguousarray(aligned), metrics=("grain",), tiles=False,
        verbose=False, grain_maps=False, device="cpu",
    )
    r = np.hypot(out["temporal"]["abs"]["dy"], out["temporal"]["abs"]["dx"])
    assert np.nanmax(r) < 0.1, r


def test_validation_errors():
    ref = _field(n=32)
    pair = np.stack([ref, ref])
    cases = [
        (lambda p: p.register_stack(pair, reference="nope"), ValueError),
        (lambda p: p.register_stack(pair, shift_mode="nope"), ValueError),
        (lambda p: p.register_stack(ref), ValueError),
        (lambda p: p.register_stack(pair[:0]), ValueError),
        (lambda p: p.register_stack(pair, upsample_factor=0), ValueError),
        (lambda p: p.shift_stack(ref, 1.0, 1.0, shift_mode="nope"), ValueError),
        (lambda p: p.shift_stack(ref[None, None], 1.0, 1.0), ValueError),
    ]
    for call, err in cases:
        with pytest.raises(err) as jerr:
            call(jpre)
        with pytest.raises(err) as terr:
            call(tpre)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="expects a numpy.ndarray or torch.Tensor"):
        tpre.register_stack([[1.0]])
