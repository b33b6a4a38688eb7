# SPDX-License-Identifier: CECILL-2.1
"""Kernel K1's module (``barc4dip_tpu_torch/ops/cuda_fftp.py``) against the
TPU kernel it replaces (``barc4dip_tpu/ops/pallas_fftp.py``).

The JAX kernel runs in Pallas interpret mode on the CPU with the MXU-FFT
knob forced on, as tests/test_mxufft.py runs it; the port takes its plain
versions, because the tensors lie on the CPU. Both see the same image and
templates. The CUDA kernel itself is held against the plain versions on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from barc4dip_tpu.ops import ncc as j_ncc
from barc4dip_tpu.ops import pallas_fftp
from barc4dip_tpu_torch.ops import cuda_fftp
from barc4dip_tpu_torch.ops import ncc as t_ncc
from barc4dip_tpu_torch.ops.phasecorr import argmax2d

torch.set_num_threads(2)

H = W = 256
S = 21


@pytest.fixture()
def case(rng, monkeypatch):
    """A 256^2 f32 image and a bank of 3 f32 21-px templates, prepared by
    both packages (the JAX side in permuted order, through the MXU path).

    As in the tracker, the templates are cut from the image, so each map
    peaks near 1: both float32 paths sit about 1e-6 from a float64
    reference in absolute terms, whatever a map's maximum."""
    monkeypatch.setenv("BARC4DIP_TPU_MXU_FFT", "1")
    img = rng.normal(size=(H, W)).astype(np.float32)
    tiles = np.stack([img[40:40 + S, 30:30 + S], img[100:100 + S, 200:200 + S],
                      img[5:5 + S, 5:5 + S]])
    jprep = j_ncc.zncc_prepare_image(jnp.asarray(img), S, S)
    jbank = jax.vmap(lambda x: j_ncc.prep_template(x, H, W))(jnp.asarray(tiles))
    tprep = t_ncc.zncc_prepare_image(torch.from_numpy(img), S, S)
    tbank = t_ncc.prep_template(torch.from_numpy(tiles), H, W)
    return jprep, jbank, tprep, tbank


def test_ncc_bank_masked_peaks_vs_pallas_interpret(case):
    jprep, jbank, tprep, tbank = case
    var_full = jnp.pad(jprep["var_sum"], ((0, S - 1), (0, S - 1)))
    ref, riy, rix = pallas_fftp.ncc_masked_peaks_from_spectra(
        jprep["Fre"], jprep["Fim"], jbank["Ftre"], jbank["Ftim"], var_full,
        jbank["energy"], valid_hw=(H - S + 1, W - S + 1), interpret=True,
    )
    maps, iy, ix, vb = t_ncc.ncc_bank_masked_peaks(tprep, tbank)
    assert vb == (H - S + 1, W - S + 1)
    ref = np.asarray(ref)
    maps = maps.numpy()
    for k in range(3):
        valid = np.isfinite(ref[k])
        np.testing.assert_array_equal(np.isfinite(maps[k]), valid)
        np.testing.assert_allclose(
            maps[k][valid], ref[k][valid], rtol=0, atol=5e-6 * np.abs(ref[k][valid]).max()
        )
    np.testing.assert_array_equal(iy.numpy(), np.asarray(riy))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(rix))
    assert [(int(a), int(b)) for a, b in zip(iy, ix)] == [(40, 30), (100, 200), (5, 5)]


def test_corr_from_rfft_vs_pallas_interpret(case):
    jprep, jbank, tprep, tbank = case
    ref = np.asarray(pallas_fftp.corr_from_spectra(
        jprep["Fre"], jprep["Fim"], jbank["Ftre"], jbank["Ftim"], interpret=True
    ))
    got = cuda_fftp.corr_from_rfft(tprep["F"], tbank["Ft"], s=(H, W)).numpy()
    assert got.shape == ref.shape == (3, H, W)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 * np.abs(ref).max())


def test_float64_vs_jax_cpu_fallback(rng, monkeypatch):
    """float64 never reaches a kernel in either package: the port's plain
    versions against the JAX natural-order composition at 1e-9."""
    monkeypatch.setenv("BARC4DIP_TPU_MXU_FFT", "0")
    img = rng.normal(size=(160, 128))
    tiles = rng.normal(size=(2, 17, 17))
    jprep = j_ncc.zncc_prepare_image(jnp.asarray(img), 17, 17)
    jbank = jax.vmap(lambda x: j_ncc.prep_template(x, 160, 128))(jnp.asarray(tiles))
    ref, riy, rix, rvb = j_ncc.ncc_bank_masked_peaks(jprep, jbank)
    tprep = t_ncc.zncc_prepare_image(torch.from_numpy(img), 17, 17)
    tbank = t_ncc.prep_template(torch.from_numpy(tiles), 160, 128)
    maps, iy, ix, vb = t_ncc.ncc_bank_masked_peaks(tprep, tbank)
    assert vb == rvb == (144, 112)
    ref = np.asarray(ref)
    valid = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(maps.numpy()), valid)
    np.testing.assert_allclose(maps.numpy()[valid], ref[valid], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(iy.numpy(), np.asarray(riy))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(rix))


def test_bank_layouts_agree(rng):
    """A bank shared by every image and one bank per image give the same
    planes; a 2-D image spectrum drops the image axis."""
    imgs = torch.from_numpy(rng.normal(size=(2, 128, 128)))
    tiles = torch.from_numpy(rng.normal(size=(3, 15, 15)))
    prep = t_ncc.zncc_prepare_image(imgs, 15, 15)
    bank = t_ncc.prep_template(tiles, 128, 128)
    shared = cuda_fftp.corr_from_rfft(prep["F"], bank["Ft"], s=(128, 128))
    per_image = cuda_fftp.corr_from_rfft(
        prep["F"], bank["Ft"][None].expand(2, -1, -1, -1), s=(128, 128)
    )
    single = cuda_fftp.corr_from_rfft(prep["F"][1], bank["Ft"], s=(128, 128))
    assert shared.shape == (2, 3, 128, 128) and single.shape == (3, 128, 128)
    torch.testing.assert_close(shared, per_image, rtol=0, atol=0)
    torch.testing.assert_close(shared[1], single, rtol=0, atol=0)

    var_full = torch.nn.functional.pad(prep["var_sum"], (0, 14, 0, 14))
    maps, iy, ix = cuda_fftp.ncc_masked_peaks(
        prep["F"], bank["Ft"], var_full, bank["energy"], valid_hw=(114, 114), s=(128, 128)
    )
    assert maps.shape == (2, 3, 128, 128) and iy.shape == (2, 3)
    ai, aj = argmax2d(maps)
    assert torch.equal(iy, ai) and torch.equal(ix, aj)
    with pytest.raises(ValueError):
        cuda_fftp.corr_from_rfft(prep["F"], bank["Ft"][None], s=(128, 128))


@pytest.mark.parametrize(
    "shape, covered",
    [((128, 128), True), ((2048, 2048), True), ((4096, 256), True), ((64, 64), False),
     ((227, 227), False), ((8192, 8192), True), ((2048, 1024 + 512), True)],
)
def test_supported_shapes(shape, covered):
    assert cuda_fftp.supported(shape) is covered


SIDES = [64, 127, 227, 228] + [128 * k for k in range(1, 66)]


def test_supported_equals_the_tpu_gate():
    """Every side and pair of sides of the sweep, square and not, and the
    batched and too-short shapes: the port's gate is the TPU kernel's."""
    shapes = [(n, n) for n in SIDES] + [(a, b) for a in SIDES for b in SIDES[::7]]
    shapes += [(3, 1536, 2560), (2, 8192, 8320), (4096,), ()]
    for shape in shapes:
        assert cuda_fftp.supported(shape) is pallas_fftp.supported(shape), shape


def test_cpu_tensors_never_touch_the_kernel(rng):
    cuda_fftp.reset_counts()
    F = torch.fft.rfft2(torch.from_numpy(rng.normal(size=(1, 256, 256)).astype(np.float32)))
    cuda_fftp.corr_from_rfft(F, F[:, None], s=(256, 256))
    assert cuda_fftp.LAUNCHES == {"cols": 0, "rows": 0, "rows_ncc": 0, "cols_cluster": 0}
    assert cuda_fftp.PLAIN_BY_SHAPE == {}


# -- the kernel's radix plan, run in numpy float64 ---------------------------
# These mirror csrc/stockham_fft.cuh and the loads of csrc/fftp_corr.cu index
# for index (thread t holds v[t, i] = x[t + i*T]), with the stage twiddles
# cuda_fftp builds for the card, so the index algebra is checked where there
# is no nvcc.

def _register_dft(a):
    """The kernel's in-register R-point inverse DFT of a[..., q], q < R:
    radix-2 steps after a bit reversal, twiddles exp(+2*pi*i*k/16)."""
    R = a.shape[-1]
    bits = R.bit_length() - 1
    a = a[..., [int(f"{i:0{bits}b}"[::-1], 2) for i in range(R)]].copy()
    half = 1
    while half < R:
        for i in range(0, R, 2 * half):
            for k in range(half):
                u = a[..., i + k].copy()
                w = a[..., i + k + half] * np.exp(2j * np.pi * k * (8 // half) / 16)
                a[..., i + k] = u + w
                a[..., i + k + half] = u - w
        half *= 2
    return a


def _odd_butterfly(a):
    """The kernel's in-register R-point inverse DFT of a[..., q], q < R = 3,
    5, 7 (stockham::dft_odd): s_k = a[k] + a[R-k], d_k = a[k] - a[R-k],
    outputs p and R - p = a[0] + sum_k cos(2*pi*k*p/R) s_k +- i sum_k
    sin(2*pi*k*p/R) d_k."""
    R = a.shape[-1]
    h = R // 2
    s = [a[..., k] + a[..., R - k] for k in range(1, h + 1)]
    d = [a[..., k] - a[..., R - k] for k in range(1, h + 1)]
    out = np.empty_like(a)
    out[..., 0] = a[..., 0] + sum(s)
    for p in range(1, h + 1):
        re = a[..., 0] + sum(np.cos(2 * np.pi * k * p / R) * s[k - 1] for k in range(1, h + 1))
        im = sum(np.sin(2 * np.pi * k * p / R) * d[k - 1] for k in range(1, h + 1))
        out[..., p] = re + 1j * im
        out[..., R - p] = re - 1j * im
    return out


def _rev_digits(kd, odd, upto):
    """stockham::rev_digits: odd digits 0..upto-1 of kd (least significant
    first, radix odd[l]), digit l placed at m / (odd[0] * ... * odd[l]); the
    last digit taken whole."""
    m = int(np.prod(odd))
    out, pre = 0, 1
    for lv in range(upto):
        pre *= odd[lv]
        out = out + (kd if lv == upto - 1 else kd % odd[lv]) * (m // pre)
        kd = kd // odd[lv]
    return out


def _pows(hi, lo, r, R):
    """stockham::twiddle's w^q, q < R, w = exp(2*pi*i*r/n): each w^(2^b)
    from the tables at e = r * 2^b (hi[e >> 4] * lo[e mod 16]), w^q the
    product of those of q's bits."""
    base = [hi[(r << b) >> 4] * lo[(r << b) & 15] for b in range(4) if 1 << b < R]
    out = [np.ones_like(r, complex)]
    for q in range(1, R):
        out.append(np.prod([base[b] for b in range(4) if q >> b & 1], axis=0))
    return np.stack(out, -1)


def _register_route(y, n, tw, off):
    """The register route after the power-of-two stages but the last (the
    exchange y (..., n) holds their output, slot = logical index): the odd
    stages in place (slot of logical b*Ns + k = (b + PL * rev(k / NP)) * NP
    + k mod NP; stage twiddles from the stage's part of the table), then the
    last power-of-two stage (radix PL) reads v[t, i] = input t + i*T
    through that permutation, twiddles butterfly j by exp(2*pi*i*q*j/n)
    from hi and lo and leaves its outputs in natural order. Each odd stage's
    butterflies touch each slot once."""
    a = (n & -n).bit_length() - 1
    m, T = n >> a, n // 16
    odd = cuda_fftp.odd_radices(m)
    pow2 = cuda_fftp.radix_plan(1 << a)
    PL, NP = pow2[-1], (1 << a) // pow2[-1]
    hi = tw[off + NP * (m - 1) : off + NP * (m - 1) + n // 16]
    lo = tw[off + NP * (m - 1) + n // 16 : off + NP * (m - 1) + n // 16 + 16]
    assert lo.size == 16
    t = np.arange(T)
    y = y.copy()
    for I, R in enumerate(odd):
        pre = int(np.prod(odd[:I]))
        NS, span, NB = NP * pre, PL * m // (pre * R), n // R
        part = tw[off + NP * (pre - 1) : off + NP * (pre - 1) + (R - 1) * NS]
        seen = np.zeros(n, int)
        for u in range(-(-NB // T)):  # j = t + u*T, the last turn for the first threads only
            j = t + u * T
            j = j[j < NB]
            k = j % NS
            base = (j // NS + PL * _rev_digits(k // NP, odd, I)) * NP + (k & (NP - 1))
            slot = base[:, None] + np.arange(R)[None, :] * span * NP
            seen[slot] += 1
            w = np.stack([np.ones(k.shape, complex)] + [part[(q - 1) * NS + k] for q in range(1, R)], -1)
            y[..., slot] = _odd_butterfly(y[..., slot] * w)
        assert (seen == 1).all()
    n_in = t[:, None] + np.arange(16)[None, :] * T
    nd = n_in // NP
    v = y[..., (nd // m + PL * _rev_digits(nd % m, odd, len(odd))) * NP + (n_in & (NP - 1))]
    MU = 16 // PL
    for u in range(MU):
        cols = u + MU * np.arange(PL)
        v[..., cols] = _register_dft(v[..., cols] * _pows(hi, lo, t + u * T, PL))
    return v, off + NP * (m - 1) + hi.size + lo.size


def _stages(v, n):
    """stockham::run from the register state v (..., T, 16) of stage 0's
    input to that of the output: out[t + i*T] = v[t, i]. The odd factor m
    runs on its route: the register radices of odd_radices(m) between the
    last two power-of-two stages (radix_plan of 2^a), or the direct stage
    after them."""
    T = n // 16
    t = np.arange(T)
    slots = t[:, None] + np.arange(16)[None, :] * T
    tw = cuda_fftp.stage_twiddles(n)
    a = (n & -n).bit_length() - 1
    plan = cuda_fftp.radix_plan(1 << a)
    odd = n >> a
    register = odd > 1 and cuda_fftp.odd_radices(odd) is not None
    ns, off = 1, 0
    v = v.copy()
    if register and len(plan) == 1:  # one power-of-two stage: the odd stages first
        v, off = _register_route(_unload(v, n), n, tw, off)
        plan = []
    for s, r in enumerate(plan):
        M = 16 // r
        for m in range(M):
            if s:
                k = (t + m * T) % ns
                for q in range(1, r):
                    v[..., m + q * M] *= tw[off + (q - 1) * ns + k]
            cols = m + M * np.arange(r)
            v[..., cols] = _register_dft(v[..., cols])
        if s:
            off += (r - 1) * ns
        if register and s + 2 == len(plan):  # the exchange, then the odd stages and the last stage
            y = np.empty(v.shape[:-2] + (n,), complex)
            for m in range(M):
                j = t + m * T
                for q in range(r):
                    y[..., (j // ns) * ns * r + j % ns + q * ns] = v[..., m + q * M]
            v, off = _register_route(y, n, tw, off)
            break
        if ns * r < n:  # the exchange through shared memory
            y = np.empty(v.shape[:-2] + (n,), complex)
            for m in range(M):
                j = t + m * T
                base = (j // ns) * ns * r + j % ns
                for q in range(r):
                    y[..., base + q * ns] = v[..., m + q * M]
            v = y[..., slots]
        ns *= r
    if odd > 1 and not register:  # the direct stage: m-term sums out of the exchange
        y = _unload(v, n)  # the exchange holds the power-of-two stages' output
        n_out = slots  # output index of v[t, i]
        j = n_out % ns
        v = y[..., j].copy()
        for q in range(1, odd):
            v += y[..., j + q * ns] * tw[off + (q * n_out) % n]
        off += n
    assert off == tw.size
    return v


def _unload(v, n):
    T = n // 16
    out = np.empty(v.shape[:-2] + (n,), complex)
    out[..., np.arange(T)[:, None] + np.arange(16)[None, :] * T] = v
    return out


def _cluster_cols(x, n):
    """corr_cols_cluster's length-n transform of x (..., n), n > 2048: rank j
    of the cluster (n = Q*L) loads rows j + Q*n2 into the register layout
    (thread t holds v[t, i] = x[j + Q*(t + i*T)], T = L/16), runs the
    length-L stages, multiplies output k2 by the cross twiddle at entry
    j*k2 of the table's tail; rank j's combine then takes k2 = j*L/Q + t +
    u*T (u < 16/Q) and writes the Q-point register DFT of the ranks' values
    to rows k2 + L*k1."""
    Q = cuda_fftp.cluster_ranks(n)
    assert Q in (8, 16) and n % (16 * Q) == 0
    L = n // Q
    T = L // 16
    table = cuda_fftp.column_twiddles(n)
    cross = table[tw_count(L):]
    assert cross.size == n
    slots = np.arange(T)[:, None] + np.arange(16)[None, :] * T
    k2 = np.arange(L)
    z = np.stack([_unload(_stages(x[..., j + Q * slots], L), L) * cross[j * k2] for j in range(Q)], -1)
    y = np.empty(x.shape, complex)
    seen = np.zeros(L, int)
    for j in range(Q):  # the combine, rank by rank
        for u in range(16 // Q):
            kk = j * (L // Q) + np.arange(T) + u * T
            seen[kk] += 1
            out = _register_dft(z[..., kk, :])
            for k1 in range(Q):
                y[..., kk + L * k1] = out[..., k1]
    assert (seen == 1).all()  # each k2 once
    return y


def _column_pass(cols, H):
    """Pass 1's column transform of cols (H, W/2), by the kernel's route."""
    if H > cuda_fftp.CLUSTER_ABOVE:
        return _cluster_cols(cols.T, H).T
    TH = H // 16
    v = cols.T[:, np.arange(TH)[:, None] + np.arange(16)[None, :] * TH]
    return _unload(_stages(v, H), H).T


def _kernel_irfft2(X, H, W):
    """Passes 1 and 2 of the kernel on the product spectrum X (H, W/2+1)."""
    Wq, TW = W // 2, W // 16
    m = np.arange(H)
    cols = X[:, :Wq].copy()  # slot 0 packs the Hermitian parts of columns 0, W/2
    a, c = X[:, 0], X[:, Wq]
    cols[:, 0] = 0.5 * (a + np.conj(a[-m])) + 1j * 0.5 * (c + np.conj(c[-m]))
    mid = _column_pass(cols, H)  # (H, W/2)

    t, i = np.arange(TW)[:, None], np.arange(16)[None, :]
    lo = i < 8
    dc, nyq = (i == 0) & (t == 0), (i == 8) & (t == 0)
    idx = np.where(nyq, 0, np.where(lo, t + i * TW, (16 - i) * TW - t))

    def rebuild(rows):
        x = rows[:, idx]
        return np.where(dc, x.real, np.where(nyq, x.imag, np.where(lo, x, np.conj(x))))

    z = _unload(_stages(rebuild(mid[0::2]) + 1j * rebuild(mid[1::2]), W), W) / (H * W)
    out = np.empty((H, W))
    out[0::2], out[1::2] = z.real, z.imag
    return out


def _seven_smooth(m):
    for p in (3, 5, 7):
        while m % p == 0:
            m //= p
    return m == 1


def tw_count(n):
    """stockham::tw_count of the CUDA source, which refuses a table of
    another length: the power-of-two stages' parts, then for an odd factor
    m the direct route's n entries; where m is 7-smooth (the register
    route) the last power-of-two stage has no part, the odd stages' parts
    follow (NP * (m - 1) entries, NP = 16^(stages - 1)), then hi and lo
    (n/16 + 16 entries)."""
    a = (n & -n).bit_length() - 1
    radices = [16 if 4 * (s + 1) <= a else 1 << (a - 4 * s) for s in range((a + 3) // 4)]
    if n >> a == 1 or not _seven_smooth(n >> a):
        return sum((r - 1) << (4 * s) for s, r in enumerate(radices) if s) + (n if n >> a > 1 else 0)
    np_ = 16 ** (len(radices) - 1)
    return sum((r - 1) << (4 * s) for s, r in enumerate(radices[:-1]) if s) + np_ * ((n >> a) - 1) + n // 16 + 16


@pytest.mark.parametrize("R", [3, 5, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_odd_register_butterflies_match_numpy(R, seed):
    """The 3-, 5- and 7-point register butterflies (the kernel's symmetric
    form) against numpy's inverse DFT."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(64, R)) + 1j * rng.normal(size=(64, R))
    want = np.fft.ifft(a, axis=-1) * R
    np.testing.assert_allclose(_odd_butterfly(a), want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("m", range(1, 65, 2))
def test_radix_plan_routes_each_odd_factor(m):
    """Every odd m of a side 128*k: a 7-smooth m runs register radices 7,
    5, 3 (in that order, multiplying to m) between the two power-of-two
    stages 16 and 8; an m with a prime factor of 11 or more keeps the direct
    stage, one radix m, last."""
    n = 128 * m
    plan = cuda_fftp.radix_plan(n)
    assert int(np.prod(plan)) == n
    if _seven_smooth(m):
        odd = plan[1:-1]
        assert plan[0] == 16 and plan[-1] == 8
        assert cuda_fftp.odd_radices(m) == odd == sorted(odd, reverse=True) and set(odd) <= {3, 5, 7}
    else:
        assert cuda_fftp.odd_radices(m) is None and plan == [16, 8, m]
    assert cuda_fftp.stage_twiddles(n).shape == (tw_count(n),)


@pytest.mark.parametrize("n", [128 * k for k in range(1, 65)])
def test_radix_plan_matches_ifft(rng, n):
    assert np.prod(cuda_fftp.radix_plan(n)) == n
    assert cuda_fftp.stage_twiddles(n).shape == (tw_count(n),)
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    T = n // 16
    got = _unload(_stages(x[:, np.arange(T)[:, None] + np.arange(16)[None, :] * T], n), n)
    want = np.fft.ifft(x) * n
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n", [128 * k for k in range(17, 65)])
def test_cluster_column_pass_matches_ifft(rng, n):
    """The cluster route of pass 1 (every side above 2048 the gate takes,
    odd factors 3..63 included) against numpy's inverse FFT."""
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    want = np.fft.ifft(x) * n
    np.testing.assert_allclose(_cluster_cols(x, n), want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("h", [128, 1536, 2048, 2176, 2304, 3072, 4096, 6144, 8064, 8192])
def test_column_twiddles_have_the_length_the_source_checks(h):
    """fftp_corr_cols refuses a table of another length: tw_count(h) up to
    CLUSTER_ABOVE rows, above them tw_count(h/Q) + h (Q = 16 blocks a
    cluster where 256 divides h, else 8), the cross twiddles
    exp(+2*pi*i*r/h) last."""
    table = cuda_fftp.column_twiddles(h)
    if h <= cuda_fftp.CLUSTER_ABOVE:
        assert table.shape == (tw_count(h),)
        np.testing.assert_array_equal(table, cuda_fftp.stage_twiddles(h))
    else:
        L = h // cuda_fftp.cluster_ranks(h)
        assert L % 16 == 0
        assert table.shape == (tw_count(L) + h,)
        np.testing.assert_array_equal(table[: tw_count(L)], cuda_fftp.stage_twiddles(L))
        np.testing.assert_allclose(table[tw_count(L):], np.exp(2j * np.pi * np.arange(h) / h), rtol=0, atol=0)


def test_tw_count_of_the_power_of_two_sides():
    """The power-of-two tables, then the odd tables of both routes: on the
    register route the last power-of-two stage's part goes, the odd stages'
    parts (NP * (m - 1)) and hi and lo (n/16 + 16) follow (1536 = 16*16*3*2:
    240 + 256*2 + 96 + 16; 8064 = 16*7*3*3*8: 16*62 + 504 + 16; the cluster
    length 144 = 3*3*16: 8 + 9 + 16); n entries on the direct one (1408 =
    11 * 128: 112 + 1408)."""
    assert {n: tw_count(n) for n in (128, 256, 512, 1024, 2048, 4096, 8192)} == {
        128: 112, 256: 240, 512: 496, 1024: 1008, 2048: 2032, 4096: 4080, 8192: 8176}
    assert tw_count(1536) == 240 + 512 + 96 + 16 and tw_count(8064) == 992 + 504 + 16
    assert tw_count(144) == 8 + 9 + 16 and tw_count(1408) == 112 + 1408


@pytest.mark.parametrize("h, w", [(128, 128), (256, 512), (512, 256), (128, 4096), (4096, 128),
                                  (1024, 2048), (384, 640), (1536, 2560), (8192, 128),
                                  (128, 8192), (8064, 896), (2176, 256), (3072, 384),
                                  (4096, 4096), (6144, 128), (8192, 256)])
def test_kernel_passes_match_numpy_irfft2(rng, h, w):
    """Random complex half spectra, not Hermitian where rfft2 would make
    them so: numpy drops the imaginary parts of the DC and Nyquist bins
    after the column inverse, and so must the packed slot 0."""
    X = rng.normal(size=(h, w // 2 + 1)) + 1j * rng.normal(size=(h, w // 2 + 1))
    want = np.fft.irfft2(X, s=(h, w))
    np.testing.assert_allclose(_kernel_irfft2(X, h, w), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    from barc4dip_tpu_torch.ops import _nvcc

    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "core.cuh"\n')
    (tmp_path / "core.cuh").write_text('#pragma once\n  #  include "inner.cuh"\nint a;\n')
    (tmp_path / "inner.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int c;\n")
    d0 = _nvcc.source_digest("k")
    (tmp_path / "other.cuh").write_text("int c2;\n")
    assert _nvcc.source_digest("k") == d0
    (tmp_path / "inner.cuh").write_text("int b2;\n")
    d1 = _nvcc.source_digest("k")
    assert d1 != d0
    (tmp_path / "core.cuh").write_text('#pragma once\n#include "inner.cuh"\nint a2;\n')
    assert _nvcc.source_digest("k") not in (d0, d1)
    monkeypatch.setattr(_nvcc, "NVCC_FLAGS", _nvcc.NVCC_FLAGS + ("-lineinfo",))
    assert len({_nvcc.source_digest("k"), d0, d1}) == 3


def test_k1_build_key_covers_its_fft_core(tmp_path, monkeypatch):
    import shutil

    from barc4dip_tpu_torch.ops import _nvcc

    for src in _nvcc.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    d0 = _nvcc.source_digest("fftp_corr")
    with open(tmp_path / "stockham_fft.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _nvcc.source_digest("fftp_corr") != d0


@pytest.mark.parametrize("eps", [1e-9, 1e-6, 0.5, 1.0, 3.0, 7e-3, 0.0, 1e-40, -1.0, 3e38,
                                 float("inf")])
def test_sqrt_threshold_is_exact(rng, eps):
    """The kernel's guard x > t against the plain version's sqrt(x) > eps,
    on float32 x around the boundary and across the range."""
    t = np.float32(cuda_fftp.sqrt_threshold(eps))
    e = np.float32(eps)
    with np.errstate(invalid="ignore", over="ignore", under="ignore"):
        near = [t, e * e]  # and three float32 steps either side of t
        for step in (np.float32(np.inf), np.float32(-np.inf)):
            y = t
            for _ in range(3):
                y = np.nextafter(y, step)
                near.append(y)
        scale = np.float32(10.0) ** rng.integers(-45, 39, 2000).astype(np.float32)
        x = np.concatenate([np.array(near, np.float32),
                            rng.uniform(-1, 1, 2000).astype(np.float32) * scale,
                            np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45], np.float32)])
        np.testing.assert_array_equal(x > t, np.sqrt(x) > e)
