"""Plain reference of a raw X-ray speckle-tracking (XST) wavefront scan:
flat-field with dead-pixel repair, dense ZNCC tracking of every grid node
with the Newton subpixel step, and Frankot-Chellappa integration of the
slopes.

Definitions (upstream barc4dip ``preprocessing/normalize.py`` and the XST
method of Berujon et al., Phys. Rev. Lett. 108, 158102 (2012), at the port's
documented conventions):

- **flat-field**: ``flat`` and ``dark`` are the means of the stacked flats
  and darks; ``den = flat - dark``; ``eps = 1e-6 * median(den)`` (1e-6 where
  that median is not positive); a pixel is bad where ``den <= eps``;
  ``out = (raw - dark) / den * scale`` with ``scale`` the median of ``den``
  over the good pixels; bad pixels are set to 0, then replaced by the median
  of their 3x3 neighbourhood in that zeroed image, the neighbourhood taken
  with the edges duplicated (``scipy.ndimage.median_filter(mode="reflect")``,
  the border rule ``ops/cuda_median.py`` documents). Medians are linearly
  interpolated between order statistics;
- **grid**: tile starts from ``radius`` to ``H - tile - radius`` in steps of
  ``step`` on each axis, shifted by half the leftover margin (rounded down),
  so that every search window of side ``tile + 2 radius`` lies in the frame;
- **tracking**: both images z-scored over all their pixels (population
  std, ``(x - mean) / (std + eps)``, eps = float32(1e-9)); for node n with
  tile ``t = ref[y0:y0+s, x0:x0+s] - mean`` and every offset (u, v) in
  [0, 2r]^2 of its window ``w = img[y0-r:y0+s+r, x0-r:x0+s+r]``,
  ``ncc[u, v] = sum(t * w[u:u+s, v:v+s]) / sqrt(var(u, v) * sum(t^2))`` with
  ``var(u, v)`` the window's sum of squared deviations from its mean, 0
  where the denominator is at most eps; the integer peak is the first
  largest value in row-major order; the subpixel step is the Newton step of
  the 3x3 central differences (:func:`.tracking._newton`: zero on the
  border of the offsets or where the Hessian's determinant is zero);
  ``dy = i + di - r``, ``dx = j + dj - r``, ``peak = ncc[i, j]``;
- **integration**: ``Z = F^-1[-i (kx F[gx] + ky F[gy]) / (kx^2 + ky^2)]``
  with the DC term set to 0, returned zero-mean; slopes are
  ``d * pixel_size / distance`` on a grid of ``step * pixel_size``.

Departures from the definitions, none of which moves a float64 result by
more than its rounding: the numerator's sum is taken row by row (for each
tile row, the products with every window row as one batched matrix
product, then the rows that meet summed), and the window sums likewise
(each window row's sums over the tile's width, then over its height); the
nodes run in blocks so that a 2048^2 frame fits on the card.

Everything runs in the working dtype of a :class:`.common.Precision`,
rounded to its storage type after every stage. It imports nothing of the
program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import Precision
from .tracking import _newton

EPS = float(np.float32(1e-9))  # the z-score's and the NCC's eps, as the port rounds it
NODE_BLOCK = 2048  # nodes a tracking step holds


def median_lerp(v):
    """Median of all values of ``v``, linearly interpolated between the two
    middle order statistics."""
    xs = v.flatten().sort().values
    rank = 0.5 * (xs.numel() - 1)
    lo, hi = math.floor(rank), math.ceil(rank)
    return xs[lo] + (rank - lo) * (xs[hi] - xs[lo])


def _mean_of(stack, prec: Precision, device):
    """Mean over the leading axis of host frames (K, H, W), or an (H, W) frame."""
    x = prec.frames(stack, device)
    return prec.q(x.mean(0)) if x.dim() == 3 else x


def calibration(flats, darks, prec: Precision, device) -> dict:
    """The flat-field's per-pixel terms from host flats and darks."""
    flat, dark = _mean_of(flats, prec, device), _mean_of(darks, prec, device)
    den = prec.q(flat - dark)
    med = median_lerp(den)
    eps = 1e-6 * med if med > 0 else torch.tensor(1e-6, dtype=den.dtype, device=den.device)
    bad = den <= eps
    scale = median_lerp(den[~bad])
    return {"dark": dark, "den": torch.where(bad, 1.0, den), "bad": bad, "scale": scale}


def _reflect_index(n: int, h: int, device):
    """Indices -h .. n + h - 1 into [0, n) with the edges duplicated."""
    i = torch.arange(-h, n + h, device=device)
    i = torch.remainder(i, 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def neighbourhoods(x, flat_idx):
    """The 3x3 neighbourhoods of the pixels ``flat_idx`` of (..., H, W)
    images, edges duplicated: (..., S, 9), row-major, centre at 4."""
    H, W = x.shape[-2:]
    ry, rx = _reflect_index(H, 1, x.device), _reflect_index(W, 1, x.device)
    y, c = flat_idx // W, flat_idx % W
    off = torch.arange(3, device=x.device)
    yy = ry[(y[:, None] + off[None, :])][:, :, None].expand(-1, 3, 3)
    xx = rx[(c[:, None] + off[None, :])][:, None, :].expand(-1, 3, 3)
    return x[..., yy, xx].flatten(-2)


def median3x3(x):
    """3x3 median of (..., H, W) images, edges duplicated."""
    H, W = x.shape[-2:]
    p = x.index_select(-2, _reflect_index(H, 1, x.device)).index_select(-1, _reflect_index(W, 1, x.device))
    win = torch.stack([p[..., dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], dim=-1)
    return win.sort(dim=-1).values[..., 4]


def flat_field(raw, cal: dict, prec: Precision, device, sample=None) -> dict:
    """Corrected frames of host raw frames (T, H, W) or (H, W): {"frames":
    the corrected images}; with ``sample`` (flat pixel indices), also the
    reference's candidate values there, each (..., S): ``value`` (its own
    answer), ``repaired`` (the 3x3 median of the zeroed image with the pixel
    itself zeroed: what a repair gives) and ``left`` (0 at a bad pixel, the
    formula at a good one: what no repair gives)."""
    img = prec.frames(raw, device)
    out = prec.q(prec.q((img - cal["dark"]) / cal["den"]) * cal["scale"])
    zeroed = torch.where(cal["bad"], 0.0, out)
    frames = torch.where(cal["bad"], prec.q(median3x3(zeroed)), zeroed)
    res = {"frames": frames}
    if sample is not None:
        H, W = img.shape[-2:]
        nb = neighbourhoods(zeroed, sample)
        nb[..., 4] = 0.0

        def at(a):
            return a.reshape(*a.shape[:-2], H * W)[..., sample]

        res.update(value=at(frames), repaired=nb.sort(dim=-1).values[..., 4], left=at(zeroed))
    return res


def grid_starts(H: int, W: int, tile: int, radius: int, step: int) -> tuple[np.ndarray, np.ndarray]:
    def axis(n):
        lo, hi = radius, n - tile - radius
        starts = np.arange(lo, hi + 1, step)
        return starts + (hi - starts[-1]) // 2
    return axis(H), axis(W)


def zscore(x, prec: Precision):
    m = x.mean(dim=(-2, -1), keepdim=True)
    sd = torch.sqrt(((x - m) ** 2).mean(dim=(-2, -1), keepdim=True))
    return prec.q((x - m) / (sd + EPS))


def _patches(img, ys, xs, side: int):
    """(n, side, side) patches of (H, W) ``img`` at the starts (ys[k], xs[k])."""
    ar = torch.arange(side, device=img.device)
    return img[(ys[:, None] + ar)[:, :, None], (xs[:, None] + ar)[:, None, :]]


def _row_sums(rows, s: int):
    """(..., L, L) sums of s consecutive rows of (..., w, L) partial sums."""
    return rows.unfold(-2, s, 1).sum(-1)


def ncc_block(tiles, energy, wins, prec: Precision):
    """NCC maps (n, L, L) of n centred tiles (n, s, s), their energies (n,),
    against their windows (n, w, w)."""
    s, w = tiles.shape[-1], wins.shape[-1]
    L = w - s + 1
    strips = wins.unfold(-1, s, 1)  # (n, w, L, s): window row r, offset v, tile column b
    # c[n, a, r, v] = sum_b t[n, a, b] * w[n, r, v + b]; num[u, v] = sum_a c[n, a, u + a, v]
    c = torch.einsum("nab,nrvb->narv", tiles, strips)
    a = torch.arange(s, device=wins.device)
    u = torch.arange(L, device=wins.device)
    num = prec.q(c[:, a[:, None], a[:, None] + u[None, :], :].sum(1))
    s1 = prec.q(_row_sums(strips.sum(-1), s))
    s2 = prec.q(_row_sums((strips * strips).sum(-1), s))
    var = prec.q((s2 - s1 * s1 / float(s * s)).clamp_min(0.0))
    denom = torch.sqrt(var * energy[:, None, None])
    return prec.q(torch.where(denom > EPS, num / torch.where(denom > EPS, denom, 1.0), 0.0))


def track(frames, ref, prec: Precision, *, tile: int, step: int, radius: int, subpixel: bool = True) -> dict:
    """Displacement fields of corrected frames (T, H, W) against the
    corrected reference (H, W), tensors of the working dtype: {"dy", "dx",
    "peak"}, each (T, gy, gx) float64 on the host (without ``subpixel``, the
    integer peaks); and "start_dy", "start_dx", each (T, gy, gx, 9): the
    displacement the Newton step gives from each integer offset of the 3x3
    around the peak (row-major, the peak's own at 4), which tells from
    which integer peak another tracker's answer started."""
    T, H, W = frames.shape
    s, r = int(tile), int(radius)
    y0s, x0s = grid_starts(H, W, s, r, int(step))
    gy, gx = len(y0s), len(x0s)
    dev = frames.device
    ys = torch.as_tensor(np.repeat(y0s, gx), device=dev)
    xs = torch.as_tensor(np.tile(x0s, gy), device=dev)
    zref = zscore(ref, prec)
    out = {k: np.empty((T, gy * gx)) for k in ("dy", "dx", "peak")}
    out.update({k: np.empty((T, gy * gx, 9)) for k in ("start_dy", "start_dx")})
    for t in range(T):
        z = zscore(frames[t], prec)
        for n0 in range(0, gy * gx, NODE_BLOCK):
            by, bx = ys[n0:n0 + NODE_BLOCK], xs[n0:n0 + NODE_BLOCK]
            tiles = _patches(zref, by, bx, s)
            tiles = prec.q(tiles - tiles.mean(dim=(-2, -1), keepdim=True))
            energy = prec.q((tiles * tiles).sum(dim=(-2, -1)))
            ncc = ncc_block(tiles, energy, _patches(z, by - r, bx - r, s + 2 * r), prec)
            L = ncc.shape[-1]
            k = ncc.flatten(-2).argmax(-1)
            i, j = k // L, k % L
            sl = slice(n0, n0 + len(by))
            out["peak"][t, sl] = ncc.flatten(-2).gather(-1, k[:, None])[:, 0].double().cpu().numpy()
            for c, (a, b) in enumerate((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)):
                ii, jj = (i + a).clamp(0, L - 1), (j + b).clamp(0, L - 1)
                di, dj = _newton(ncc, ii, jj) if subpixel else (0.0, 0.0)
                fy = (ii.to(ncc.dtype) + di - r).double().cpu().numpy()
                fx = (jj.to(ncc.dtype) + dj - r).double().cpu().numpy()
                out["start_dy"][t, sl, c], out["start_dx"][t, sl, c] = fy, fx
            out["dy"][t, sl], out["dx"][t, sl] = out["start_dy"][t, sl, 4], out["start_dx"][t, sl, 4]
    return {key: v.reshape(T, gy, gx, *v.shape[2:]) for key, v in out.items()}


def integrate(gy, gx, step: float, prec: Precision, device="cpu"):
    """Frankot-Chellappa surface of host slope maps (..., ny, nx) on a grid
    of spacing ``step``: zero-mean, float64 on the host."""
    gy = prec.q(torch.as_tensor(np.asarray(gy), device=device).to(prec.dtype))
    gx = prec.q(torch.as_tensor(np.asarray(gx), device=device).to(prec.dtype))
    ny, nx = gy.shape[-2:]
    ky = 2.0 * math.pi * torch.fft.fftfreq(ny, d=float(step), dtype=prec.dtype, device=device)[:, None]
    kx = 2.0 * math.pi * torch.fft.fftfreq(nx, d=float(step), dtype=prec.dtype, device=device)[None, :]
    k2 = ky * ky + kx * kx
    num = prec.q(kx * prec.q(torch.fft.fft2(gx)) + ky * prec.q(torch.fft.fft2(gy)))
    Fz = -1j * num / torch.where(k2 == 0, 1.0, k2)
    Fz[..., 0, 0] = 0.0
    z = prec.q(torch.fft.ifft2(prec.q(Fz)).real)
    return (z - z.mean(dim=(-2, -1), keepdim=True)).double().cpu().numpy()
