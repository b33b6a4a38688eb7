"""Plain PyTorch building blocks of the reference: precision, padding,
autocorrelation, width and radial estimators, tiles.

Written from the documented definitions of the upstream metrics (the
plain NumPy/SciPy formulations the port's CPU tests hold it to), in batched
PyTorch so that the reference runs on the card, after the window, in float64.
It imports nothing of the program.

``Precision`` also runs the same code lower: ``float32``, ``tf32`` (float32
with TF32 matrix products) and ``bfloat16`` (every stage's result stored in
bfloat16, sums and transforms taken in float32 on those values, as a
bfloat16 path on a GPU keeps them). The lower ones are the controls that the
comparison has to refuse.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "tf32", "bfloat16")
MIN_TILE_PX = 128  # the smallest tile side of the tiling policy
INV_E = 1.0 / math.e


class Precision:
    """Working dtype and rounding of one reference run."""

    def __init__(self, name: str = "float64"):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the precision's storage type."""
        if self.name != "bfloat16":
            return x
        if x.is_complex():
            return torch.complex(self.q(x.real), self.q(x.imag))
        return x.to(torch.bfloat16).to(x.dtype)

    @contextlib.contextmanager
    def matmul(self):
        """TF32 matrix products for ``tf32``, and plain float products
        otherwise, restored afterwards."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.name == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def frames(self, data, device) -> torch.Tensor:
        """Host integer or float frames as a tensor of the working dtype."""
        arr = np.asarray(data)
        if arr.dtype == np.uint16:
            arr = arr.astype(np.int32)
        return self.q(torch.from_numpy(np.ascontiguousarray(arr)).to(device).to(self.dtype))


def flip_rows(x):
    """The detector convention (origin lower): rows reversed."""
    return torch.flip(x, dims=[-2])


def pad_square_mean(x):
    """(..., H, W) centred in (..., N, N), N = max(H, W), the rest filled
    with each image's mean."""
    H, W = x.shape[-2:]
    N = max(H, W)
    if H == W:
        return x
    out = x.mean(dim=(-2, -1), keepdim=True).expand(*x.shape[:-2], N, N).clone()
    y0, x0 = (N - H) // 2, (N - W) // 2
    out[..., y0:y0 + H, x0:x0 + W] = x
    return out


def autocorr(x, prec: Precision, *, standardize: bool = False):
    """Mean-removed (optionally standardised) circular autocorrelation of
    (..., N, N) images, fftshifted and divided by its largest magnitude."""
    a = prec.q(x - x.mean(dim=(-2, -1), keepdim=True))
    if standardize:
        s = torch.sqrt((a * a).mean(dim=(-2, -1), keepdim=True))
        a = prec.q(a / torch.where(s > 0, s, 1.0))
    F = prec.q(torch.fft.fft2(a))
    c = prec.q(torch.fft.fftshift(torch.fft.ifft2(prec.q(F.real**2 + F.imag**2)).real, dim=(-2, -1)))
    m = c.abs().amax(dim=(-2, -1), keepdim=True)
    return prec.q(c / torch.where(m > 0, m, 1.0))


def _interp(p, i0, i1, thr, fallback):
    y0 = p.gather(-1, i0[..., None])[..., 0]
    y1 = p.gather(-1, i1[..., None])[..., 0]
    return torch.where(y1 == y0, fallback, i0.to(p.dtype) + (thr - y0) / torch.where(y1 == y0, 1.0, y1 - y0))


def width_at_fraction(p, fraction: float, center):
    """Full width of profiles p (..., n) where they first fall below
    ``fraction`` of p[center] on each side, linearly interpolated; n where
    a side never falls below."""
    n = p.shape[-1]
    idx = torch.arange(n, device=p.device)
    c = center.clamp(0, n - 1)
    thr = p.gather(-1, c[..., None])[..., 0] * fraction
    below = p < thr[..., None]
    i_left = torch.where(below & (idx <= c[..., None]), idx, -1).amax(-1)
    i_right = torch.where(below & (idx >= c[..., None]), idx, n).amin(-1)
    flat = (i_left < 0) | (i_right >= n)
    il, ir = i_left.clamp(0, n - 1), i_right.clamp(1, n - 1)
    x_left = _interp(p, il, (il + 1).clamp(max=n - 1), thr, il.to(p.dtype))
    x_right = _interp(p, ir - 1, ir, thr, ir.to(p.dtype))
    return torch.where(flat, float(n), x_right - x_left)


def distance_at_fraction(p, fraction: float):
    """Distance from sample 0 to where profiles p (..., n) first fall below
    ``fraction`` of p[0], linearly interpolated; n if they never do."""
    n = p.shape[-1]
    idx = torch.arange(n, device=p.device)
    thr = p[..., 0] * fraction
    i = torch.where(p < thr[..., None], idx, n).amin(-1)
    never = i >= n
    ic = i.clamp(1, n - 1)
    x = _interp(p, ic - 1, ic, thr, ic.to(p.dtype))
    return torch.where(never, float(n), torch.where(i == 0, 0.0, x))


def radial_mean_interpolated(z, prec: Precision):
    """Mean over 1130 angles (one a degree of 2*pi*180) of bilinear samples
    of (..., ny, nx) maps on rings r = 0, 1, ..., min(nx, ny)//2 about the
    pixel (ny//2, nx//2); samples off the grid read 0. Returns (radial, dr)."""
    ny, nx = z.shape[-2:]
    r_max = float(min(nx // 2, ny // 2))
    nr = int(math.floor(r_max)) + 1
    nt = int(2.0 * math.pi * 180.0)
    dev, dt = z.device, z.dtype
    r = torch.linspace(0.0, r_max, nr, dtype=torch.float64, device=dev)
    th = torch.arange(nt, dtype=torch.float64, device=dev) * (2.0 * math.pi / nt)
    xs = (r[:, None] * torch.cos(th)[None, :] + nx // 2).reshape(-1)
    ys = (r[:, None] * torch.sin(th)[None, :] + ny // 2).reshape(-1)
    inside = (xs >= 0) & (xs <= nx - 1) & (ys >= 0) & (ys <= ny - 1)
    x0 = xs.floor().clamp(0, nx - 2).long()
    y0 = ys.floor().clamp(0, ny - 2).long()
    fx = (xs - x0).clamp(0, 1).to(dt)
    fy = (ys - y0).clamp(0, 1).to(dt)
    flat = z.flatten(-2)
    base = y0 * nx + x0
    v = ((1 - fy) * ((1 - fx) * flat[..., base] + fx * flat[..., base + 1])
         + fy * ((1 - fx) * flat[..., base + nx] + fx * flat[..., base + nx + 1]))
    v = torch.where(inside, v, 0.0)
    return prec.q(v.reshape(*v.shape[:-1], nr, nt).mean(-1)), r_max / (nr - 1)


def widths(ac, prec: Precision, fraction: float = INV_E):
    """(lx, ly, leq) of peak-normalised autocorrelation maps (..., N, N):
    the axis cuts through the peak and twice the radial fall-off distance."""
    N = ac.shape[-1]
    k = ac.flatten(-2).argmax(-1)
    iy, ix = k // N, k % N
    y_cut = ac.gather(-1, ix[..., None, None].expand(*ac.shape[:-1], 1))[..., 0]
    x_cut = ac.gather(-2, iy[..., None, None].expand(*ac.shape[:-2], 1, N))[..., 0, :]
    ly = width_at_fraction(y_cut, fraction, iy)
    lx = width_at_fraction(x_cut, fraction, ix)
    rad, dr = radial_mean_interpolated(ac, prec)
    leq = 2.0 * distance_at_fraction(rad, fraction) * dr
    return prec.q(lx), prec.q(ly), prec.q(leq)


def percentile(v, p: float):
    """The p-th percentile of each row of v (..., n), linearly interpolated
    between order statistics (numpy's default)."""
    n = v.shape[-1]
    s = v.sort(-1).values
    pos = (n - 1) * p / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    return s[..., lo] + (pos - lo) * (s[..., hi] - s[..., lo])


def safe_div(a, b, where_zero=math.inf):
    return torch.where(b != 0, a / torch.where(b != 0, b, 1.0), where_zero)


def moments(x, prec: Precision, *, saturation: float = 65535.0, eps: float = 1e-6) -> dict:
    """Moments of the finite values of each image (scipy.stats.describe
    conventions: population std, biased skewness, Fisher kurtosis), the
    shares at zero and at saturation, and 20 log10(mean/std)."""
    v = x.flatten(-2)
    n = float(v.shape[-1])
    mean = prec.q(v.sum(-1) / n)
    d = prec.q(v - mean[..., None])
    m2 = prec.q((d * d).sum(-1) / n)
    m3 = prec.q((d * d * d).sum(-1) / n)
    m4 = prec.q((d * d * d * d).sum(-1) / n)
    std = torch.sqrt(m2)
    return {
        "mean": mean, "std": std, "variance": std * std,
        "skewness": m3 / m2**1.5, "kurtosis": m4 / (m2 * m2) - 3.0,
        "frac_zero": (v.abs() <= eps).sum(-1).to(x.dtype) / n,
        "frac_sat": (v >= saturation).sum(-1).to(x.dtype) / n,
        "SNRdB": 20.0 * torch.log10(mean / std),
    }


def tiling_mode(h: int, w: int, tiles: bool) -> str:
    """9x9 subtiles where a subtile keeps 128 px a side, else 3x3 tiles
    where a tile does, else none."""
    if not tiles:
        return "off"
    if h // 9 >= MIN_TILE_PX and w // 9 >= MIN_TILE_PX:
        return "subtiles_9x9"
    if h // 3 >= MIN_TILE_PX and w // 3 >= MIN_TILE_PX:
        return "tiles_3x3"
    return "off"


def split_edges(length: int, n: int) -> list[tuple[int, int]]:
    """[0, length) in n parts at the rounded points of linspace(0, length, n + 1)."""
    e = np.linspace(0, length, n + 1)
    parts = [(int(round(float(e[i]))), max(int(round(float(e[i + 1]))), int(round(float(e[i]))) + 1))
             for i in range(n)]
    parts[-1] = (parts[-1][0], length)
    return parts


def tile_fields(x, n: int, fn) -> dict:
    """``fn`` of every tile of an n x n grid of (B, H, W) images, the tiles
    of one shape in one batch: {field: (B, n, n)}."""
    H, W = x.shape[-2:]
    shapes: dict = {}
    for r, (y0, y1) in enumerate(split_edges(H, n)):
        for c, (x0, x1) in enumerate(split_edges(W, n)):
            shapes.setdefault((y1 - y0, x1 - x0), []).append((r, c, y0, x0))
    out: dict = {}
    for (th, tw), pos in shapes.items():
        batch = torch.stack([x[..., y0:y0 + th, x0:x0 + tw] for _, _, y0, x0 in pos], dim=-3)
        for k, v in fn(batch).items():
            g = out.setdefault(k, torch.full((x.shape[0], n, n), math.nan, dtype=v.dtype, device=v.device))
            g[:, [p[0] for p in pos], [p[1] for p in pos]] = v
    return out


def tiles_3x3(x, mode: str, fn) -> dict:
    """{field: {"mean": (B, 3, 3), "std": (B, 3, 3)}}: 9x9 subtiles pooled
    in 3x3 blocks (population std), or 3x3 tiles with a NaN std."""
    if mode == "subtiles_9x9":
        out = {}
        for k, g in tile_fields(x, 9, fn).items():
            b = g.reshape(-1, 3, 3, 3, 3).transpose(2, 3).reshape(-1, 3, 3, 9)
            out[k] = {"mean": b.mean(-1), "std": b.std(-1, correction=0)}
        return out
    return {k: {"mean": g, "std": torch.full_like(g, math.nan)}
            for k, g in tile_fields(x, 3, fn).items()}


def leaves(full: dict, tiles: dict | None) -> dict:
    """{"full/<group>/<field>": (B,), "tiles/<group>/<field>/<mean|std>":
    (B, 3, 3)} as float64 host arrays."""
    out = {f"full/{g}/{f}": v.double().cpu().numpy() for g, d in full.items() for f, v in d.items()}
    for key, ms in (tiles or {}).items():
        for stat, v in ms.items():
            out[f"tiles/{key}/{stat}"] = v.double().cpu().numpy()
    return out
