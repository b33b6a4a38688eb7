"""Input kind ``xst_scan``: ``traffic["pool"]`` raw X-ray speckle-tracking
scans of ``traffic["frames"]`` frames, each with its reference, flats and
darks, as a 16-bit detector gives them.

A scan is one fully developed speckle pattern (``speckle._base_spectrum``:
complex white noise low-passed to ``grain_px``) seen through a spherical
wavefront of radius R: at propagation distance D the pattern in frame t is
the reference's moved by ``d(p) = (p - c) D / R + s_t`` along each axis
(pixel p, centre c = side / 2, ``s_t`` the spiral drift of frame t), so
``frame_t(p) = ref(p - d(p))``. The move is exact: the complex field is
evaluated at the moved points by its own trigonometric interpolant (a
matrix of Fourier modes on each side of its spectrum, whose Nyquist row and
column are zeroed so that the interpolant is unique), and the intensity is
its squared modulus there; no interpolation of intensities is made.

Each image then gets shot noise (Poisson photons), the detector's gain
(0 at a dead pixel), its dark level and read noise, and is rounded and
clipped to ``uint16``; flats are the gain times a flat level plus the dark
level and read noise, held below the dark level at a dead pixel; darks are
the dark level and read noise.

Every draw comes from one ``torch.Generator`` seeded with ``--seed``, on the
device that runs the cell. An item is ``{"ref", "stack", "flats", "darks":
host uint16 arrays; "dead": host bool (H, W); "sample": the flat pixel
indices (on the device, sorted) of ``traffic["args"]["sample_px"]`` pixels
at which the check reads the flat-field, every dead pixel among them;
"truth": {"k": D / R, "centre", "drift_dy", "drift_dx", "radius_m"}}``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.gen import speckle


def _modes(n: int, points, device) -> torch.Tensor:
    """(len(points), n) complex128: exp(2 pi i f_k p) of the DFT's frequencies."""
    f = torch.fft.fftfreq(n, device=device, dtype=torch.float64)
    return torch.exp(2j * math.pi * points[:, None] * f[None, :])


def field_at(spec, py, px) -> torch.Tensor:
    """The trigonometric interpolant of ``ifft2(spec)`` at the points
    (py[i], px[j]): (len(py), len(px)) complex128."""
    H, W = spec.shape
    return _modes(H, py, spec.device) @ spec @ _modes(W, px, spec.device).T / (H * W)


def _counts(gen, photons, gain_eff, calib: dict) -> np.ndarray:
    read = torch.randn(photons.shape, generator=gen, device=photons.device, dtype=torch.float64)
    return speckle._to_uint16(torch.round(photons * gain_eff + calib["dark_level"] + calib["read_noise"] * read))


def _sample(gen, dead, n: int) -> torch.Tensor:
    """Sorted flat indices of ``n`` pixels: every dead pixel, the rest drawn."""
    flat_dead = dead.flatten()
    perm = torch.randperm(flat_dead.numel(), generator=gen, device=dead.device)
    live = perm[~flat_dead[perm]]
    dead_idx = flat_dead.nonzero()[:, 0]
    n = min(int(n), flat_dead.numel())
    return torch.cat([dead_idx, live[:max(0, n - dead_idx.numel())]]).sort().values


def scan(gen, T: int, H: int, W: int, config: dict, sample_px: int, device) -> dict:
    content, optics, calib = config["content"], config["optics"], config["calibration"]
    k = float(optics["distance_m"]) / float(optics["radius_m"])
    cy, cx = H / 2.0, W / 2.0
    drift_dy, drift_dx = speckle.spiral(T, content["drift_amplitude_px"], content["drift_omega"])

    spec = speckle._base_spectrum(gen, H, W, content["grain_px"], device)
    if H % 2 == 0:
        spec[H // 2, :] = 0
    if W % 2 == 0:
        spec[:, W // 2] = 0
    py = torch.arange(H, device=device, dtype=torch.float64)
    px = torch.arange(W, device=device, dtype=torch.float64)
    base = field_at(spec, py, px).abs() ** 2
    norm = float(content["mean_counts"]) / float(base.mean())

    gain = float(calib["gain_mean"]) + float(calib["gain_std"]) * torch.randn(
        (H, W), generator=gen, device=device, dtype=torch.float64)
    dead = torch.rand((H, W), generator=gen, device=device, dtype=torch.float64) < float(calib["dead_fraction"])
    gain_eff = torch.where(dead, 0.0, gain)

    def image(intensity):
        return _counts(gen, torch.poisson(intensity * norm, generator=gen), gain_eff, calib)

    ref = image(base)
    stack = np.empty((int(T), H, W), np.uint16)
    for t in range(int(T)):
        inten = field_at(spec, py - (py - cy) * k - float(drift_dy[t]), px - (px - cx) * k - float(drift_dx[t]))
        stack[t] = image(inten.abs() ** 2)

    nf, nd = int(calib["flats"]), int(calib["darks"])
    flat_level = float(calib["flat_level"])
    flats = np.stack([_counts(gen, torch.full((H, W), flat_level, device=device, dtype=torch.float64), gain, calib)
                      for _ in range(nf)])
    dead_host = dead.cpu().numpy()
    flats[:, dead_host] = int(calib["dead_flat_counts"])
    darks = np.stack([_counts(gen, torch.zeros((H, W), device=device, dtype=torch.float64), gain, calib)
                      for _ in range(nd)])
    return {
        "ref": ref, "stack": stack, "flats": flats, "darks": darks, "dead": dead_host,
        "sample": _sample(gen, dead, sample_px),
        "truth": {"k": k, "centre": (cy, cx), "drift_dy": drift_dy, "drift_dx": drift_dx,
                  "radius_m": float(optics["radius_m"])},
    }


def make_pool(seed: int, config: dict, traffic: dict, device) -> list[dict]:
    det = config["detector"]
    H, W = int(det["height"]), int(det["width"])
    gen = speckle.generator(seed, device)
    with torch.no_grad():
        return [scan(gen, int(traffic["frames"]), H, W, config, int(traffic["args"]["sample_px"]), device)
                for _ in range(int(traffic["pool"]))]
