"""Seeded detector frames, made on the device that runs the cell.

Fully developed speckle is the squared modulus of a smooth complex Gaussian
field: complex white noise, low-passed in the frequency domain by a Gaussian
whose FWHM in real space is ``grain_px``. A stack is one such pattern moved
by exact Fourier shifts along the spiral ``(a t cos(w t), a t sin(w t))``,
so the tracker's answer is known without any program. A focus scan is one
intensity pattern blurred by a Gaussian of sigma ``step * |t - centre|``
(periodic, in the frequency domain), so its sharpest frame is known too.

Every draw comes from one ``torch.Generator`` seeded with ``--seed``, in a few
large calls on the device. Frames leave as host ``uint16`` arrays, as the
port's readers return detector frames.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def spiral(T: int, amplitude: float, omega: float) -> tuple[np.ndarray, np.ndarray]:
    """(dy, dx) of each frame [px], float64."""
    t = np.arange(int(T), dtype=np.float64)
    return amplitude * t * np.cos(t * omega), amplitude * t * np.sin(t * omega)


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def _freqs(n: int, device) -> torch.Tensor:
    return torch.fft.fftfreq(n, device=device, dtype=torch.float64)


def _base_spectrum(gen, H: int, W: int, grain_px: float, device) -> torch.Tensor:
    """fft2 of complex white noise, times the Gaussian low-pass (complex128)."""
    noise = torch.randn((2, H, W), generator=gen, device=device, dtype=torch.float64)
    sigma_f = 1.0 / (2.0 * math.pi * (float(grain_px) / 2.355))
    hy = torch.exp(-_freqs(H, device) ** 2 / (2.0 * sigma_f**2))
    hx = torch.exp(-_freqs(W, device) ** 2 / (2.0 * sigma_f**2))
    return torch.fft.fft2(torch.complex(noise[0], noise[1])) * (hy[:, None] * hx[None, :])


def _to_uint16(field: torch.Tensor) -> np.ndarray:
    """Counts clipped to [0, 65535] and truncated, as the detector's ADC
    and ``astype(uint16)`` do, then copied to the host."""
    x = field.clamp(0.0, 65535.0).to(torch.int32)
    x = torch.where(x >= 32768, x - 65536, x).to(torch.int16)
    return x.cpu().numpy().view(np.uint16)


def speckle_stack(gen, T: int, H: int, W: int, *, grain_px: float, mean_counts: float,
                  dys: np.ndarray, dxs: np.ndarray, device) -> np.ndarray:
    """(T, H, W) uint16: one pattern, frame t Fourier-shifted by (dys[t], dxs[t])."""
    F = _base_spectrum(gen, H, W, grain_px, device)
    fy, fx = _freqs(H, device), _freqs(W, device)
    out = np.empty((int(T), H, W), np.uint16)
    for t in range(int(T)):
        py = torch.exp(-2j * math.pi * fy * float(dys[t]))
        px = torch.exp(-2j * math.pi * fx * float(dxs[t]))
        field = torch.fft.ifft2(F * (py[:, None] * px[None, :])).abs() ** 2
        out[t] = _to_uint16(field / field.mean() * float(mean_counts))
    return out


def focus_scan(gen, T: int, H: int, W: int, *, grain_px: float, mean_counts: float,
               sigma_step: float, device) -> np.ndarray:
    """(T, H, W) uint16: one intensity pattern blurred by a Gaussian of sigma
    ``sigma_step * |t - T // 2|`` px and rounded to counts; frame T // 2 is
    in focus."""
    base = torch.fft.ifft2(_base_spectrum(gen, H, W, grain_px, device)).abs() ** 2
    base = base / base.mean() * float(mean_counts)
    B = torch.fft.fft2(base)
    f2 = _freqs(H, device)[:, None] ** 2 + _freqs(W, device)[None, :] ** 2
    out = np.empty((int(T), H, W), np.uint16)
    for t in range(int(T)):
        sigma = float(sigma_step) * abs(t - int(T) // 2)
        blurred = torch.fft.ifft2(B * torch.exp(-2.0 * math.pi**2 * sigma**2 * f2)).real
        out[t] = _to_uint16(torch.round(blurred))
    return out


def make_pool(seed: int, config: dict, traffic: dict, device) -> list[dict]:
    """The cell's inputs: ``traffic["pool"]`` items, each ``{"data": host
    uint16 array, "truth": {...}}``. A stack or scan item is (T, H, W), a
    frame item (H, W), cut from one stack of as many frames as the pool."""
    det, content = config["detector"], config["content"]
    H, W = int(det["height"]), int(det["width"])
    kind, n_pool = traffic["input"], int(traffic["pool"])
    gen = generator(seed, device)
    with torch.no_grad():
        if kind == "focus_scan":
            T = int(traffic["frames"])
            return [
                {"data": focus_scan(gen, T, H, W, grain_px=content["grain_px"],
                                    mean_counts=content["mean_counts"],
                                    sigma_step=content["blur_sigma_step_px"], device=device),
                 "truth": {"best_frame": T // 2}}
                for _ in range(n_pool)
            ]
        T = int(traffic["frames"]) if kind == "stack" else n_pool
        dys, dxs = spiral(T, content["spiral_amplitude"], content["spiral_omega"])
        stacks = [
            speckle_stack(gen, T, H, W, grain_px=content["grain_px"],
                          mean_counts=content["mean_counts"], dys=dys, dxs=dxs, device=device)
            for _ in range(n_pool if kind == "stack" else 1)
        ]
    if kind == "stack":
        return [{"data": s, "truth": {"dy": dys, "dx": dxs}} for s in stacks]
    if kind == "frame":
        return [{"data": stacks[0][t], "truth": {}} for t in range(n_pool)]
    raise ValueError(f"unknown input kind {kind!r}")
