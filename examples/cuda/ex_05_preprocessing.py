# SPDX-License-Identifier: CECILL-2.1
"""ex_05 — preprocessing chain with the PyTorch/CUDA port: PSF
deconvolution, CLAHE, distortion correction, stack registration, the
visibility map and FRC (the workflow of ``examples/ex_05_preprocessing.py``
on ``barc4dip_tpu_torch``).

Run: python examples/cuda/ex_05_preprocessing.py [out_dir] [--device cpu]
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
from scipy.ndimage import gaussian_filter

import barc4dip_tpu_torch as dip
from barc4dip_tpu_torch.preprocessing.distortion import correct_distortion
from barc4dip_tpu_torch.preprocessing.enhancement import clahe

# smoke-test knob: shrink the workload so every example runs in seconds
FAST = bool(os.environ.get("BARC4DIP_EX_FAST"))


def main(out_dir=None, device=None) -> dict:
    rng = np.random.default_rng(4)
    side = 256 if FAST else 512
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    H = np.exp(-(f[None, :] ** 2 + f[:, None] ** 2) / (2 * (1 / (2 * np.pi * 4 / 2.355)) ** 2))
    sharp = np.abs(np.fft.ifft2(np.fft.fft2(a) * H)) ** 2
    sharp = (sharp / sharp.max()).astype(np.float32)
    res: dict = {}

    # detector blur -> deconvolution
    sigma = 1.8
    blurred = gaussian_filter(sharp, sigma).astype(np.float32)
    for method in ("wiener", "rl", "uw"):
        restored = dip.preprocessing.deconvolve_psf(blurred, sigma=sigma, method=method, device=device)
        mse_b = float(np.mean((blurred - sharp) ** 2))
        mse_r = float(np.mean((restored - sharp) ** 2))
        print(f"deconv {method:6s}: blur MSE {mse_b:.3e} -> restored {mse_r:.3e}")
        res[f"mse_{method}"] = (mse_b, mse_r)

    # contrast enhancement on a dim detector image
    dim = (sharp * 8000 + 20000).astype(np.uint16)
    enhanced = clahe(dim, clip_limit=3.0, tile_grid_size=(8, 8), device=device)
    print(f"clahe: std {dim.std():.0f} -> {enhanced.std():.0f}")
    res["clahe_std"] = (float(dim.std()), float(enhanced.std()))

    # optics distortion removal (barrel, k1 > 0)
    undistorted = np.asarray(correct_distortion(sharp, k1=0.08, device=device))
    print(f"distortion correction: center preserved "
          f"({sharp[side//2, side//2]:.4f} -> {undistorted[side//2, side//2]:.4f})")

    # stack registration: remove a known drift, then verify the residual
    # with the drift measurement itself
    T = 4 if FAST else 8
    fy = np.fft.fftfreq(side)[:, None]
    fx = np.fft.fftfreq(side)[None, :]
    F = np.fft.fft2(sharp)
    ts = np.arange(T)
    dys, dxs = 1.3 * ts, -0.8 * ts
    drifting = np.stack([
        np.fft.ifft2(F * np.exp(-2j * np.pi * (fy * dy + fx * dx))).real
        for dy, dx in zip(dys, dxs)
    ]).astype(np.float32)
    aligned, shifts = dip.preprocessing.register_stack(drifting, device=device)
    _, residual = dip.preprocessing.register_stack(aligned, device=device)
    res["residual_px"] = float(np.hypot(residual["dy"], residual["dx"]).max())
    print(f"register_stack: measured {np.hypot(shifts['dy'], shifts['dx']).max():.2f} px "
          f"max drift; residual after alignment {res['residual_px']:.3f} px")

    # dense per-pixel speckle contrast: the tile metrics at full resolution
    vis = dip.metrics.visibility_map((sharp * 1000 + 50).astype(np.float32), window=16,
                                     device=device)
    print(f"visibility_map: {vis.shape} map, contrast "
          f"{np.nanmin(vis):.3f}..{np.nanmax(vis):.3f}")

    # achieved resolution from two acquisitions: FRC of two independently
    # noisy copies of the same field
    noise = sharp.std() * 0.08
    acq = [sharp + rng.normal(size=sharp.shape).astype(np.float32) * noise
           for _ in range(2)]
    frc = dip.metrics.fourier_ring_correlation(acq[0], acq[1], device=device)
    print(f"fourier_ring_correlation: resolution "
          f"{frc['resolution_cyc_per_px']:.4f} cyc/px "
          f"({frc['resolution_px']:.2f} px) at threshold {frc['threshold']}")
    res["frc_px"] = float(frc["resolution_px"])

    if out_dir:
        from barc4dip_tpu_torch.plotting import plt_image, savefig

        savefig(plt_image(enhanced, "CLAHE", cmap="gray"), f"{out_dir}/ex05_clahe.png")
        print(f"wrote plots to {out_dir}")
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_05: the preprocessing chain.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
