# SPDX-License-Identifier: CECILL-2.1
"""ex_03 — FFT / PSD / autocorrelation analysis of a speckle field with the
PyTorch/CUDA port: spectra, radial means, spectral plots (the workflow of
``examples/ex_03_fourier_analysis.py`` on ``barc4dip_tpu_torch``).

Run: python examples/cuda/ex_03_fourier_analysis.py [out_dir] [--device cpu]
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

import barc4dip_tpu_torch as dip

# smoke-test knob: shrink the workload so every example runs in seconds
FAST = bool(os.environ.get("BARC4DIP_EX_FAST"))


def main(out_dir=None, device=None) -> dict:
    rng = np.random.default_rng(2)
    side, pixel_um = (256 if FAST else 1024), 0.65
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    H = np.exp(-(f[None, :] ** 2 + f[:, None] ** 2) / (2 * (1 / (2 * np.pi * 8 / 2.355)) ** 2))
    field = np.abs(np.fft.ifft2(np.fft.fft2(a) * H)) ** 2
    field = (field / field.mean() * 1000).astype(np.float32)

    # physically calibrated spectra (cycles/um) from one upload: PSD,
    # autocorrelation (kernel K1a on the card) and both radial means
    summary = dip.signal.spectral_summary(
        field, dx=pixel_um, dy=pixel_um, scale=True, device=device
    )
    P, fx, fy = summary["psd"], summary["fx"], summary["fy"]
    rad_i, r_i = summary["radial_interpolated"], summary["r_interpolated"]

    # the maps stay on the device; bring one to the host by its half
    ac = dip.signal.pull_centrosymmetric(summary["autocorr"])

    w, hit = dip.maths.width_at_fraction(ac[side // 2, :], fraction=1 / np.e, device=device)
    print(f"autocorr 1/e full width: {w * pixel_um:.2f} um ({w:.2f} px), hit_edge={hit}")
    d, _ = dip.maths.distance_at_fraction_from_peak(
        np.asarray(rad_i), fraction=1 / np.e, device=device
    )
    print(f"radial 1/e radius: {d:.2f} px -> leq = {2 * d * (r_i[1] - r_i[0]):.2f} px")

    # scan-series form: per-frame radial profiles through the chunked
    # pipeline (radial curves only; the per-frame maps stay on the device)
    scan = np.stack([field * (1 + 0.05 * t) for t in range(4)])
    series = dip.signal.spectral_summary_stack(scan, dx=pixel_um, dy=pixel_um, device=device)
    print(f"scan radial profiles: {series['radial_interpolated'].shape}")

    if out_dir:
        from barc4dip_tpu_torch.plotting import (
            plt_radial_waterfall, plt_spectrum1d, plt_spectrum2d, savefig,
        )

        savefig(plt_radial_waterfall(series, zlabel="autocorr"),
                f"{out_dir}/ex03_radial_waterfall.png")

        figs = plt_spectrum2d(P, x=fx, y=fy, log_intensity=True,
                              mask_center=True, xlabel="fx (1/um)", ylabel="fy (1/um)")
        savefig(figs["intensity"], f"{out_dir}/ex03_psd.png")
        fig = plt_spectrum1d(np.asarray(rad_i), np.asarray(r_i), logy=True,
                             cumulative=True, xlabel="r (px)", ylabel="autocorr")
        savefig(fig, f"{out_dir}/ex03_radial.png")
        print(f"wrote plots to {out_dir}")
    return {"width_px": float(w), "hit_edge": bool(hit), "radius_px": float(d),
            "series_shape": tuple(series["radial_interpolated"].shape)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_03: Fourier quick-look of one image.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
