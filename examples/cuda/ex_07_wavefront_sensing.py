# SPDX-License-Identifier: CECILL-2.1
"""ex_07 — dense X-ray speckle-tracking wavefront sensing with the
PyTorch/CUDA port (the workflow of ``examples/ex_07_wavefront_sensing.py``
on ``barc4dip_tpu_torch``).

A speckle pattern is distorted by a known parabolic wavefront (spherical
beam): each sub-aperture's local displacement is proportional to the local
wavefront slope. Dense tracking (kernel K3 on the card) plus
Frankot-Chellappa integration recovers the wavefront; the fitted curvature
radius is compared to the ground truth.

Run: python examples/cuda/ex_07_wavefront_sensing.py [out_dir] [--device cpu]
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
from scipy.ndimage import map_coordinates

from barc4dip_tpu_torch.models import WavefrontScanPipeline

FAST = bool(os.environ.get("BARC4DIP_EX_FAST"))

PIXEL = 1.0e-6     # detector pixel [m]
DIST = 0.5         # speckle generator -> detector [m]
R_TRUE = 30.0      # wavefront curvature radius [m]


def make_speckle(side, grain_px=3.0, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    H = np.exp(
        -(f[None, :] ** 2 + f[:, None] ** 2)
        / (2 * (1 / (2 * np.pi * grain_px / 2.355)) ** 2)
    )
    field = np.abs(np.fft.ifft2(np.fft.fft2(a) * H)) ** 2
    return (field / field.mean() * 1000).astype(np.float64)


def main(out_dir=None, device=None) -> dict:
    side = 384 if FAST else 1024
    ref = make_speckle(side)

    # spherical wavefront W = r^2/(2R): slope r/R, displacement slope*D/px
    yy = (np.arange(side) - side / 2)[:, None] * PIXEL
    xx = (np.arange(side) - side / 2)[None, :] * PIXEL
    dy_map = (yy / R_TRUE) * DIST / PIXEL * np.ones((1, side))
    dx_map = (xx / R_TRUE) * DIST / PIXEL * np.ones((side, 1))
    gy, gx = np.mgrid[0:side, 0:side].astype(np.float64)
    sample = map_coordinates(ref, [gy - dy_map, gx - dx_map], order=3, mode="reflect")

    pipe = WavefrontScanPipeline(
        pixel_size=PIXEL, distance=DIST, wavelength=1e-10,
        tile_size=33, step=16, search_radius=8, device=device,
    )
    out = pipe(sample.astype(np.float32), ref.astype(np.float32))

    # fit the curvature radius from the recovered wavefront: W = r^2/(2R)
    Y, X = np.meshgrid(out["y"], out["x"], indexing="ij")
    r2 = ((Y - side / 2) ** 2 + (X - side / 2) ** 2) * PIXEL**2
    w = out["wavefront"]
    inner = (slice(2, -2), slice(2, -2))
    A = np.vstack([r2[inner].ravel(), np.ones(r2[inner].size)]).T
    coef, *_ = np.linalg.lstsq(A, w[inner].ravel(), rcond=None)
    R_fit = 1.0 / (2.0 * coef[0])
    print(f"grid {out['meta']['grid_shape']}, NCC peak median "
          f"{np.median(out['peak']):.3f}")
    print(f"curvature radius: fitted {R_fit:.2f} m vs true {R_TRUE:.1f} m "
          f"({100 * abs(R_fit - R_TRUE) / R_TRUE:.1f}% off)")
    assert abs(R_fit - R_TRUE) / R_TRUE < 0.1, "curvature fit off by >10%"

    if out_dir:
        from barc4dip_tpu_torch.plotting import plt_displacement_field, plt_image, savefig

        savefig(plt_image(out["wavefront"] * 1e9,
                          title="recovered wavefront [nm]"),
                f"{out_dir}/ex07_wavefront.png")
        savefig(plt_displacement_field(out, quiver_step=3,
                                       title="speckle displacements"),
                f"{out_dir}/ex07_displacements.png")
        print(f"wrote plots to {out_dir}")
    return {"R_fit": float(R_fit), "R_true": R_TRUE, "method": out["meta"]["method"]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_07: XST wavefront sensing.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
