# SPDX-License-Identifier: CECILL-2.1
"""ex_01 — sharpness scan over a focus stack with the PyTorch/CUDA port.

The workflow of ``examples/ex_01_sharpness_scan.py`` on
``barc4dip_tpu_torch``: a synthetic focus scan (progressively defocused
speckle frames), ``sharpness_stack_stats`` and the best-focus frame as the
argmax of the Tenengrad series; optionally diagnostic plots.

Run: python examples/cuda/ex_01_sharpness_scan.py [out_dir] [--device cpu]
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
from scipy.ndimage import gaussian_filter

import barc4dip_tpu_torch as dip

# smoke-test knob: shrink the workload so every example runs in seconds
FAST = bool(os.environ.get("BARC4DIP_EX_FAST"))


def make_focus_stack(n=11, side=512, grain_px=4.0):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    H = np.exp(-(f[None, :] ** 2 + f[:, None] ** 2) / (2 * (1 / (2 * np.pi * grain_px / 2.355)) ** 2))
    base = np.abs(np.fft.ifft2(np.fft.fft2(a) * H)) ** 2
    base = (base / base.mean() * 1000).astype(np.float32)
    sigmas = np.abs(np.arange(n) - n // 2) * 0.8  # best focus mid-scan
    return np.stack([gaussian_filter(base, s).astype(np.float32) for s in sigmas]), sigmas


def main(out_dir=None, device=None) -> dict:
    stack, sigmas = (
        make_focus_stack(n=5, side=256) if FAST else make_focus_stack()
    )
    out = dip.sharpness_stack_stats(
        stack, metrics="gradient,laplacian,spectral", tiles=False, verbose=False,
        device=device,
    )
    ten = out["full"]["gradient"]["tenengrad"]
    best = int(np.argmax(ten))
    print(f"best-focus frame: {best} (true: {len(sigmas)//2})")
    print("tenengrad series:", np.array2string(ten, precision=1))

    stats = dip.sharpness_stats(stack[best], verbose=False, device=device)
    report = dip.logbook_report(stats)
    print(report)

    if out_dir:
        from barc4dip_tpu_torch.plotting import plt_stack_metric, savefig

        fig = plt_stack_metric(out, "gradient.tenengrad", scope="full")
        savefig(fig, f"{out_dir}/ex01_tenengrad_scan.png")
        print(f"wrote {out_dir}/ex01_tenengrad_scan.png")
    return {"best": best, "true": len(sigmas) // 2, "report": report}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_01: sharpness over a focus scan.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
