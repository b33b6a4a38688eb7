# SPDX-License-Identifier: CECILL-2.1
"""ex_02 — flat-field correction + speckle statistics + logbook report with
the PyTorch/CUDA port (the workflow of
``examples/ex_02_speckle_statistics.py`` on ``barc4dip_tpu_torch``).

Run: python examples/cuda/ex_02_speckle_statistics.py [out_dir] [--device cpu]
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
    rng = np.random.default_rng(1)
    side = 384 if FAST else 1200
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    H = np.exp(-(f[None, :] ** 2 + f[:, None] ** 2) / (2 * (1 / (2 * np.pi * 6 / 2.355)) ** 2))
    raw = np.abs(np.fft.ifft2(np.fft.fft2(a) * H)) ** 2
    raw = (raw / raw.mean() * 8000).astype(np.float32)

    # synthetic detector gain + offset
    flat = rng.normal(2.0, 0.05, size=(side, side)).astype(np.float32)
    dark = rng.normal(100.0, 2.0, size=(side, side)).astype(np.float32)
    measured = raw * flat + dark

    corrected = dip.preprocessing.flat_field_correction(
        measured, flats=flat * 4000 + dark, darks=dark, scale="flat_median", device=device
    )

    stats = dip.speckle_stats(corrected, metrics="all", tiles=True, verbose=False, device=device)
    text = dip.logbook_report(stats, complete=True, notes=True)
    print(text)

    if out_dir:
        from barc4dip_tpu_torch.plotting import plt_histogram, plt_image, plt_tiles_metric, savefig

        savefig(plt_image(corrected, "corrected speckles", cmap="srw"), f"{out_dir}/ex02_image.png")
        savefig(plt_tiles_metric(corrected, stats, "grain.lx"), f"{out_dir}/ex02_tiles_lx.png")
        savefig(
            plt_histogram(np.asarray(corrected).astype(np.uint16), logy=True, cumulative=True),
            f"{out_dir}/ex02_histogram.png",
        )
        print(f"wrote plots to {out_dir}")
    return {"report": text, "visibility": float(stats["full"]["amplitude"]["visibility"])}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_02: speckle statistics of one image.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
