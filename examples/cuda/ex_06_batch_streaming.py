# SPDX-License-Identifier: CECILL-2.1
"""ex_06 — production batch workflow with the PyTorch/CUDA port: stream a
mixed EDF/TIFF scan series out-of-core through the speckle pipeline with
checkpoint/resume, then emit the JSON summary + Markdown report through
``barc4dip-cuda-batch`` (the workflow of
``examples/ex_06_batch_streaming.py`` on ``barc4dip_tpu_torch``). Where
Pillow does not import, every frame is written as EDF instead.

Run: python examples/cuda/ex_06_batch_streaming.py [out_dir] [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np


def make_frames(out_dir: Path, T=8, side=256, grain_px=6.0):
    """Write a synthetic drifting speckle scan as alternating EDF/TIFF."""
    from barc4dip_tpu_torch.io import save_edf

    try:
        from PIL import Image
    except ImportError:
        Image = None
        print("> Pillow does not import here: every frame is written as EDF")

    rng = np.random.default_rng(6)
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    sigma_f = 1.0 / (2.0 * np.pi * (grain_px / 2.355))
    base_F = np.fft.fft2(a) * np.exp(
        -(f[None, :] ** 2 + f[:, None] ** 2) / (2 * sigma_f**2)
    )
    fy, fx = f[:, None], f[None, :]

    paths = []
    for t in range(T):
        dy, dx = 0.2 * t, -0.15 * t
        field = np.abs(np.fft.ifft2(base_F * np.exp(-2j * np.pi * (fy * dy + fx * dx)))) ** 2
        frame = np.clip(field / field.mean() * 8000.0, 0, 65535).astype(np.uint16)
        if t % 2 == 0 or Image is None:
            p = out_dir / f"scan_{t:04d}.edf"
            save_edf(frame, p)
        else:
            p = out_dir / f"scan_{t:04d}.tif"
            Image.fromarray(frame).save(p)
        paths.append(str(p))
    return paths


def main(out_dir=None, device=None) -> dict:
    out_dir = Path(out_dir) if out_dir else Path(tempfile.mkdtemp())
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = make_frames(out_dir)
    print(f"> wrote {len(paths)} frames under {out_dir}")

    # Python API: streaming pipeline with chunk-level checkpoint/resume
    from barc4dip_tpu_torch.models import SpeckleStackPipeline

    pipe = SpeckleStackPipeline(metrics="amplitude,stats", tiles=False, frame_chunk=4,
                                device=device)
    out = pipe.run_files(paths, checkpoint_dir=out_dir / "ckpt")
    r = out["temporal"]["abs"]["r"]
    print(f"> tracked drift: r[final] = {float(r[-1]):.2f} px over {len(r)} frames")

    # the same run through barc4dip-cuda-batch (resumes from the checkpoints)
    from barc4dip_tpu_torch.report.batch_cli import main as batch_main

    globs = sorted({str(out_dir / f"scan_*{Path(p).suffix}") for p in paths})
    rc = batch_main([
        *globs,
        "--metrics", "amplitude,stats", "--no-tiles", "--frame-chunk", "4",
        "--checkpoint-dir", str(out_dir / "ckpt"),
        "--out", str(out_dir / "summary.json"),
        "--report", str(out_dir / "report.md"),
        *([] if device is None else ["--device", str(device)]),
    ])
    print(f"> barc4dip-cuda-batch rc={rc}; summary + report in {out_dir}")
    return {"rc": rc, "r_final_px": float(r[-1]), "frames": len(r), "out_dir": out_dir}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_06: batch streaming with checkpoints.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    raise SystemExit(main(args.out_dir, device=args.device)["rc"])
