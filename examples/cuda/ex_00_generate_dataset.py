# SPDX-License-Identifier: CECILL-2.1
"""ex_00 — generate a local example dataset with the PyTorch/CUDA port (no
network needed).

The workflow of ``examples/ex_00_generate_dataset.py`` on
``barc4dip_tpu_torch``: a drifting speckle stack, flat/dark calibration
frames and a single-frame scan series, written in every container the
port reads (HDF5 stack, TIFF calibrations, EDF scan series), so the other
examples and the console scripts have real files to read. Writing the HDF5
stack needs ``h5py``, the TIFFs Pillow.

Run: python examples/cuda/ex_00_generate_dataset.py [out_dir] [--device cpu]
Produces:
    out_dir/speckle_stack.h5      (T, H, W) uint16 ESRF-style dataset
    out_dir/flat.tif, dark.tif    calibration frames
    out_dir/scan_0000.edf ...     one EDF per scan point
    out_dir/README.txt            provenance + ground-truth motion
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

import barc4dip_tpu_torch as dip

# smoke-test knob: shrink the workload so every example runs in seconds
FAST = bool(os.environ.get("BARC4DIP_EX_FAST"))


def make_dataset(T=12, side=512, grain_px=6.0, seed=42):
    """Drifting speckle stack with known spiral motion + gain/offset."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    sig_f = 1.0 / (2.0 * np.pi * grain_px / 2.355)
    H = np.exp(-(f[None, :] ** 2 + f[:, None] ** 2) / (2 * sig_f**2))
    base_F = np.fft.fft2(a) * H

    ts = np.arange(T)
    dys = 0.3 * ts * np.cos(0.6 * ts)
    dxs = 0.3 * ts * np.sin(0.6 * ts)
    fy, fx = f[:, None], f[None, :]

    flat = rng.normal(2.0, 0.05, size=(side, side)).astype(np.float32)
    dark = rng.normal(100.0, 2.0, size=(side, side)).astype(np.float32)

    frames = np.empty((T, side, side), np.uint16)
    for t in range(T):
        phase = np.exp(-2j * np.pi * (fy * dys[t] + fx * dxs[t]))
        field = np.abs(np.fft.ifft2(base_F * phase)) ** 2
        counts = field / field.mean() * 8000.0 * flat + dark
        frames[t] = np.clip(counts, 0, 65535).astype(np.uint16)
    return frames, flat, dark, dys, dxs


def main(out_dir=None, device=None) -> Path:
    out = Path(out_dir) if out_dir else Path(tempfile.mkdtemp(prefix="barc4dip_data_"))
    out.mkdir(parents=True, exist_ok=True)

    T, side = (4, 256) if FAST else (12, 512)
    frames, flat, dark, dys, dxs = make_dataset(T=T, side=side)

    # HDF5 stack at the ESRF dataset path the readers expect
    h5_path = out / "speckle_stack.h5"
    if h5_path.exists():
        h5_path.unlink()
    dip.write_image(frames, str(h5_path), device=device)

    # calibration frames as TIFF (converted to uint16 on ``device``)
    dip.io.save_tiff((flat * 4000 + dark), out / "flat.tif", device=device)
    dip.io.save_tiff(dark, out / "dark.tif", device=device)

    # scan series: one EDF per point (standard beamline layout)
    for t in range(T):
        dip.io.save_edf(frames[t], out / f"scan_{t:04d}.edf")

    (out / "README.txt").write_text(
        "Synthetic barc4dip_tpu example dataset (ex_00, PyTorch/CUDA port)\n"
        f"stack: {T} frames of {side}x{side} uint16, spiral drift\n"
        "ground-truth shifts (dy, dx) per frame:\n"
        + "\n".join(f"  {t}: ({dys[t]:+.3f}, {dxs[t]:+.3f})" for t in range(T))
        + "\n"
    )

    print(f"> dataset written to {out}")
    print(f">   speckle_stack.h5 ({T}x{side}x{side}), flat.tif, dark.tif, "
          f"{T} EDF scan files")
    print(">   try: python -m barc4dip_tpu_torch.report.cli -s "
          f"{h5_path} -n 0 -f {out / 'flat.tif'} -d {out / 'dark.tif'}")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_00: write the example dataset.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
