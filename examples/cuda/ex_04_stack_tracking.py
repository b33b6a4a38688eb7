# SPDX-License-Identifier: CECILL-2.1
"""ex_04 — speckle stack temporal statistics + translation tracking against
a known spiral motion with the PyTorch/CUDA port (the workflow of
``examples/ex_04_stack_tracking.py`` on ``barc4dip_tpu_torch``), spread
over every card where the machine has more than one.

Run: python examples/cuda/ex_04_stack_tracking.py [out_dir] [--device cpu]
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import barc4dip_tpu_torch as dip

# smoke-test knob: shrink the workload so every example runs in seconds
FAST = bool(os.environ.get("BARC4DIP_EX_FAST"))


def make_moving_stack(T=40, side=512, grain_px=6.0):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    H = np.exp(-(f[None, :] ** 2 + f[:, None] ** 2) / (2 * (1 / (2 * np.pi * grain_px / 2.355)) ** 2))
    base_F = np.fft.fft2(a) * H

    ts = np.arange(T)
    dys = 0.25 * ts * np.cos(ts * 0.4)
    dxs = 0.25 * ts * np.sin(ts * 0.4)
    fy, fx = f[:, None], f[None, :]
    frames = []
    for t in range(T):
        phase = np.exp(-2j * np.pi * (fy * dys[t] + fx * dxs[t]))
        field = np.abs(np.fft.ifft2(base_F * phase)) ** 2
        frames.append((field / field.mean() * 1000).astype(np.float32))
    return np.stack(frames), dys, dxs


def main(out_dir=None, device=None) -> dict:
    stack, dys, dxs = (
        make_moving_stack(T=8, side=256) if FAST else make_moving_stack()
    )

    # several cards: shard the frames across all of them
    on_card = device is None or torch.device(device).type == "cuda"
    mesh = dip.parallel.frame_mesh() if on_card and torch.cuda.device_count() > 1 else None

    out = dip.speckle_stack_stats(
        stack, metrics="amplitude,grain,stats", tiles=False, verbose=False, mesh=mesh,
        device=device,
    )

    got_dy = out["temporal"]["abs"]["dy"]
    got_dx = out["temporal"]["abs"]["dx"]
    err = float(np.max(np.hypot(got_dy - dys, got_dx - dxs)))
    print(f"tracked {len(dys)} frames; max trajectory error: {err:.3f} px")
    print("grain(t=0):", out["meta"]["grain0"])

    # Bounded-drift shortcut: when the motion is known to stay within a
    # radius, the windowed search gives the same displacements with much
    # less correlation work.
    win = dip.speckle_stack_stats(
        stack, metrics="amplitude,stats", tiles=False, verbose=False,
        mesh=mesh, tracking_search_radius=16, device=device,
    )
    dwin = float(np.max(
        np.hypot(
            win["temporal"]["abs"]["dy"] - got_dy,
            win["temporal"]["abs"]["dx"] - got_dx,
        )
    ))
    print(f"windowed search (r=16 px) vs full-frame: max delta {dwin:.2e} px")

    if out_dir:
        from barc4dip_tpu_torch.plotting import plt_displacement, plt_stack_metric, savefig

        savefig(plt_displacement(out, kind="trajectory"), f"{out_dir}/ex04_trajectory.png")
        savefig(
            plt_displacement(out, kind="timeseries", uncertainty="band"),
            f"{out_dir}/ex04_timeseries.png",
        )
        savefig(
            plt_stack_metric(out, "amplitude.visibility", scope="full"),
            f"{out_dir}/ex04_visibility.png",
        )
        print(f"wrote plots to {out_dir}")
    return {"err_px": err, "window_delta_px": dwin, "mesh": mesh}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ex_04: stack tracking against a spiral.")
    p.add_argument("out_dir", nargs="?", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
