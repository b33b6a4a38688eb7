# SPDX-License-Identifier: CECILL-2.1
"""barc4dip-cuda-batch: production stack processing with checkpoint/resume
(counterpart of ``barc4dip_tpu/report/batch_cli.py``).

Runs the full speckle-stack pipeline (or a sharpness focus scan) over an
HDF5 stack or a sequence of EDF/TIFF frames, out-of-core where possible,
writing a JSON summary, an optional .npz of the full outputs and an
optional Markdown report. Flags are those of ``barc4dip-batch``;
``--device`` is the one addition, the port's explicit device (default
``cuda``, which fails without a card; ``cpu`` runs on the CPU). ``--mesh``
shards the frames over every visible CUDA device
(``parallel.frame_mesh()``) where there are two or more; on one device, or
with ``--device cpu``, it shards nothing, as in the JAX script.

Examples
--------
python -m barc4dip_tpu_torch.report.batch_cli run.h5 --out results.json --npz results.npz
python -m barc4dip_tpu_torch.report.batch_cli 'scan_*.edf' --kind speckle \\
    --checkpoint-dir ./ckpt --report run.md
python -m barc4dip_tpu_torch.report.batch_cli focus_*.tif --kind sharpness
"""
from __future__ import annotations

import argparse
import glob
import json
import sys
from pathlib import Path

import numpy as np

from .cli import DEVICE_HELP, cli_device

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="barc4dip-cuda-batch",
        description="Batch stack analysis (speckle pipeline / sharpness scan) "
        "with checkpoint/resume.",
    )
    p.add_argument(
        "input",
        nargs="+",
        help="HDF5 stack file, or a glob / list of per-frame EDF/TIFF files.",
    )
    p.add_argument("--kind", choices=("speckle", "sharpness"), default="speckle")
    p.add_argument("--metrics", default="all", help="Metric groups (default: all).")
    p.add_argument("--no-tiles", dest="tiles", action="store_false")
    p.set_defaults(tiles=True)
    p.add_argument("--frame-chunk", type=int, default=8)
    p.add_argument("--mesh", action="store_true", help="Shard frames across all devices.")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--out", default=None, help="JSON summary path (default: stdout).")
    p.add_argument("--npz", default=None, help="Write full outputs as .npz.")
    p.add_argument("--report", default=None, help="Write a Markdown report.")
    p.add_argument("--tracking-method", default="template", choices=("template", "phase"))
    p.add_argument(
        "--search-radius", type=float, default=None,
        help="Restrict tracking correlations to a window of this radius (px) "
        "around each tile instead of the full-frame search; identical "
        "results while the drift stays inside the window (template method "
        "only).",
    )
    p.add_argument(
        "--register", choices=("first", "mean", "previous"), default=None,
        help="Align frames against this reference (drift correction, "
        "preprocessing.register_stack: upsampled-DFT phase correlation + "
        "subpixel Fourier re-shift) before the analysis. Loads the whole "
        "stack in memory (no out-of-core streaming with this flag); the "
        "measured shifts land in the JSON summary under 'registration'.",
    )
    p.add_argument(
        "--flat", default=None,
        help="Flat-field image, stack, or glob of files (mean-reduced) — "
        "applies (I-D)/(F-D)·scale before the analysis (same semantics "
        "as barc4dip-speckles -f). Loads the stack in memory.",
    )
    p.add_argument(
        "--dark", default=None,
        help="Dark image, stack, or glob of files (mean-reduced) for the "
        "flat-field correction (same semantics as barc4dip-speckles -d).",
    )
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    return p


def _expand_inputs(patterns: list[str]) -> list[str]:
    paths: list[str] = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else [pat])
    return paths


def _summary(out: dict) -> dict:
    meta = out.get("meta", {})
    summary: dict = {
        "kind": meta.get("kind"),
        "n_frames": meta.get("n_frames"),
        "input_shape": list(meta.get("input_shape", ())),
    }
    if "temporal" in out:
        tr = out["temporal"]["abs"]
        r = np.asarray(tr["r"], dtype=float)
        summary["tracking"] = {
            "mean_r_px": float(np.nanmean(r)),
            "max_r_px": float(np.nanmax(r)),
            "final_dx_px": float(np.asarray(tr["dx"])[-1]),
            "final_dy_px": float(np.asarray(tr["dy"])[-1]),
        }
    if "focus" in meta:
        summary["focus"] = meta["focus"]
    full = out.get("full", {})
    series: dict = {}
    for g, d in full.items():
        for k, v in d.items():
            if np.ndim(v) != 1:  # a per-frame series; a lazy map stack stays unread
                continue
            arr = np.asarray(v, dtype=float)
            series[f"{g}.{k}"] = {
                "mean": float(np.nanmean(arr)),
                "min": float(np.nanmin(arr)),
                "max": float(np.nanmax(arr)),
            }
    if series:
        summary["metric_series"] = series
    return summary


def _flatten_npz(out: dict, prefix="") -> dict:
    flat = {}
    for k, v in out.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_npz(v, f"{key}/"))
        elif isinstance(v, np.ndarray):
            flat[key] = v
        elif np.isscalar(v):
            flat[key] = np.asarray(v)
    return flat


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)

    import torch

    from ..models import SharpnessScanPipeline, SpeckleStackPipeline

    device = cli_device(args.device)
    mesh = None  # on one device there is nothing to shard
    if args.mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
        from ..parallel import frame_mesh

        mesh = frame_mesh()

    inputs = _expand_inputs(args.input)
    # calibration paths accept globs too (multi-file flats/darks stack and
    # mean-reduce inside flat_field_correction, like the positional input)
    flats = _expand_inputs([args.flat]) if args.flat else None
    darks = _expand_inputs([args.dark]) if args.dark else None
    missing = [p for p in inputs if not Path(p).is_file()]
    missing += [p for group in (flats, darks) if group
                for p in group if not Path(p).is_file()]
    if missing:
        what = "no files match" if any(ch in m for m in missing for ch in "*?[") \
            else "input file(s) not found"
        print(f"barc4dip-cuda-batch: error: {what}: {', '.join(missing)}", file=sys.stderr)
        return 2
    single_h5 = len(inputs) == 1 and inputs[0].lower().endswith((".h5", ".hdf5"))

    if args.kind == "sharpness":
        pipe = SharpnessScanPipeline(
            metrics=args.metrics, tiles=args.tiles,
            frame_chunk=args.frame_chunk, mesh=mesh, device=device,
        )
    else:
        pipe = SpeckleStackPipeline(
            metrics=args.metrics, tiles=args.tiles,
            tracking_method=args.tracking_method,
            frame_chunk=args.frame_chunk, mesh=mesh,
            tracking_search_radius=args.search_radius, device=device,
        )

    reg_shifts = None
    if args.register or args.flat or args.dark:
        # calibration / drift correction need the frames in memory (the
        # corrected stack feeds the pipeline), so streaming is bypassed
        from ..io import read_h5, read_image

        stack = read_h5(inputs[0]) if single_h5 else read_image(inputs)
        stack = np.asarray(stack, dtype=np.float32)
        if flats or darks:
            from ..preprocessing import flat_field_correction

            def _load(group):
                paths = group[0] if len(group) == 1 else group
                return np.asarray(read_image(paths), np.float32)

            stack = flat_field_correction(
                stack,
                flats=_load(flats) if flats else None,
                darks=_load(darks) if darks else None,
                device=device,
            )
        if args.register:
            from ..preprocessing import register_stack

            stack, reg_shifts = register_stack(
                stack, reference=args.register, frame_chunk=args.frame_chunk,
                device=device,
            )
        out = pipe(
            np.ascontiguousarray(stack), checkpoint_dir=args.checkpoint_dir
        )
    elif args.kind == "sharpness":
        if single_h5:
            from ..io import read_h5

            out = pipe(read_h5(inputs[0]), checkpoint_dir=args.checkpoint_dir)
        elif all(
            p.lower().endswith((".edf", ".edf.gz", ".edf.bz2", ".tif", ".tiff"))
            for p in inputs
        ):
            out = pipe.run_files(  # streaming out-of-core scan
                inputs, checkpoint_dir=args.checkpoint_dir
            )
        else:
            from ..io import read_image

            out = pipe(read_image(inputs), checkpoint_dir=args.checkpoint_dir)
    else:
        if single_h5:
            out = pipe.run_hdf5(
                inputs[0], checkpoint_dir=args.checkpoint_dir
            )
        elif all(
            p.lower().endswith((".edf", ".edf.gz", ".edf.bz2", ".tif", ".tiff"))
            for p in inputs
        ):
            # streaming out-of-core path: frames load per-chunk on demand
            out = pipe.run_files(inputs, checkpoint_dir=args.checkpoint_dir)
        else:
            from ..io import read_image

            out = pipe(
                np.asarray(read_image(inputs)), checkpoint_dir=args.checkpoint_dir
            )

    summary = _summary(out)
    if reg_shifts is not None:
        r = np.hypot(reg_shifts["dy"], reg_shifts["dx"])
        summary["registration"] = {
            "reference": reg_shifts["reference"],
            "max_r_px": float(r.max()) if r.size else 0.0,
            "final_dy_px": float(reg_shifts["dy"][-1]),
            "final_dx_px": float(reg_shifts["dx"][-1]),
        }
    text = json.dumps(summary, indent=2, default=str)
    if args.out:
        Path(args.out).write_text(text)
    else:
        sys.stdout.write(text + "\n")

    if args.npz:
        np.savez_compressed(args.npz, **_flatten_npz({k: v for k, v in out.items() if k != "meta"}))

    if args.report:
        from .markdown import logbook_report

        logbook_report(out, report_path=args.report)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
