# SPDX-License-Identifier: CECILL-2.1
"""``barc4dip-cuda-speckles``: single-image speckle analysis from the shell
(counterpart of ``barc4dip_tpu/report/cli.py``).

Reads one detector image, optionally flat-/dark-corrects it, evaluates the
speckle metric groups on the card, and prints (or saves) the Markdown
logbook. Flag names, dests and defaults are those of ``barc4dip-speckles``,
so existing beamline scripts keep working. ``--device`` is the one addition:
the port's explicit device (default ``cuda``, which fails without a card;
``cpu`` runs on the CPU).

Usage::

    python -m barc4dip_tpu_torch.report.cli -s scan_0042.tif -o logbook.md
    python -m barc4dip_tpu_torch.report.cli -s run.h5 -n 12 --all --notes
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..config import resolve_device
from ..io import read_image
from ..metrics.speckles import speckle_stats
from ..preprocessing import flat_field_correction
from .markdown import logbook_report

__all__ = ["main"]

# Default metric selection when --all is not given: the quick-look trio
# (the full set adds the costlier bandwidth group).
_DEFAULT_GROUPS = ("amplitude", "grain", "stats")

_HDF5_SUFFIXES = {".h5", ".hdf5"}

DEVICE_HELP = (
    "where the analysis runs: the port's explicit device, not an analysis "
    "option (default: cuda, an error where no card is available; cpu runs "
    "on the CPU)"
)


def cli_device(name: str | None):
    """The device a console script runs on: ``--device`` as given, and
    without it the card, or a ``RuntimeError`` that names ``--device cpu``."""
    try:
        return resolve_device(name)
    except RuntimeError as exc:
        raise RuntimeError(f"{exc} (on the command line: --device cpu)") from None


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="barc4dip-cuda-speckles",
        description=(
            "Speckle-field quick analysis: metrics for one detector image, "
            "reported as a Markdown logbook entry."
        ),
    )
    add = parser.add_argument
    add("-s", "--speckle", dest="speckle_path", required=True,
        help="speckle image to analyse (TIFF, EDF or HDF5)")
    add("-n", "--image_number", dest="image_number", type=int, default=0,
        help="which frame of an HDF5 stack to use (default 0; "
             "other formats ignore this)")
    add("-f", "--flat", dest="flat_path", default=None,
        help="flat-field image for normalisation")
    add("-d", "--dark", dest="dark_path", default=None,
        help="dark-field image for normalisation")
    add("-o", "--out", dest="out_path", default=None,
        help="also write the report to this Markdown file")
    add("--no_tiles", dest="tiles", action="store_false", default=True,
        help="skip the 3x3 tile breakdown")
    add("--complete", dest="complete", action="store_true",
        help="report every tile block, not just the headline ones")
    add("--notes", dest="notes", action="store_true",
        help="append explanatory notes to the report")
    add("--all", dest="all_groups", action="store_true",
        help="evaluate every metric group instead of the default "
             "amplitude/grain/stats trio")
    add("--device", dest="device", default=None, help=DEVICE_HELP)
    return parser


def main(argv: list[str] | None = None) -> int:
    opts = _build_parser().parse_args(argv)
    device = cli_device(opts.device)

    speckle_path = str(opts.speckle_path)
    frame = (
        int(opts.image_number)
        if Path(speckle_path).suffix.lower() in _HDF5_SUFFIXES
        else None
    )
    image = read_image(speckle_path, image_number=frame)

    flats = read_image(str(opts.flat_path)) if opts.flat_path else None
    darks = read_image(str(opts.dark_path)) if opts.dark_path else None
    if flats is not None or darks is not None:
        # the corrected frame stays on the device: the metric program reads
        # it in place, so correction -> stats costs one upload and no pull
        image = flat_field_correction(
            image, flats=flats, darks=darks, as_numpy=False, device=device
        )

    stats = speckle_stats(
        image,
        metrics="all" if opts.all_groups else _DEFAULT_GROUPS,
        tiles=bool(opts.tiles),
        verbose=False,
        device=device,
    )

    report = logbook_report(
        stats,
        report_path=Path(opts.out_path) if opts.out_path else None,
        complete=bool(opts.complete),
        notes=bool(opts.notes),
    )
    sys.stdout.write(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
