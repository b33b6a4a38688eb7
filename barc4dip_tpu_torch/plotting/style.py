# SPDX-License-Identifier: CECILL-2.1
"""Plot styling, colormaps, pyplot wrappers (parity with reference
plotting/style.py:21-87; the colormap stop values are shared data constants)."""
from __future__ import annotations

import matplotlib.pyplot as plt
from matplotlib import rcParamsDefault
from matplotlib.colors import LinearSegmentedColormap
from matplotlib.figure import Figure

__all__ = ["start_plotting", "srw_cmap", "igor_cmap", "scan_cmap", "show", "savefig", "close"]


def start_plotting(k: float = 1.0) -> None:
    """Set global Matplotlib parameters with font sizes scaled by ``k``."""
    plt.rcParams.update(rcParamsDefault)
    plt.rcParams.update(
        {
            "text.usetex": False,
            "font.family": "DeJavu Serif",
            "font.serif": ["Times New Roman"],
        }
    )
    plt.rc("axes", titlesize=15 * k)
    plt.rc("axes", labelsize=14 * k)
    plt.rc("xtick", labelsize=13 * k)
    plt.rc("ytick", labelsize=13 * k)
    plt.rc("legend", fontsize=12 * k)


srw_cmap = LinearSegmentedColormap.from_list("srw_bw", [(0.0, "black"), (1.0, "white")])

igor_cmap = LinearSegmentedColormap.from_list(
    "igor",
    [
        (0.0, (0 / 255, 22 / 255, 65 / 255, 1)),
        (0.2, (0 / 255, 145 / 255, 232 / 255, 1)),
        (0.4, (128 / 255, 73 / 255, 116 / 255, 1)),
        (0.6, (255 / 255, 0 / 255, 0 / 255, 1)),
        (0.8, (255 / 255, 124 / 255, 2 / 255, 1)),
        (1.0, (255 / 255, 240 / 255, 48 / 255, 1)),
    ],
)

scan_cmap = LinearSegmentedColormap.from_list(
    "scan",
    [
        (0.00, (14 / 255, 14 / 255, 120 / 255, 1)),
        (0.17, (62 / 255, 117 / 255, 207 / 255, 1)),
        (0.30, (91 / 255, 190 / 255, 243 / 255, 1)),
        (0.43, (100 / 255, 200 / 255, 150 / 255, 1)),
        (0.59, (244 / 255, 213 / 255, 130 / 255, 1)),
        (0.71, (237 / 255, 158 / 255, 80 / 255, 1)),
        (0.85, (204 / 255, 90 / 255, 41 / 255, 1)),
        (1.00, (150 / 255, 20 / 255, 30 / 255, 1)),
    ],
)


def resolve_cmap(cmap: str):
    """Map the special names 'srw'/'igor'/'scan' to the custom colormaps."""
    if cmap == "srw":
        return srw_cmap
    if cmap == "igor":
        return igor_cmap
    if cmap == "scan":
        return scan_cmap
    return plt.get_cmap(cmap)


def show() -> None:
    plt.show()


def savefig(fig: Figure, file_name: str, *, dpi: int | None = None) -> None:
    fig.savefig(file_name, dpi=dpi, bbox_inches="tight")


def close(fig: Figure | None = None) -> None:
    if fig is None:
        plt.close()
    else:
        plt.close(fig)
