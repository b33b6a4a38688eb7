# SPDX-License-Identifier: CECILL-2.1
"""Markdown logbook reports (the port's own copy of
``barc4dip_tpu/report/markdown.py``; host code on numpy, so the two return
the same string for the same stats dict).

Output-format parity with reference report/markdown.py:37-848 (same headers,
summary-line formats, side-by-side mean±std 3x3 tile matrices, notes blocks),
implemented as data-driven block specifications instead of repeated
formatting code. Extensible via the same kind-keyed registry pattern.

Deviation from the reference (documented intent, SURVEY §2.12.5): the
sharpness moments line prints the actual "variance" value; the reference
reads the nonexistent key 'var' and always prints "nan".
"""
from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Callable

import numpy as np

from ..utils import now
from ..utils.profiling import annotate

__all__ = ["logbook_report", "register_formatter"]

_LogbookFormatter = Callable[..., str]
_LOGBOOK_FORMATTERS: dict[str, _LogbookFormatter] = {}


def register_formatter(kind: str) -> Callable[[_LogbookFormatter], _LogbookFormatter]:
    """Register a logbook formatter for ``meta['kind'] == kind``."""
    kind_norm = kind.strip().lower()

    def _decorator(fn: _LogbookFormatter) -> _LogbookFormatter:
        _LOGBOOK_FORMATTERS[kind_norm] = fn
        return fn

    return _decorator


@annotate("entry.logbook_report")
def logbook_report(
    stats: dict,
    report_path: str | Path | None = None,
    *,
    complete: bool = False,
    notes: bool = False,
) -> str:
    """Build (and optionally write) a compact Markdown logbook summary from a
    metrics-aggregator dict. ``complete`` adds extra tile blocks; ``notes``
    adds explanatory bullets."""
    if not isinstance(stats, dict):
        raise TypeError("logbook_report expects stats to be a dict")

    meta = stats.get("meta")
    if not isinstance(meta, dict):
        raise ValueError("stats must contain dict key 'meta'")

    resolved_kind = meta.get("kind")
    if not isinstance(resolved_kind, str) or not resolved_kind.strip():
        raise ValueError("Cannot determine report kind. Set stats['meta']['kind'].")
    resolved_kind = resolved_kind.strip().lower()

    formatter = _LOGBOOK_FORMATTERS.get(resolved_kind)
    if formatter is None:
        supported = ", ".join(sorted(_LOGBOOK_FORMATTERS))
        raise ValueError(
            f"Unsupported report kind: {resolved_kind!r}. Supported: {supported}"
        )

    text = formatter(stats, complete=complete, notes=notes)

    if report_path is not None:
        report_path = Path(report_path)
        if not report_path.parent.exists():
            raise FileNotFoundError(
                f"Parent directory does not exist: {report_path.parent}"
            )
        report_path.write_text(text, encoding="utf-8")

    return text


# ---------------------------------------------------------------------------
# formatting primitives
# ---------------------------------------------------------------------------

def _f(x: object, ndigits: int) -> str:
    if x is None:
        return "nan"
    if isinstance(x, (int, float, np.floating)):
        if ndigits <= 0:
            return f"{float(x):.0f}"
        return f"{float(x):.{ndigits}f}"
    return str(x)


def _format_tile_labels(tile_labels: object) -> list[str]:
    arr = np.asarray(tile_labels, dtype=object)
    if arr.shape != (3, 3):
        return [str(tile_labels)]
    return [
        f"{arr[0,0]}  {arr[0,1]}  {arr[0,2]}",
        f"{arr[1,0]}   {arr[1,1]}  {arr[1,2]}",
        f"{arr[2,0]}  {arr[2,1]}  {arr[2,2]}",
    ]


def _matrix_rows(mean: np.ndarray, std: np.ndarray, fmt: str) -> list[str]:
    return [
        "  ".join(fmt.format(mean[i, j]) + "±" + fmt.format(std[i, j]) for j in range(3))
        for i in range(3)
    ]


def _append_tiles_pair(
    lines: list[str],
    tiles: dict | None,
    group: str,
    left: tuple[str, str, str],
    right: tuple[str, str, str] | None,
    *,
    gap: int = 4,
) -> None:
    """Append a tiles block: paired (side-by-side) or single mean±std matrix.

    ``left``/``right`` are (field_key, title, value_format) triples.
    """
    if tiles is None:
        return
    g = tiles.get(group)
    if not isinstance(g, dict):
        return

    def grids(key):
        d = g.get(key)
        if not isinstance(d, dict) or "mean" not in d or "std" not in d:
            return None
        m = np.asarray(d["mean"], dtype=float)
        s = np.asarray(d["std"], dtype=float)
        if m.shape != (3, 3) or s.shape != (3, 3):
            return None
        return m, s

    lg = grids(left[0])
    if lg is None:
        return

    if right is None:
        lines.append(left[1])
        lines.append("```")
        lines.extend(_matrix_rows(*lg, left[2]))
        lines.append("```")
        lines.append("")
        return

    rg = grids(right[0])
    if rg is None:
        return

    lrows = _matrix_rows(*lg, left[2])
    rrows = _matrix_rows(*rg, right[2])
    left_width = max(len(s) for s in lrows)

    lines.append(left[1].ljust(left_width + gap) + right[1])
    lines.append("```")
    for i in range(3):
        lines.append(lrows[i].ljust(left_width) + " " * gap + rrows[i])
    lines.append("```")
    lines.append("")


def _metadata_block(meta: dict, *, notes: bool) -> list[str]:
    lines = ["## Metadata"]

    input_shape = meta.get("input_shape")
    if (
        isinstance(input_shape, (tuple, list))
        and len(input_shape) == 2
        and all(isinstance(v, (int, np.integer)) for v in input_shape)
    ):
        lines.append(f"- Image shape: {int(input_shape[0])} x {int(input_shape[1])} px")
    else:
        lines.append("- Image shape: (unknown)")

    display_origin = meta.get("display_origin", "unknown")
    convention = {
        "lower": "detector-aligned, origin at bottom-left",
        "upper": "numpy-aligned, origin at top-left",
    }.get(display_origin, "unknown")
    lines.append(f"- Image orientation: {display_origin} ({convention})")

    if "tile_grid_shape" in meta:
        tile_mode = meta.get("tile_mode", "unknown")
        tile_shape_px = meta.get("tile_shape_px")
        if (
            isinstance(tile_shape_px, (tuple, list))
            and len(tile_shape_px) == 2
            and all(isinstance(v, (int, np.integer)) for v in tile_shape_px)
        ):
            lines.append(
                f"- Tiles: {tile_mode}, tile shape: {int(tile_shape_px[0])} x {int(tile_shape_px[1])} px"
            )
        else:
            lines.append(f"- Tiles: {tile_mode}")
        if notes:
            tile_labels = meta.get("tile_labels")
            if tile_labels is not None:
                lines.append("- Tile order: row-major (NW, N, NE; W, C, E; SW, S, SE)")
                lines.append("")
                lines.append("Tile labels:")
                lines.append("```")
                lines.extend(_format_tile_labels(tile_labels))
                lines.append("```")

    lines.append("")
    return lines


# ---------------------------------------------------------------------------
# declarative block specifications
# ---------------------------------------------------------------------------

Pair = tuple[tuple[str, str, str], tuple[str, str, str] | None]


@dataclass(frozen=True)
class Block:
    group: str
    title: str
    summary: Callable[[dict], str]
    pairs: tuple[Pair, ...] = ()
    complete_pairs: tuple[Pair, ...] = ()
    notes: tuple[str, ...] = ()


_SPECKLE_BLOCKS: tuple[Block, ...] = (
    Block(
        group="amplitude",
        title="## Amplitude (full image)",
        summary=lambda a: (
            f"> visibility: {_f(a.get('visibility'), 3)} | contrast: {_f(a.get('contrast'), 3)}"
        ),
        pairs=(
            (("visibility", "Visibility (tiles)", "{:.3f}"), ("contrast", "Contrast (tiles)", "{:.3f}")),
        ),
        notes=(
            "Notes: ",
            " - visibility: std(I)/mean(I).",
            " - contrast: (I_high - I_low)/(I_high + I_low), where I_low and I_high",
            "   are obtained from a 99.5% percentile-based min/max range.",
            "",
        ),
    ),
    Block(
        group="grain",
        title="## Grain (full image)",
        summary=lambda g: (
            f"> grain: lx={_f(g.get('lx'), 2)} | ly={_f(g.get('ly'), 2)} | "
            f"lx/ly={_f(g.get('r'), 2)} | leq={_f(g.get('leq'), 2)}"
        ),
        pairs=((("lx", "lx (tiles)", "{:.2f}"), ("ly", "ly (tiles)", "{:.2f}")),),
        complete_pairs=(
            (("r", "lx/ly (tiles)", "{:.2f}"), ("leq", "leq (tiles)", "{:.2f}")),
        ),
        notes=(
            "Notes: ",
            " - units in pixel",
            " - speckle grain metrics are computed from the autocorrelation peak",
            " - widths are given as 1/e values",
            " - leq: 1/e radius of the radially averaged autocorrelation",
            "",
        ),
    ),
    Block(
        group="stats",
        title="## Moments (full image)",
        summary=lambda s: (
            f"> moments: mean={_f(s.get('mean'), 0)} | std={_f(s.get('std'), 0)} | "
            f"skew={_f(s.get('skewness'), 2)} | kurt={_f(s.get('kurtosis'), 2)} | "
            f"SNR={_f(s.get('SNRdB'), 2)} dB"
        ),
        pairs=((("mean", "mean (tiles)", "{:.0f}"), ("std", "std (tiles)", "{:.0f}")),),
        complete_pairs=(
            (("skewness", "skewness (tiles)", "{:.2f}"), ("kurtosis", "kurtosis (tiles)", "{:.2f}")),
            (("SNRdB", "SNR dB (tiles)", "{:.2f}"), None),
        ),
        notes=(
            "Notes: ",
            " - units in gray scale (uint16)",
            " - **skewness** shows the *asymmetry* of the distribution.",
            "    (if positive, the histogram has a longer “tail” on the right side; if negative, on the left)",
            " - **Kurtosis** shows the *peakedness* of the profile.",
            "    (A Gaussian beam has kurtosis ≈ 0 in the “excess” convention,",
            "     if positive, the histogram has a sharper peak and heavier tails,",
            "     if neagtive, the histogram has a flatter, more top-hat-like profile)",
            " - SNR dB: 20*log10(mean/std)",
            "",
        ),
    ),
    Block(
        group="bandwidth",
        title="## Bandwidth (full image)",
        summary=lambda b: (
            f"> bandwidth: fx={_f(b.get('sig_fx'), 4)} | fy={_f(b.get('sig_fy'), 4)} | "
            f"fx/fy={_f(b.get('rf'), 2)} | feq={_f(b.get('feq'), 4)} | "
            f"f95={_f(b.get('f95'), 4)}"
        ),
        pairs=(
            (("sig_fx", "fx (tiles)", "{:.4f}"), ("sig_fy", "fy (tiles)", "{:.4f}")),
        ),
        complete_pairs=(
            (("rf", "fx/fy (tiles)", "{:.2f}"), ("feq", "feq (tiles)", "{:.4f}")),
            (("f95", "f95 (tiles)", "{:.4f}"), None),
        ),
        notes=(
            "Notes: ",
            " - units in cycles/pixel",
            " - fx, fy: RMS bandwidth computed from the 2D PSD",
            " - feq: radial RMS bandwidth computed from the 2D PSD",
            " - f95: radial frequency such that 95% of the PSD energy is contained",
            "",
        ),
    ),
)


def _sharp_autocorr_summary(a: dict) -> str:
    sx, sy = a.get("sx"), a.get("sy")
    try:
        ratio = float(sx) / float(sy)
    except Exception:
        ratio = None
    return (
        f"> inv_ac_width: sx={_f(sx, 4)} | sy={_f(sy, 4)} | "
        f"sx/sy={_f(ratio, 3)} | seq={_f(a.get('seq'), 4)} | r(lx/ly)={_f(a.get('r'), 3)}"
    )


_SHARPNESS_BLOCKS: tuple[Block, ...] = (
    Block(
        group="stats",
        title="## Moments (full image)",
        summary=lambda s: (
            f"> moments: mean={_f(s.get('mean'), 0)} | std={_f(s.get('std'), 0)} | "
            f"var={_f(s.get('variance'), 0)} | skew={_f(s.get('skewness'), 2)} | "
            f"kurt={_f(s.get('kurtosis'), 2)} | SNR={_f(s.get('SNRdB'), 2)} dB"
        ),
        pairs=((("mean", "Mean (tiles)", "{:.0f}"), ("std", "Std (tiles)", "{:.0f}")),),
        complete_pairs=(
            (("skewness", "Skewness (tiles)", "{:.2f}"), ("kurtosis", "Kurtosis (tiles)", "{:.2f}")),
            (("SNRdB", "SNR dB (tiles)", "{:.2f}"), ("variance", "Variance (tiles)", "{:.0f}")),
        ),
        notes=(
            "Notes: ",
            " - units in gray scale (uint16)",
            " - std/var quantify fluctuation amplitude; larger -> stronger modulation",
            " - skew/kurtosis indicate deviation from Gaussian statistics (0 = Gaussian noise)",
            " - sSNR dB = 20·log10(mean/std); lower -> stronger relative fluctuations;",
            "",
        ),
    ),
    Block(
        group="gradient",
        title="## Tenengrad (full image)",
        summary=lambda g: (
            f"> tenengrad: {_f(g.get('tenengrad'), 1)} | ex: {_f(g.get('ex'), 1)} | "
            f"ey: {_f(g.get('ey'), 1)} | ex/ey: {_f(g.get('re'), 3)}"
        ),
        pairs=((("tenengrad", "Tenengrad (tiles)", "{:.1f}"), None),),
        complete_pairs=(
            (("ex", "ex (tiles)", "{:.1f}"), ("ey", "ey (tiles)", "{:.1f}")),
            (("re", "ex/ey (tiles)", "{:.3f}"), None),
        ),
        notes=(
            "Notes: ",
            " - Sobel gradient energy: mean(Gx^2 + Gy^2)",
            " - ex and ey are directional gradient energies (mean(Gx^2), mean(Gy^2))",
            " - higher -> stronger spatial gradients and sharper local transitions",
            "",
        ),
    ),
    Block(
        group="laplacian",
        title="## Laplacian (full image)",
        summary=lambda l: f"> laplacian variance: {_f(l.get('laplacian_variance'), 1)}",
        pairs=((("laplacian_variance", "Laplacian variance (tiles)", "{:.1f}"), None),),
        notes=(
            "Notes: ",
            " - variance of Laplacian (second-derivative focus operator)",
            " - higher -> stronger fine-scale detail; may increase with high-frequency noise",
            "",
        ),
    ),
    Block(
        group="spectral",
        title="## Spectral entropy (full image)",
        summary=lambda sp: f"> spectral_entropy: {_f(sp.get('spectral_entropy'), 6)}",
        pairs=((("spectral_entropy", "Spectral entropy (tiles)", "{:.6f}"), None),),
        notes=(
            "Notes: ",
            " - Shannon entropy applied to the normalized 2D PSD (dimensionless)",
            " - higher -> flatter/broader spectrum; lower -> more concentrated spectrum",
            "",
        ),
    ),
    Block(
        group="autocorrelation",
        title="## Inverse autocorrelation width (full image)",
        summary=_sharp_autocorr_summary,
        pairs=((("sx", "sx (tiles)", "{:.4f}"), ("sy", "sy (tiles)", "{:.4f}")),),
        complete_pairs=(
            (("seq", "seq (tiles)", "{:.4f}"), ("r", "r(lx/ly) (tiles)", "{:.3f}")),
        ),
        notes=(
            "Notes: ",
            " - computed from normalized autocorrelation peak widths (1/e)",
            " - sx, sy, seq are inverse widths (1/pixel).",
            " - larger -> smaller correlation length (finer spatial features)",
            " - r(lx/ly) is an anisotropy ratio in the width domain",
            "",
        ),
    ),
    Block(
        group="eigenvalues",
        title="## Eigenvalues (full image)",
        summary=lambda e: (
            f"> eigenvalues: {_f(e.get('eigenvalues'), 6)} | e1: {_f(e.get('e1'), 6)} | "
            f"e2: {_f(e.get('e2'), 6)} | e1/e2: {_f(e.get('re'), 3)}"
        ),
        pairs=((("eigenvalues", "Sum eigenvalues (tiles)", "{:.6g}"), None),),
        complete_pairs=(
            (("e1", "e1 (tiles)", "{:.6g}"), ("e2", "e2 (tiles)", "{:.6g}")),
            (("re", "e1/e2 (tiles)", "{:.3f}"), None),
        ),
        notes=(
            "Notes: ",
            " - sum of leading structure-tensor eigenvalues at smoothing scale k",
            " - larger -> stronger directional gradient energy (scale-dependent)",
            " - e1/e2 is a simple anisotropy proxy",
            "",
        ),
    ),
)


def _render(
    stats: dict, *, heading: str, blocks: tuple[Block, ...], complete: bool, notes: bool
) -> str:
    meta = stats.get("meta")
    full = stats.get("full")
    if not isinstance(meta, dict) or not isinstance(full, dict):
        raise ValueError("stats must contain dict keys 'meta' and 'full'")

    tiles = stats.get("tiles") if isinstance(stats.get("tiles"), dict) else None

    lines: list[str] = [
        heading,
        f"{datetime.fromtimestamp(now()).strftime('%Y-%m-%d | %H:%M:%S')}",
        "",
    ]
    lines.extend(_metadata_block(meta, notes=notes))

    for block in blocks:
        if block.group not in full:
            continue
        values = full[block.group]
        lines.append(block.title)
        lines.append("```")
        lines.append(block.summary(values))
        lines.append("```")
        lines.append("")

        for left, right in block.pairs:
            _append_tiles_pair(lines, tiles, block.group, left, right)
        if complete:
            for left, right in block.complete_pairs:
                _append_tiles_pair(lines, tiles, block.group, left, right)
        if notes and block.notes:
            lines.extend(block.notes)

    return "\n".join(lines).rstrip() + "\n"


@register_formatter("speckles")
def _logbook_speckles(stats: dict, *, complete: bool = False, notes: bool = False) -> str:
    return _render(
        stats,
        heading="# Speckle summary",
        blocks=_SPECKLE_BLOCKS,
        complete=complete,
        notes=notes,
    )


@register_formatter("sharpness")
def _logbook_sharpness(stats: dict, *, complete: bool = False, notes: bool = False) -> str:
    return _render(
        stats,
        heading="# Sharpness summary",
        blocks=_SHARPNESS_BLOCKS,
        complete=complete,
        notes=notes,
    )


# ---------------------------------------------------------------------------
# stack summaries (extension beyond the reference registry, which rejects
# *_stack_stats kinds)
# ---------------------------------------------------------------------------

def _stack_header(meta: dict, heading: str) -> list[str]:
    lines = [
        heading,
        f"{datetime.fromtimestamp(now()).strftime('%Y-%m-%d | %H:%M:%S')}",
        "",
        "## Metadata",
    ]
    shape = meta.get("stack_shape")
    if isinstance(shape, (tuple, list)) and len(shape) == 3:
        lines.append(
            f"- Stack shape: {int(shape[0])} frames x {int(shape[1])} x {int(shape[2])} px"
        )
    origin = meta.get("display_origin", "unknown")
    lines.append(f"- Image orientation: {origin}")
    lines.append("")
    return lines


@register_formatter("sharpness_stack_stats")
def _logbook_sharpness_stack(stats: dict, *, complete: bool = False, notes: bool = False) -> str:
    meta = stats.get("meta", {})
    lines = _stack_header(meta, "# Sharpness stack summary")

    full = stats.get("full", {})
    series_specs = (
        ("gradient", "tenengrad", "Tenengrad", 1),
        ("laplacian", "laplacian_variance", "Laplacian variance", 1),
        ("spectral", "spectral_entropy", "Spectral entropy", 6),
        ("autocorrelation", "seq", "Inverse autocorr width (seq)", 4),
        ("eigenvalues", "eigenvalues", "Eigenvalues", 6),
    )
    for group, key, label, nd in series_specs:
        blk = full.get(group)
        if not isinstance(blk, dict):
            continue
        y = np.asarray(blk.get(key, []), dtype=float)
        if y.size == 0:
            continue
        all_nan = bool(np.all(np.isnan(y)))  # degenerate frames: still report
        best = "nan" if all_nan else f"frame {int(np.nanargmax(y))}"
        lines.append(f"## {label}")
        lines.append("```")
        lines.append(
            f"> min={_f(float(np.nanmin(y)) if not all_nan else float('nan'), nd)} | "
            f"max={_f(float(np.nanmax(y)) if not all_nan else float('nan'), nd)} | "
            f"argmax={best} | "
            f"mean={_f(float(np.nanmean(y)) if not all_nan else float('nan'), nd)}"
        )
        lines.append("```")
        lines.append("")

    return "\n".join(lines).rstrip() + "\n"


@register_formatter("speckle_stack_stats")
def _logbook_speckle_stack(stats: dict, *, complete: bool = False, notes: bool = False) -> str:
    meta = stats.get("meta", {})
    lines = _stack_header(meta, "# Speckle stack summary")

    tr = meta.get("tracking", {})
    if tr:
        lines.append("## Tracking")
        lines.append("```")
        lines.append(
            f"> method={tr.get('method')} | backend={tr.get('backend')} | "
            f"subpixel={tr.get('subpixel')} | roi={tr.get('roi_size_yx')} | "
            f"step={tr.get('roi_step_yx')}"
        )
        lines.append("```")
        lines.append("")

    temporal = stats.get("temporal", {})
    for key, label in (("abs", "Absolute displacement"), ("inc", "Incremental displacement")):
        blk = temporal.get(key)
        if not isinstance(blk, dict):
            continue
        r = np.asarray(blk.get("r", []), dtype=float)
        dx = np.asarray(blk.get("dx", []), dtype=float)
        dy = np.asarray(blk.get("dy", []), dtype=float)
        if r.size == 0:
            continue
        lines.append(f"## {label}")
        lines.append("```")
        lines.append(
            f"> r: mean={np.nanmean(r):.3f} px | max={np.nanmax(r):.3f} px | "
            f"dx range=[{np.nanmin(dx):.3f}, {np.nanmax(dx):.3f}] | "
            f"dy range=[{np.nanmin(dy):.3f}, {np.nanmax(dy):.3f}]"
        )
        lines.append("```")
        lines.append("")

    return "\n".join(lines).rstrip() + "\n"


@register_formatter("wavefront_scan")
@register_formatter("wavefront")
@register_formatter("displacement_field")
@register_formatter("displacement_stack")
def _logbook_wavefront(stats: dict, *, complete: bool = False, notes: bool = False) -> str:
    """Logbook block for dense XST results (signal.xst /
    models.WavefrontScanPipeline output dicts — extension kinds)."""
    meta = stats.get("meta", {})
    heading = (
        "# Wavefront scan summary"
        if "wavefront" in stats
        else "# Displacement field summary"
    )
    lines = [
        heading,
        f"{datetime.fromtimestamp(now()).strftime('%Y-%m-%d | %H:%M:%S')}",
        "",
        "## Metadata",
    ]
    grid = meta.get("grid_shape")
    if isinstance(grid, (tuple, list)) and len(grid) == 2:
        lines.append(f"- Tracking grid: {int(grid[0])} x {int(grid[1])} nodes")
    lines.append(
        f"- Tile {meta.get('tile_size')} px | step {meta.get('step')} px | "
        f"search radius {meta.get('search_radius')} px"
    )
    if "pixel_size" in meta:
        lines.append(
            f"- Optics: pixel {meta['pixel_size']:.3e} | "
            f"distance {meta['distance']:.3e}"
            + (
                f" | wavelength {meta['wavelength']:.3e}"
                if meta.get("wavelength")
                else ""
            )
        )
    lines.append("")

    dy = np.asarray(stats.get("dy", []), dtype=float)
    dx = np.asarray(stats.get("dx", []), dtype=float)
    peak = np.asarray(stats.get("peak", []), dtype=float)
    if dy.size:
        mag = np.hypot(dy, dx)
        lines.append("## Displacements")
        lines.append("```")
        lines.append(
            f"> |d|: mean={np.nanmean(mag):.3f} px | max={np.nanmax(mag):.3f} px | "
            f"dy range=[{np.nanmin(dy):.3f}, {np.nanmax(dy):.3f}] | "
            f"dx range=[{np.nanmin(dx):.3f}, {np.nanmax(dx):.3f}]"
        )
        if peak.size:
            lines.append(
                f"> NCC peak: median={np.nanmedian(peak):.3f} | "
                f"min={np.nanmin(peak):.3f} "
                f"(fraction >0.5: {float(np.mean(peak > 0.5)):.2f})"
            )
        lines.append("```")
        lines.append("")

    wf = stats.get("wavefront")
    if wf is not None:
        wf = np.asarray(wf, dtype=float)
        lines.append("## Wavefront")
        lines.append("```")
        lines.append(
            f"> height PV={np.nanmax(wf) - np.nanmin(wf):.3e} | "
            f"rms={np.nanstd(wf):.3e} (piston removed)"
        )
        if "phase" in stats:
            ph = np.asarray(stats["phase"], dtype=float)
            lines.append(
                f"> phase PV={np.nanmax(ph) - np.nanmin(ph):.3f} rad | "
                f"rms={np.nanstd(ph):.3f} rad"
            )
        lines.append("```")
        lines.append("")
    if notes:
        lines.append(
            "- Notes: displacements are sample-relative-to-reference [px]; "
            "wavefront height integrates the slope field (Frankot-Chellappa, "
            "piston removed)."
        )
        lines.append("")

    return "\n".join(lines).rstrip() + "\n"
