# SPDX-License-Identifier: CECILL-2.1
"""Speckle metrics (counterpart of ``barc4dip_tpu/metrics/speckles.py``):
the single-image aggregator ``speckle_stats`` and its standalone
estimators, and ``speckle_stack_stats``, per-frame metrics stacked over time
plus abs/inc translation tracking of a central 3x3 ROI grid, with the same
``meta`` / ``full`` / ``tiles`` / ``temporal`` dicts.

Inputs are numpy arrays, which compute on ``device`` (``None``: the card,
and an error without one), or tensors, which compute on their own device. Autocorrelation
maps are lazy leaves: a map is computed on that device from the caller's
own frame, with the display-origin flip, only when it is read.
"""
from __future__ import annotations

import logging
import time
from typing import Literal, Sequence

import numpy as np
import torch

from ..config import MIN_TILE_PX, device_array, to_compute
from ..geometry.masks import square_embed_slices
from ..geometry.roi import odd_size, roi_grid_3x3
from ..ops import cuda_fftp
from ..signal.common import lag_axis_from_step
from ..utils.checkpoint import ChunkStore
from ..utils.lazy import LazyMap, LazyMapStack
from ..utils.profiling import annotate
from . import stack_fused
from .common import (
    apply_display_origin,
    choose_tiling_mode,
    chunk_layout_signature,
    frame_loader,
    nan_std_grid_3x3,
    normalize_display_origin,
    normalize_groups,
    pack_mean_std,
    tiles_meta,
    unflatten_leaves,
    unpack_leaves,
)
from .estimators import amplitude_core, bandwidth_core, grain_core, grain_map_core
from .speckles_device import int_value_hint, metric_step, speckle_device_fn
from .stack_fused import run_fused_speckle_stack

logger = logging.getLogger(__name__)

__all__ = [
    "amplitude",
    "bandwidth",
    "grain",
    "speckle_stack_stats",
    "speckle_stats",
    "tracking_grid_from_frame0",
]

_SPECKLE_UNITS: dict[str, dict[str, str]] = {
    "amplitude": {"visibility": "", "contrast": ""},
    "stats": {
        "mean": "a.u.",
        "std": "a.u.",
        "variance": "a.u.^2",
        "skewness": "",
        "kurtosis": "",
        "frac_zero": "",
        "frac_sat": "",
        "SNRdB": "dB",
    },
    "grain": {
        "lx": "px",
        "ly": "px",
        "leq": "px",
        "r": "",
        "xlag": "px",
        "ylag": "px",
        "autocorr": "",
    },
    "bandwidth": {
        "spr": "",
        "feq": "1/px",
        "f95": "1/px",
        "sig_fx": "1/px",
        "sig_fy": "1/px",
        "rf": "",
    },
    "temporal": {
        "dx": "px",
        "dy": "px",
        "r": "px",
        "std_dx": "px",
        "std_dy": "px",
        "std_r": "px",
    },
}

_ALL_SPECKLE_GROUPS: set[str] = {"amplitude", "grain", "bandwidth", "stats"}

_GRAIN_MIN_PX = 128


def _image_2d(image):
    img = image if isinstance(image, torch.Tensor) else np.asarray(image)
    if img.ndim != 2:
        raise ValueError("image must be a 2D array.")
    return img


def _nanmean64(img) -> float:
    if isinstance(img, torch.Tensor):
        return float(torch.nanmean(to_compute(img).double()))
    return float(np.nanmean(img.astype(np.float64, copy=False)))


# ---------------------------------------------------------------------------
# standalone estimators
# ---------------------------------------------------------------------------

def amplitude(image, verbose: bool = False, device=None) -> dict:
    """Visibility (std/mean) and robust Michelson contrast."""
    img = _image_2d(image)
    mu = _nanmean64(img)
    if not np.isfinite(mu) or mu <= 0.0:
        raise ValueError("Mean intensity must be positive and finite.")
    out = amplitude_core(device_array(img, device))
    res = {"visibility": float(out["visibility"]), "contrast": float(out["contrast"])}
    if not np.isfinite(res["contrast"]):
        raise ValueError("Invalid percentile range for Michelson contrast.")
    if verbose:
        logger.info("> visibility: %.2f | contrast: %.2f", res["visibility"], res["contrast"])
    return res


def grain(
    image,
    *,
    fraction: float = 1.0 / np.e,
    radial_method: Literal["binned", "interpolated"] = "interpolated",
    verbose: bool = False,
    device=None,
) -> dict:
    """Speckle grain metrics from the autocorrelation peak (lx, ly, leq, r,
    plus the peak-normalized autocorr map and lag axes)."""
    data = _image_2d(image)
    if min(data.shape) < _GRAIN_MIN_PX:
        raise ValueError("image too small for speckle grain metrics (min dimension < 128).")
    if radial_method not in ("binned", "interpolated"):
        raise ValueError("radial_method must be 'binned' or 'interpolated'.")
    out = grain_core(
        device_array(data, device), fraction=float(fraction), radial_method=str(radial_method)
    )
    metrics = {k: float(out[k]) for k in ("lx", "ly", "leq", "r")}
    metrics.update(
        {k: out[k].cpu().numpy().astype(float) for k in ("autocorr", "xlag", "ylag")}
    )
    if verbose:
        logger.info(
            "> grain: lx=%.2f | ly=%.2f | lx/ly=%.2f | leq=%.2f ",
            metrics["lx"], metrics["ly"], metrics["r"], metrics["leq"],
        )
    return metrics


def bandwidth(image, verbose: bool = False, device=None) -> dict[str, float]:
    """Spatial-frequency bandwidth metrics from the 2D PSD (see
    estimators.bandwidth_core)."""
    img = _image_2d(image)
    spectral = {k: float(v) for k, v in bandwidth_core(device_array(img, device)).items()}
    if not np.isfinite(spectral["feq"]):
        raise ValueError("PSD energy is not positive/finite after mean/DC removal.")
    if verbose:
        logger.info(
            "> bandwidth: fx=%.4f | fy=%.4f | fx/fy=%.2f | feq=%.4f | f95=%.4f | spr=%.0f",
            spectral["sig_fx"], spectral["sig_fy"], spectral["rf"],
            spectral["feq"], spectral["f95"], spectral["spr"],
        )
    return spectral


# ---------------------------------------------------------------------------
# single-image aggregator
# ---------------------------------------------------------------------------

def _grain_map(img, flip: bool):
    """The autocorrelation map of a compute-dtype frame as displayed."""
    return grain_map_core(apply_display_origin(img, display_origin="lower") if flip else img)


def _unflatten_tiles(flat: dict, *, has_std: bool) -> dict:
    """{"group/field": {"mean", ["std"]}} -> nested reference schema."""
    tiles: dict = {}
    for key, v in flat.items():
        g, f = key.split("/", 1)
        std = v["std"] if has_std else nan_std_grid_3x3()
        tiles.setdefault(g, {})[f] = pack_mean_std(v["mean"], std)
    return tiles


@annotate("entry.speckle_stats")
def speckle_stats(
    image,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
    device=None,
) -> dict:
    """Speckle metrics of one 2D image (numpy array or tensor).

    Returns the reference dict schema:
    ``{"meta": {...}, "full": {group: {...}}, "tiles": {group: {field:
    {"mean": (3,3), "std": (3,3)}}}}``. ``full.grain.autocorr`` is a lazy
    (N, N) float64 map. A numpy input is validated before the device runs;
    a tensor input after, on the results, as the JAX package does for
    device arrays."""
    t0 = time.perf_counter()
    is_device = isinstance(image, torch.Tensor)
    if not isinstance(image, np.ndarray) and not is_device:
        raise TypeError("speckle_stats expects a numpy.ndarray or a torch.Tensor")
    if image.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={image.ndim}")

    flip = normalize_display_origin(display_origin) == "lower"
    h, w = (int(v) for v in image.shape)
    groups = normalize_groups(
        metrics, all_groups=_ALL_SPECKLE_GROUPS, context="speckles", param_name="metrics"
    )
    if "grain" in groups and min(h, w) < _GRAIN_MIN_PX:
        raise ValueError("image too small for speckle grain metrics (min dimension < 128).")
    if not is_device:
        with annotate("entry.validate"):
            if "amplitude" in groups:
                mu = _nanmean64(image)
                if not np.isfinite(mu) or mu <= 0.0:
                    raise ValueError("Mean intensity must be positive and finite.")
            if "stats" in groups and (image.size == 0 or not np.any(np.isfinite(image))):
                raise ValueError("distribution_moments received no finite values.")

    if verbose:
        logger.info("\nspeckle stats for a (h x w: %.0f x %.0f) image:", h, w)
    mode, tile_shape_px = choose_tiling_mode(h, w, tiles=tiles, min_tile_px=MIN_TILE_PX)

    img = device_array(image, device)
    metric_fn = speckle_device_fn(
        frozenset(groups), mode, None if saturation_value is None else float(saturation_value),
        float(eps),
    )
    with annotate("step.metrics"):
        flat, spec = metric_step(metric_fn, img[None], flip=flip, int_range=int_value_hint(image.dtype))
    with annotate("pull.wait"):
        host = flat.cpu().numpy()
    with annotate("entry.assemble"):
        raw = unflatten_leaves({p: v[0] for p, v in unpack_leaves(host, spec).items()})
        full = raw["full"]
        if is_device:
            if "amplitude" in groups and not np.isfinite(full["amplitude"]["visibility"]):
                raise ValueError("Mean intensity must be positive and finite.")
            if "stats" in groups and not np.isfinite(full["stats"]["mean"]):
                raise ValueError("distribution_moments received no finite values.")

        out: dict = {
            "meta": {
                "kind": "speckles",
                "display_origin": display_origin,
                "input_shape": (h, w),
                "requested_groups": sorted(groups),
                "units": _SPECKLE_UNITS,
            },
            "full": {},
        }
        if "amplitude" in groups:
            out["full"]["amplitude"] = {k: float(v) for k, v in full["amplitude"].items()}
        if "grain" in groups:
            _, _, N = square_embed_slices((h, w))
            dev = img.device

            def fetch_map(image=image):
                x = device_array(image, dev)
                return _grain_map(x, flip).cpu().numpy().astype(np.float64)

            lag = lag_axis_from_step(N, 1.0)
            out["full"]["grain"] = {
                **{k: float(full["grain"][k]) for k in ("lx", "ly", "leq", "r")},
                "autocorr": LazyMap((N, N), np.float64, fetch_map),
                "xlag": lag,
                "ylag": lag.copy(),
            }
        if "stats" in groups:
            out["full"]["stats"] = {k: float(v) for k, v in full["stats"].items()}
        if "bandwidth" in groups:
            out["full"]["bandwidth"] = {k: float(v) for k, v in full["bandwidth"].items()}
        if verbose:
            _log_full(out["full"])

        if mode != "off":
            out["meta"].update(tiles_meta(h, w, tile_mode=mode, tile_shape_px=tile_shape_px))
            out["tiles"] = _unflatten_tiles(raw["tiles"], has_std=(mode == "subtiles_9x9"))
        if verbose:
            logger.info("> speckle_stats | elapsed=%.2f s", time.perf_counter() - t0)
        return out


def _log_full(full: dict) -> None:
    if "amplitude" in full:
        a = full["amplitude"]
        logger.info("> visibility: %.2f | contrast: %.2f", a["visibility"], a["contrast"])
    if "grain" in full:
        g = full["grain"]
        logger.info(
            "> grain: lx=%.2f | ly=%.2f | lx/ly=%.2f | leq=%.2f ",
            g["lx"], g["ly"], g["r"], g["leq"],
        )
    if "stats" in full:
        m = full["stats"]
        logger.info(
            "> moments: mean=%.0f | std=%.0f | var=%.0f | skew=%.2f | kurt=%.2f | SNR=%.2f dB | zero=%.6f | sat=%.6f",
            m["mean"], m["std"], m["variance"], m["skewness"], m["kurtosis"],
            m["SNRdB"], m["frac_zero"], m["frac_sat"],
        )
    if "bandwidth" in full:
        b = full["bandwidth"]
        logger.info(
            "> bandwidth: fx=%.4f | fy=%.4f | fx/fy=%.2f | feq=%.4f | f95=%.4f | spr=%.0f",
            b["sig_fx"], b["sig_fy"], b["rf"], b["feq"], b["f95"], b["spr"],
        )


# ---------------------------------------------------------------------------
# stack aggregator
# ---------------------------------------------------------------------------

@annotate("entry.frame0")
def tracking_grid_from_frame0(
    stack, *, roi_grain_factor: float = 3.0, roi_step_factor: float = 0.5
):
    """3x3 tracking-ROI geometry sized from frame-0 grain:
    (grid_slices, grid_labels, roi_side, step, grain0).

    Frame 0 is sized on the CPU, in float32 unless the stack is float64,
    as the JAX package does, so ``roi_side`` comes out identical."""
    T, H, W = (int(s) for s in stack.shape)
    if isinstance(stack, torch.Tensor):
        frame0 = to_compute(stack[0]).cpu()
    else:
        frame0 = torch.from_numpy(
            np.asarray(stack[0], np.float64 if stack.dtype == np.float64 else np.float32)
        )
    g0 = grain_core(frame0, with_map=False)
    grain0 = {k: float(g0[k]) for k in ("lx", "ly", "leq", "r")}

    l = float(np.nanmax([grain0["lx"], grain0["ly"], grain0["leq"]]))
    if not np.isfinite(l) or l <= 0:
        raise ValueError("Could not infer a valid grain size from frame 0 (lx/ly/leq).")
    roi_side = odd_size(int(np.ceil(roi_grain_factor * l)))
    step = int(max(1, round(roi_step_factor * roi_side)))
    grid_slices, grid_labels = roi_grid_3x3(
        (H, W), (roi_side, roi_side), (step, step), center_yx=None
    )
    return grid_slices, grid_labels, roi_side, step, grain0


def _assemble_stack_output(raw: dict, mode: str) -> tuple[dict, dict | None]:
    """Stacked raw results -> the reference (full, tiles) schema."""
    out_full = {g: dict(raw["full"][g]) for g in ("amplitude", "grain", "stats", "bandwidth")
                if g in raw["full"]}
    if mode == "off" or "tiles" not in raw:
        return out_full, None
    out_tiles: dict = {}
    for key, v in raw["tiles"].items():
        g, f = key.split("/", 1)
        mean = v["mean"]
        std = v["std"] if mode == "subtiles_9x9" else np.full(mean.shape, np.nan)
        out_tiles.setdefault(g, {})[f] = {"mean": mean, "std": std}
    return out_full, out_tiles


def _attach_lazy_grain_maps(grain_out: dict, load, T: int, N: int, dtype, *, flip: bool) -> None:
    """Per-frame autocorr maps and lag axes of a stack's grain block: frame
    t's map is computed on the device from frame t of the caller's stack
    (``load``, see ``common.frame_loader``) the first time it is
    read."""

    def fetch(t: int) -> np.ndarray:
        return _grain_map(load(int(t), int(t) + 1)[0], flip).cpu().numpy()

    lag = lag_axis_from_step(N, 1.0).astype(dtype)
    grain_out["autocorr"] = LazyMapStack(T, (N, N), dtype, fetch)
    grain_out["xlag"] = np.broadcast_to(lag, (T, N)).copy()
    grain_out["ylag"] = np.broadcast_to(lag, (T, N)).copy()


@annotate("entry.speckle_stack_stats")
def speckle_stack_stats(
    stack,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    roi_grain_factor: float = 3.0,
    roi_step_factor: float = 0.5,
    tracking_method: str = "template",
    tracking_backend: Literal["internal", "skimage", "opencv"] = "skimage",
    subpixel: bool = True,
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
    parallel: bool = True,
    n_jobs: int | None = None,
    frame_chunk: int = 4,
    mesh=None,
    checkpoint_dir=None,
    grain_maps: bool = True,
    tracking_search_radius: float | None = None,
    device=None,
) -> dict:
    """Per-frame speckle metrics stacked over time plus abs/inc tracking
    ("template" or "phase") of a central 3x3 ROI grid, for a (T, H, W)
    numpy array or tensor.

    Frames run in chunks of ``frame_chunk`` on ``device`` (``None``: the
    card, and an error without one); a tensor stack runs on its own device
    without uploads.
    ``parallel``/``n_jobs``/``tracking_backend`` are accepted for API
    parity. ``tracking_search_radius`` (px, template only) restricts each
    correlation to a window of that radius around the tile's home; the
    displacements equal the full search's while the drift stays inside it.
    ``checkpoint_dir`` persists each chunk and resumes a rerun of the same
    call from the chunks on disk. ``grain_maps`` attaches the lazy per-frame
    autocorrelation maps.

    ``mesh`` (:func:`..parallel.frame_mesh`) spreads each chunk's frames
    over the mesh's devices in contiguous shards (the chunk rounded up to a
    multiple of ``mesh.size`` frames); the results equal the unsharded
    run's. A lazy grain map is then computed, when read, on the mesh's
    first device (a tensor stack's: on its own device).

    ``display_origin`` follows the JAX package's stack rule: rows flip (tile
    grids and lazy maps) if and only if the argument equals ``"lower"``
    exactly. It is not normalised here: ``"LOWER"``, ``" lower"`` or an
    invalid value run unflipped and raise nothing, and ``meta`` and the
    checkpoint configuration echo the argument as given. The single-image
    ``speckle_stats`` normalises it, as the JAX package's does."""
    t0 = time.perf_counter()
    if not isinstance(stack, (np.ndarray, torch.Tensor)):
        raise TypeError("speckle_stack_stats expects a numpy.ndarray or a torch.Tensor")
    if stack.ndim != 3:
        raise ValueError(
            f"stack must be a 3D array with shape (T, H, W); got ndim={stack.ndim}"
        )
    T, H, W = (int(s) for s in stack.shape)
    if T < 1:
        raise ValueError("stack must contain at least one frame.")

    serial_mode = (not parallel) or (n_jobs is not None and int(n_jobs) <= 1)
    groups = normalize_groups(
        metrics, all_groups=_ALL_SPECKLE_GROUPS, context="speckles", param_name="metrics"
    )
    if "grain" in groups and min(H, W) < _GRAIN_MIN_PX:
        raise ValueError("image too small for speckle grain metrics (min dimension < 128).")
    method_norm = str(tracking_method).strip().lower()
    if method_norm not in ("template", "phase"):
        raise ValueError(f"Unsupported tracking method for stacks: {tracking_method!r}")
    search_px: int | None = None
    if tracking_search_radius is not None:
        if method_norm != "template":
            raise ValueError(
                "tracking_search_radius requires tracking_method='template' "
                "(windowed phase correlation would change its spectral "
                "normalization semantics)."
            )
        if float(tracking_search_radius) < 1:
            raise ValueError("tracking_search_radius must be >= 1 px.")
        search_px = int(np.ceil(float(tracking_search_radius)))
    flip = display_origin == "lower"

    mode, _tile_shape = choose_tiling_mode(H, W, tiles=tiles, min_tile_px=MIN_TILE_PX)
    clusters = cuda_fftp.LAUNCHES["cols_cluster"]
    t_frame0 = time.perf_counter()
    grid_slices, grid_labels, roi_side, step, grain0 = tracking_grid_from_frame0(
        stack, roi_grain_factor=roi_grain_factor, roi_step_factor=roi_step_factor
    )
    frame0_s = time.perf_counter() - t_frame0
    ckpt = None
    if checkpoint_dir is not None:
        config = {
            "kind": "speckle_stack_fused", "shape": (T, H, W), "dtype": str(stack.dtype),
            "groups": sorted(groups), "mode": mode, "sat": saturation_value,
            "eps": eps, "origin": display_origin, "chunk": frame_chunk,
            "roi": roi_side, "step": step, "method": tracking_method,
            "subpixel": bool(subpixel), "grain_maps": bool(grain_maps),
            "search": search_px, "maps": "lazy-v2",
            "schedule": chunk_layout_signature(T, frame_chunk, mesh),
        }
        ckpt = ChunkStore(checkpoint_dir, "torch_speckle_fused", config)

    raw_metrics, track = run_fused_speckle_stack(
        stack,
        grid_slices,
        groups=groups,
        mode=mode,
        sat=None if saturation_value is None else float(saturation_value),
        eps=float(eps),
        flip=flip,
        method=method_norm,
        subpixel=bool(subpixel),
        track_eps=1e-9,
        frame_chunk=frame_chunk,
        search_radius=search_px,
        mesh=mesh,
        checkpoint=ckpt,
        device=device,
    )
    stack_fused.LAST_RUN_PERF.update(
        frame0_s=frame0_s, k1_cluster_launches=cuda_fftp.LAUNCHES["cols_cluster"] - clusters
    )
    with annotate("entry.assemble"):
        out_full, out_tiles = _assemble_stack_output(raw_metrics, mode)
        if "grain" in groups and grain_maps:
            _, load = frame_loader(stack, device, mesh)
            dtype = np.float64 if str(stack.dtype).endswith("float64") else np.float32
            _attach_lazy_grain_maps(
                out_full["grain"], load, T, square_embed_slices((H, W))[2], dtype, flip=flip
            )
        dx_abs_tiles, dy_abs_tiles, dx_inc_tiles, dy_inc_tiles = track

        def _agg(a):
            return (
                np.nanmean(a, axis=(1, 2)).astype(np.float32),
                np.nanstd(a, axis=(1, 2)).astype(np.float32),
            )

        temporal: dict = {"qc": {"roi_grid_shape": (3, 3)}}
        for kind, dx, dy in (("abs", dx_abs_tiles, dy_abs_tiles), ("inc", dx_inc_tiles, dy_inc_tiles)):
            aggs = {name: _agg(a) for name, a in (("dx", dx), ("dy", dy), ("r", np.sqrt(dx**2 + dy**2)))}
            temporal[kind] = {
                **{name: m for name, (m, _s) in aggs.items()},
                **{f"std_{name}": s for name, (_m, s) in aggs.items()},
            }

        meta: dict = {
            "kind": "speckle_stack_stats",
            "input_shape": (H, W),
            "stack_shape": (T, H, W),
            "n_frames": T,
            "display_origin": display_origin,
            "units": _SPECKLE_UNITS,
            "grain0": {k: grain0.get(k) for k in ("lx", "ly", "leq", "r")},
            "tracking": {
                "method": str(tracking_method),
                "backend": str(tracking_backend),
                "subpixel": bool(subpixel),
                "peak_mode": "abs",
                # what ran: a window that does not fit takes the full search
                "search_area": (
                    f"window_r{search_px}px"
                    if search_px is not None and roi_side + 2 * search_px < min(H, W)
                    else "full_frame"
                ),
                "normalization": {"template": "zscore_local", "search": "zscore_global"},
                "roi_grain_factor": float(roi_grain_factor),
                "roi_size_yx": (int(roi_side), int(roi_side)),
                "roi_step_factor": float(roi_step_factor),
                "roi_step_yx": (int(step), int(step)),
                "roi_labels": grid_labels,
                "roi_order": "row-major",
            },
            "parallel": {
                "enabled": bool(not serial_mode),
                "device_batched": True,
                "frame_chunk": int(frame_chunk),
            },
        }
        out: dict = {"meta": meta, "full": out_full, "temporal": temporal}
        if out_tiles is not None:
            out["tiles"] = out_tiles
        if verbose:
            logger.info(
                "> speckle_stack_stats | frames=%d | roi=%dx%d | step=%d | elapsed=%.1f s",
                T, roi_side, roi_side, step, time.perf_counter() - t0,
            )
        return out
