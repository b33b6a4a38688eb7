# SPDX-License-Identifier: CECILL-2.1
"""Sharpness metrics (counterpart of ``barc4dip_tpu/metrics/sharpness.py``):
the single-image aggregator ``sharpness_stats``, the stack aggregator
``sharpness_stack_stats`` and the five standalone estimators.

Focus-measure operators after Pertuz et al., Pattern Recognition 46(5) 2013
(operator codes GRA6, LAP4, STA2). Same groups (stats, gradient, laplacian,
spectral, autocorrelation, eigenvalues), the same ``meta`` / ``full`` /
``tiles`` dicts and the same tiling policy as the JAX package.

Inputs are numpy arrays, which compute on ``device`` (``None``: the card,
and an error without one), or tensors, which compute on their own device. The tiles of each
shape run as one batch per estimator. The ``autocorrelation`` group's
standardized autocorrelation goes through ``ops.corrcore``, so through
kernel K1a on a card for the shapes it covers.
"""
from __future__ import annotations

import logging
from typing import Literal, Sequence

import numpy as np
import torch

from ..config import MIN_TILE_PX, device_array, to_compute
from ..utils.checkpoint import ChunkStore
from ..utils.profiling import annotate
from ..utils.time import elapsed_time, now, progress_done, progress_update
from .common import (
    apply_display_origin,
    choose_tiling_mode,
    chunk_layout_signature,
    normalize_display_origin,
    normalize_groups,
    pack_leaves,
    run_stack_program,
    subtile_grids_to_3x3_device,
    tiled_scalar_fields_device,
    tiles_meta,
    unflatten_leaves,
    unpack_leaves,
)
from .estimators import (
    distribution_moments_core,
    eigenvalues_core,
    inverse_autocorr_width_core,
    laplacian_variance_core,
    spectral_entropy_core,
    tenengrad_core,
)
from .speckles import _unflatten_tiles

logger = logging.getLogger(__name__)

__all__ = [
    "eigenvalues",
    "inverse_autocorr_width",
    "laplacian_variance",
    "sharpness_stack_stats",
    "sharpness_stats",
    "spectral_entropy",
    "tenengrad",
]

_SHARPNESS_UNITS: dict[str, dict[str, str]] = {
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
    "gradient": {"tenengrad": "a.u.^2", "ex": "a.u.^2", "ey": "a.u.^2", "re": ""},
    "laplacian": {"laplacian_variance": "a.u.^2"},
    "spectral": {"spectral_entropy": ""},
    "autocorrelation": {"sx": "1/px", "sy": "1/px", "seq": "1/px", "r": ""},
    "eigenvalues": {"eigenvalues": "", "e1": "", "e2": "", "re": ""},
}

_ALL_SHARPNESS_GROUPS: set[str] = {
    "stats",
    "gradient",
    "laplacian",
    "spectral",
    "autocorrelation",
    "eigenvalues",
}

_GROUP_ORDER = ("stats", "gradient", "laplacian", "spectral", "autocorrelation", "eigenvalues")

_IAW_MIN_PX = 32


def _sharpness_device_fn(groups: frozenset, mode: str, sat: float | None, eps: float):
    """The metric step for one static configuration: ``fn(imgs)`` maps
    (..., H, W) frames to {"full": {group: {field: (...)}}, "tiles":
    {"group/field": {"mean", ["std"]}: (..., 3, 3)}}."""

    cores = {
        "stats": lambda x: distribution_moments_core(x, saturation_value=sat, eps=eps),
        "gradient": tenengrad_core,
        "laplacian": laplacian_variance_core,
        "spectral": spectral_entropy_core,
        "autocorrelation": inverse_autocorr_width_core,
        "eigenvalues": eigenvalues_core,
    }
    chosen = [(g, f"group.{g}", cores[g]) for g in _GROUP_ORDER if g in groups]

    def group_values(x) -> dict:
        vals: dict = {}
        for g, span, core in chosen:
            with annotate(span):
                vals[g] = core(x)
        return vals

    def tile_fn(tiles):
        return {f"{g}/{k}": v for g, d in group_values(tiles).items() for k, v in d.items()}

    def fn(imgs):
        out: dict = {"full": group_values(imgs)}
        if mode == "subtiles_9x9":
            grids = tiled_scalar_fields_device(imgs, n=9, compute_fn=tile_fn)
            out["tiles"] = subtile_grids_to_3x3_device(grids)
        elif mode == "tiles_3x3":
            grids = tiled_scalar_fields_device(imgs, n=3, compute_fn=tile_fn)
            out["tiles"] = {k: {"mean": v} for k, v in grids.items()}
        return out

    return fn


def _assemble_stack_output(raw: dict, mode: str) -> tuple[dict, dict | None]:
    """Stacked raw results -> the reference (full, tiles) schema; direct
    3x3 tiles carry an all-NaN std."""
    out_full = {g: dict(raw["full"][g]) for g in _GROUP_ORDER if g in raw["full"]}
    if mode == "off" or "tiles" not in raw:
        return out_full, None
    T = next(iter(out_full[next(iter(out_full))].values())).shape[0]
    out_tiles: dict = {}
    for key, v in raw["tiles"].items():
        g, f = key.split("/", 1)
        std = v["std"] if mode == "subtiles_9x9" else np.full((T, 3, 3), np.nan)
        out_tiles.setdefault(g, {})[f] = {"mean": v["mean"], "std": std}
    return out_full, out_tiles


# ---------------------------------------------------------------------------
# standalone estimators
# ---------------------------------------------------------------------------

def _as_data(image):
    """A tensor in its compute dtype, anything else as a numpy array."""
    return to_compute(image) if isinstance(image, torch.Tensor) else np.asarray(image)


def _numel(data) -> int:
    return int(data.numel()) if isinstance(data, torch.Tensor) else int(data.size)


def _isfinite(data):
    return torch.isfinite(data) if isinstance(data, torch.Tensor) else np.isfinite(data)


def _check_2d_finite_any(data, name: str):
    if data.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={data.ndim}")
    if _numel(data) == 0:
        raise ValueError(f"{name} received an empty image.")
    if not bool(_isfinite(data).any()):
        raise ValueError(f"{name} received image with no finite values.")


def tenengrad(image, *, eps: float = 1e-12, verbose: bool = False, device=None) -> dict:
    """(GRA6) Sobel gradient energy: tenengrad, ex, ey, re = ex/(ey+eps)."""
    data = _as_data(image)
    _check_2d_finite_any(data, "tenengrad")
    out = tenengrad_core(device_array(data, device), eps=eps)
    res = {k: float(v) for k, v in out.items()}
    if verbose:
        logger.info(
            "> tenengrad: %.6g | ex: %.6g | ey: %.6g | ex/ey: %.3f",
            res["tenengrad"], res["ex"], res["ey"], res["re"],
        )
    return res


def laplacian_variance(image, *, verbose: bool = False, device=None) -> float:
    """(LAP4) Population variance of the Laplacian."""
    data = _as_data(image)
    _check_2d_finite_any(data, "laplacian_variance")
    var = float(laplacian_variance_core(device_array(data, device))["laplacian_variance"])
    if verbose:
        logger.info("> laplacian variance: %.6g", var)
    return var


def spectral_entropy(
    image,
    *,
    remove_mean: bool = True,
    remove_dc: bool = True,
    eps: float = 1e-30,
    verbose: bool = False,
    device=None,
) -> float:
    """Normalized Shannon entropy of the PSD (in [0, 1])."""
    data = _as_data(image)
    if data.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={data.ndim}")
    if _numel(data) == 0:
        raise ValueError("spectral_entropy received an empty image.")
    if not bool(_isfinite(data).all()):
        raise ValueError("spectral_entropy requires all values to be finite.")
    if _numel(data) < 3:
        raise ValueError("Insufficient number of spectral bins to compute normalized entropy.")
    out = spectral_entropy_core(
        device_array(data, device), remove_mean=remove_mean, remove_dc=remove_dc, eps=eps
    )
    Hn = float(out["spectral_entropy"])
    if not np.isfinite(Hn):
        raise ValueError("PSD sum is non-positive; cannot compute spectral entropy.")
    if verbose:
        logger.info("> spectral_entropy: %.6g", Hn)
    return Hn


def inverse_autocorr_width(
    image,
    *,
    fraction: float = 1.0 / np.e,
    radial_method: Literal["binned", "interpolated"] = "interpolated",
    min_size_px: int = _IAW_MIN_PX,
    verbose: bool = False,
    device=None,
) -> dict:
    """Sharpness from the inverse width of the standardized autocorrelation
    peak: sx, sy, seq (1/px) and width-domain anisotropy r."""
    data = _as_data(image)
    if data.ndim != 2:
        raise ValueError("image must be a 2D array.")
    if _numel(data) == 0:
        raise ValueError("inverse_autocorr_width received an empty image.")
    if min(data.shape) < int(min_size_px):
        raise ValueError(
            f"image too small for inverse autocorrelation width "
            f"(min dimension < {int(min_size_px)})."
        )
    if radial_method not in ("binned", "interpolated"):
        raise ValueError("radial_method must be 'binned' or 'interpolated'.")
    out = inverse_autocorr_width_core(
        device_array(data, device), fraction=float(fraction), radial_method=str(radial_method)
    )
    res = {k: float(v) for k, v in out.items()}
    if verbose:
        _log_full({"autocorrelation": res})
    return res


def eigenvalues(
    image, *, k: int = 5, eps: float = 1e-30, eig_method: str = "auto",
    verbose: bool = False, device=None,
) -> dict:
    """(STA2) Sum of the top-k covariance eigenvalues (plus e1, e2, e1/e2).

    ``eig_method``: "auto" (default; subspace iteration from 1024 px,
    dense below), "dense" (always the exact whole spectrum: kernel K4 on a
    CUDA float32 image up to 238 px, ``torch.linalg.eigvalsh`` otherwise) or
    "subspace"; see
    :func:`..ops.eig.topk_eigvalsh_subspace` for the accuracy trade-off on
    flat (noise-only) spectra."""
    data = _as_data(image)
    if data.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={data.ndim}")
    if _numel(data) == 0:
        raise ValueError("eigenvalues received an empty image.")
    if not bool(_isfinite(data).all()):
        raise ValueError("eigenvalues requires all values to be finite.")
    if int(k) < 1:
        raise ValueError("k must be >= 1.")
    if _numel(data) < 2:
        raise ValueError("eigenvalues requires at least 2 pixels (M*N >= 2).")
    if not bool((data != 0).any()):
        raise ValueError("eigenvalues cannot normalize an all-zero image.")
    out = eigenvalues_core(
        device_array(data, device), k=int(k), eps=float(eps), eig_method=str(eig_method)
    )
    res = {key: float(v) for key, v in out.items()}
    if verbose:
        logger.info(
            "> eigenvalues: %.6g | e1: %.6g | e2: %.6g | e1/e2: %.3f | k=%d",
            res["eigenvalues"], res["e1"], res["e2"], res["re"],
            min(int(k), min(data.shape)),
        )
    return res


# ---------------------------------------------------------------------------
# aggregators
# ---------------------------------------------------------------------------

def _check_iaw_size(groups: set, h: int, w: int) -> None:
    if "autocorrelation" in groups and min(h, w) < _IAW_MIN_PX:
        raise ValueError(
            f"image too small for inverse autocorrelation width "
            f"(min dimension < {_IAW_MIN_PX})."
        )


@annotate("entry.sharpness_stats")
def sharpness_stats(
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
    """Sharpness metrics of one 2D image (numpy array or tensor), in the
    reference dict schema: ``{"meta": {...}, "full": {group: {...}},
    "tiles": {group: {field: {"mean": (3,3), "std": (3,3)}}}}``.

    ``display_origin`` is normalised (case and blanks ignored, other values
    raise). A numpy input with no finite value raises before the device
    runs; a tensor input is not checked, as the JAX package does not check
    device arrays."""
    t0 = now()
    is_device = isinstance(image, torch.Tensor)
    if not isinstance(image, np.ndarray) and not is_device:
        raise TypeError("sharpness_stats expects a numpy.ndarray")
    if image.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={image.ndim}")

    flip = normalize_display_origin(display_origin) == "lower"
    h, w = (int(v) for v in image.shape)
    groups = normalize_groups(
        metrics, all_groups=_ALL_SHARPNESS_GROUPS, context="sharpness", param_name="metrics"
    )
    _check_iaw_size(groups, h, w)
    if not is_device and ("stats" in groups or "gradient" in groups or "laplacian" in groups):
        with annotate("entry.validate"):
            if not np.any(np.isfinite(image)):
                raise ValueError("received image with no finite values.")

    if verbose:
        logger.info("\nsharpness stats for a (h x w: %.0f x %.0f) image:", h, w)
    mode, tile_shape_px = choose_tiling_mode(h, w, tiles=tiles, min_tile_px=MIN_TILE_PX)

    img = device_array(image, device)
    metric_fn = _sharpness_device_fn(
        frozenset(groups), mode, None if saturation_value is None else float(saturation_value),
        float(eps),
    )
    with annotate("step.metrics"):
        shown = apply_display_origin(img, display_origin="lower") if flip else img
        result = metric_fn(shown[None])
    flat, spec = pack_leaves(result, 1, img.dtype)
    with annotate("pull.wait"):
        host = flat.cpu().numpy()
    with annotate("entry.assemble"):
        raw = unflatten_leaves({p: v[0] for p, v in unpack_leaves(host, spec).items()})

        out: dict = {
            "meta": {
                "kind": "sharpness",
                "display_origin": display_origin,
                "input_shape": (h, w),
                "requested_groups": sorted(groups),
                "units": _SHARPNESS_UNITS,
            },
            "full": {
                g: {k: float(v) for k, v in raw["full"][g].items()}
                for g in _GROUP_ORDER if g in groups
            },
        }
        if verbose:
            _log_full(out["full"])
        if mode != "off":
            out["meta"].update(tiles_meta(h, w, tile_mode=mode, tile_shape_px=tile_shape_px))
            out["tiles"] = _unflatten_tiles(raw["tiles"], has_std=(mode == "subtiles_9x9"))
        if verbose:
            elapsed_time(t0)
        return out


def _log_full(full: dict) -> None:
    if "stats" in full:
        m = full["stats"]
        logger.info(
            "> moments: mean=%.0f | std=%.0f | var=%.0f | skew=%.2f | kurt=%.2f | SNR=%.2f dB | zero=%.6f | sat=%.6f",
            m["mean"], m["std"], m["variance"], m["skewness"], m["kurtosis"],
            m["SNRdB"], m["frac_zero"], m["frac_sat"],
        )
    if "gradient" in full:
        g = full["gradient"]
        logger.info(
            "> tenengrad: %.6g | ex: %.6g | ey: %.6g | ex/ey: %.3f",
            g["tenengrad"], g["ex"], g["ey"], g["re"],
        )
    if "laplacian" in full:
        logger.info("> laplacian variance: %.6g", full["laplacian"]["laplacian_variance"])
    if "spectral" in full:
        logger.info("> spectral_entropy: %.6g", full["spectral"]["spectral_entropy"])
    if "autocorrelation" in full:
        a = full["autocorrelation"]
        logger.info(
            "> inv_ac_width: sx=%.4g | sy=%.4g | sx/sy=%.3g | seq=%.4g | r(lx/ly)=%.3g",
            a["sx"], a["sy"],
            (a["sx"] / a["sy"]) if np.isfinite(a["sy"]) and a["sy"] != 0 else float("inf"),
            a["seq"], a["r"],
        )
    if "eigenvalues" in full:
        e = full["eigenvalues"]
        logger.info(
            "> eigenvalues: %.6g | e1: %.6g | e2: %.6g | e1/e2: %.3f",
            e["eigenvalues"], e["e1"], e["e2"], e["re"],
        )


@annotate("entry.sharpness_stack_stats")
def sharpness_stack_stats(
    stack,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
    parallel: bool = True,
    n_jobs: int | None = None,
    frame_chunk: int = 8,
    mesh=None,
    checkpoint_dir=None,
    device=None,
) -> dict:
    """Per-frame sharpness metrics of a (T, H, W) numpy array or tensor,
    stacked along a leading time axis.

    Frames run in chunks of ``frame_chunk`` on ``device`` (``None``: the
    card, and an error without one); a tensor stack runs on its own device
    without uploads.
    ``parallel``/``n_jobs`` are accepted for API parity and echoed in
    ``meta``. ``checkpoint_dir`` persists each chunk and resumes a rerun of
    the same call from the chunks on disk. ``mesh``
    (:func:`..parallel.frame_mesh`) spreads each chunk's frames over the
    mesh's devices in contiguous shards (``run_stack_program``); the results
    equal the unsharded run's.

    ``display_origin`` follows the JAX package's stack rule: rows flip if
    and only if the argument equals ``"lower"`` exactly. It is not
    normalised here: ``"LOWER"``, ``" lower"`` or an invalid value run
    unflipped and raise nothing, and ``meta`` and the checkpoint
    configuration echo the argument as given. The single-image
    ``sharpness_stats`` normalises it."""
    t0 = now()
    if not isinstance(stack, (np.ndarray, torch.Tensor)):
        raise TypeError("sharpness_stack_stats expects a numpy.ndarray or a torch.Tensor")
    if stack.ndim != 3:
        raise ValueError(
            f"stack must be a 3D array with shape (T, H, W); got ndim={stack.ndim}"
        )
    T, H, W = (int(s) for s in stack.shape)
    if T < 1:
        raise ValueError("stack must contain at least one frame.")

    groups = normalize_groups(
        metrics, all_groups=_ALL_SHARPNESS_GROUPS, context="sharpness", param_name="metrics"
    )
    serial_mode = (not parallel) or (n_jobs is not None and int(n_jobs) <= 1)
    tile_mode, tile_shape_px = choose_tiling_mode(H, W, tiles=tiles, min_tile_px=MIN_TILE_PX)
    _check_iaw_size(groups, H, W)

    program = _sharpness_device_fn(
        frozenset(groups), tile_mode,
        None if saturation_value is None else float(saturation_value), float(eps),
    )
    ckpt = None
    if checkpoint_dir is not None:
        config = {
            "kind": "sharpness_stack", "shape": (T, H, W), "groups": sorted(groups),
            "mode": tile_mode, "sat": saturation_value, "eps": eps,
            "origin": display_origin, "chunk": frame_chunk,
            "schedule": chunk_layout_signature(T, frame_chunk, mesh),
        }
        ckpt = ChunkStore(checkpoint_dir, "torch_sharpness_metrics", config)

    if verbose:
        progress_update("Sharpness stats loop", 0, T, -1)
    raw = run_stack_program(
        stack, program, frame_chunk=frame_chunk, flip=(display_origin == "lower"),
        mesh=mesh, checkpoint=ckpt, device=device,
    )
    with annotate("entry.assemble"):
        out_full, out_tiles = _assemble_stack_output(raw, tile_mode)
        if verbose:
            progress_done("Sharpness stats loop")

        meta: dict = {
            "kind": "sharpness_stack_stats",
            "input_shape": (H, W),
            "stack_shape": (T, H, W),
            "n_frames": T,
            "display_origin": display_origin,
            "requested_groups": sorted(groups),
            "units": _SHARPNESS_UNITS,
            "parallel": {
                "enabled": bool(not serial_mode),
                "n_jobs": None if serial_mode else n_jobs,
                "device_batched": True,
            },
        }
        meta.update(tiles_meta(H, W, tile_mode=tile_mode, tile_shape_px=tile_shape_px))

        out: dict = {"meta": meta, "full": out_full}
        if out_tiles is not None:
            out["tiles"] = out_tiles
        if verbose:
            logger.info(
                "> sharpness_stack_stats | frames=%d | parallel=%s | n_jobs=%s | elapsed=%s s",
                T,
                "yes" if not serial_mode else "no",
                "1" if serial_mode else str(n_jobs),
                int(elapsed_time(t0, verbose=False)),
            )
        return out
