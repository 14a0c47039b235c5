"""Geodesic weight maps for the mask-reconstruction losses: the port's own
copy of the JAX package's data/geodesic.py.

Same semantics as the reference's scikit-fmm-based module (reference:
human_utils/common/utility/geodesic.py:14-55): a fast-marching geodesic
distance inside the person mask from its centroid (or given joints),
exponentially normalized, plus a scaled distance-to-mask background term.

The Eikonal solver is the port's copy of native/fastmarch.cpp
(``csrc/host/fastmarch.cpp``), built at first use by
``ops/_build.py:load_host`` and bound with ctypes. A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)


def fmm_library() -> ctypes.CDLL:
    """The port's fast-marching library, built on first use."""
    from ..ops import _build

    lib = _build.load_host("fastmarch")
    lib.fmm_distance.restype = ctypes.c_int
    lib.fmm_distance.argtypes = [ctypes.c_int, ctypes.c_int, _U8P, _U8P,
                                 ctypes.POINTER(ctypes.c_double)]
    return lib


def fmm_distance(seeds: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """First-order FMM distance from `seeds` restricted to `valid` cells."""
    if seeds.ndim != 2 or seeds.shape != valid.shape:
        raise ValueError(f"fmm_distance: seeds {seeds.shape} and valid "
                         f"{valid.shape} must be one (H, W) shape")
    h, w = seeds.shape
    seeds8 = np.ascontiguousarray(seeds, dtype=np.uint8)
    valid8 = np.ascontiguousarray(valid, dtype=np.uint8)
    out = np.zeros((h, w), dtype=np.float64)
    rc = fmm_library().fmm_distance(
        h, w, seeds8.ctypes.data_as(_U8P), valid8.ctypes.data_as(_U8P),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"fmm_distance({h}, {w}) returned {rc}")
    return out


def compute_centroid(mask: np.ndarray) -> np.ndarray:
    """(x, y) int centroid of a (1, H, W) mask.
    Reference: geodesic.py:4-12."""
    _, h, w = mask.shape
    grid = np.mgrid[0:h, 0:w]
    total = np.sum(mask)
    return np.array(
        [np.sum(grid[1] * mask) / total, np.sum(grid[0] * mask) / total]
    ).astype(np.int16)


def compute_geodesic_dis(
    img: np.ndarray,
    img_path: str,
    geodesic_param_list,
    centers: np.ndarray | None = None,
    is_norm: bool = True,
):
    """Geodesic weight map (1, H, W) + the seed centers used.

    params = [a, b, c, d, bg_fill]: weight = exp(a * d_in/max) + b
    + (c * d_bg/max + d), with d_in the in-mask FMM distance from the seeds
    and d_bg the distance to the (bg_fill-filled) mask region. Degenerate
    seeds (off-mask centroid) return all-ones.
    Reference: geodesic.py:14-55.
    """
    mask = img.astype(bool)
    if centers is None:
        centers = compute_centroid(mask).reshape(-1, 2)
    else:
        centers = centers.copy().astype(np.int16)

    for center in centers:
        if img[0, center[1], center[0]] == 0:
            return np.ones_like(img).astype(np.float16), centers

    h, w = img.shape[1:]
    seeds = np.zeros((h, w), np.uint8)
    for center in centers:
        seeds[center[1], center[0]] = 1
    distance = fmm_distance(seeds, mask[0].astype(np.uint8))[None]

    # Background term: distance to the mask region (phi zero level inside
    # the mask, propagating outward).
    bg_seed = mask[0].astype(np.uint8)
    if float(geodesic_param_list[4]) != 0.0:
        # nonzero fill means the in-mask phi is not the zero set; the
        # shipped configs all use 0.0 (config/*.yaml geodesic_param_list).
        bg_seed = (bg_seed * 0).astype(np.uint8)
    distance_bg = fmm_distance(bg_seed, np.ones((h, w), np.uint8))[None]

    if np.isnan(distance_bg).any() or np.isinf(distance_bg).any() or \
            np.max(distance_bg) < 1:
        print(img_path)

    if is_norm:
        dmax = np.max(distance)
        if dmax > 0:
            distance = distance / dmax
        distance = np.exp(geodesic_param_list[0] * distance)
        distance = distance + geodesic_param_list[1]

        bmax = np.max(distance_bg)
        if bmax > 0:
            distance_bg = distance_bg / bmax
        distance_bg = geodesic_param_list[2] * distance_bg
        distance_bg = distance_bg + geodesic_param_list[3]

    return distance + distance_bg, centers
