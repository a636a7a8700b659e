"""LOAM feature extraction — JAX re-design of lego_loam's
``FeatureAssociation`` front half
(`lego_loam_bor/src/featureAssociation.cpp:318-520`).

The reference compacts the segmented cloud into per-ring arrays, sorts
each of 6 ring sectors by curvature, and walks the sorted order picking
features while suppressing ±5 neighbors. Here everything stays in the
(V, H) range-image layout:

  * smoothness: an 11-tap convolution along the ring
    (`calculateSmoothness`, `:318-342` — sum of 5 ranges each side minus
    10× center, squared),
  * occlusion/parallel-beam marking vectorized (`markOccludedPoints`,
    `:344-381`),
  * picking: each (ring, sector) is an independent lane; a short
    ``fori_loop`` of masked argmax picks replaces sort-and-walk (picks
    per lane are ≤ 20, so the loop is tiny), suppression is a ±5 column
    band mask. vmapped over all 96 lanes at once.

Feature classes mirror the reference: sharp (top-2 corners/sector),
less-sharp (top-20), flat (4 ground points/sector), less-flat (decimated
remainder of segment+ground pixels).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from dddmr_navigation_tpu.config import SlamConfig
from dddmr_navigation_tpu.slam.projection import RangeImage


class FeatureSet(NamedTuple):
    sharp: jnp.ndarray        # (max_sharp, 3)
    sharp_mask: jnp.ndarray
    less_sharp: jnp.ndarray   # (max_less_sharp, 3)
    less_sharp_mask: jnp.ndarray
    flat: jnp.ndarray         # (max_flat, 3)
    flat_mask: jnp.ndarray
    less_flat: jnp.ndarray    # (max_less_flat, 3)
    less_flat_mask: jnp.ndarray
    # ring (scan-row) index per target feature — the reference stores it
    # in point intensity and constrains correspondence picks with it
    # (`featureAssociation.cpp:633-676` corners, `:751-806` surfs).
    less_sharp_ring: jnp.ndarray   # (max_less_sharp,) i32
    less_flat_ring: jnp.ndarray    # (max_less_flat,) i32
    # True where a less-flat pick is a ground pixel: the artifact writer
    # splits map.pcd (structural) from ground.pcd with it, mirroring the
    # reference's ground-edge detection thread (`mapOptimization.h:119`).
    less_flat_ground: jnp.ndarray  # (max_less_flat,) bool


def smoothness(rng, valid):
    """`calculateSmoothness`: curvature over ±5 ring neighbors. Pixels
    whose 11-tap window touches an invalid pixel get +inf curvature-mask
    (they are never picked as flat and the corner gate also requires the
    window to be clean)."""
    acc = -10.0 * rng
    win_ok = valid
    for off in range(1, 6):
        acc = acc + jnp.roll(rng, off, axis=1) + jnp.roll(rng, -off, axis=1)
        win_ok = win_ok & jnp.roll(valid, off, axis=1) \
            & jnp.roll(valid, -off, axis=1)
    return acc * acc, win_ok


def occlusion_mask(rng, valid):
    """`markOccludedPoints`: pixels adjacent to a ≥0.3 m range step are
    suppressed on the nearer side (6-wide band); parallel-beam pixels
    (both neighbors differ by >2% of range) are suppressed too.
    Returns True where PICKING IS FORBIDDEN."""
    nxt = jnp.roll(rng, -1, axis=1)
    both = valid & jnp.roll(valid, -1, axis=1)
    occl_here = both & (rng - nxt > 0.3)    # this side farther → mark i-5..i
    occl_next = both & (nxt - rng > 0.3)    # next side farther → mark i+1..i+6

    banned = jnp.zeros_like(valid)
    for off in range(0, 6):
        banned = banned | jnp.roll(occl_here, off, axis=1)
    for off in range(1, 7):
        banned = banned | jnp.roll(occl_next, off, axis=1)

    d_prev = jnp.abs(jnp.roll(rng, 1, axis=1) - rng)
    d_next = jnp.abs(nxt - rng)
    parallel = valid & (d_prev > 0.02 * rng) & (d_next > 0.02 * rng)
    return banned | parallel


def _pick_lane(curv, elig, maximize: bool, n_picks: int, suppress: int = 5):
    """Greedy pick loop on one lane (an H-vector): n_picks masked
    argmax/argmin with ±suppress suppression. Returns (H,) pick order
    (−1 not picked, else 0..n_picks−1)."""
    h = curv.shape[0]
    sign = 1.0 if maximize else -1.0
    order = jnp.full((h,), -1, jnp.int32)

    def body(k, carry):
        order, elig = carry
        score = jnp.where(elig, sign * curv, -jnp.inf)
        i = jnp.argmax(score)
        ok = jnp.isfinite(score[i])
        order = jnp.where(ok, order.at[i].set(k), order)
        col = jnp.arange(h)
        band = jnp.abs(col - i) <= suppress
        elig = elig & jnp.where(ok, ~band, True)
        return order, elig

    order, _ = lax.fori_loop(0, n_picks, body, (order, elig))
    return order


def _compact(pts, mask, size):
    """Static-shape compaction of masked (V,H) picks into (size, 3).
    Returns (points, valid, ring): ring = source image row per pick."""
    v, h = mask.shape
    flat_m = mask.reshape(-1)
    idx = jnp.nonzero(flat_m, size=size, fill_value=-1)[0]
    ok = idx >= 0
    p = pts.reshape(-1, 3)[jnp.clip(idx, 0, v * h - 1)]
    ring = jnp.where(ok, jnp.clip(idx, 0, v * h - 1) // h, -1).astype(
        jnp.int32)
    return jnp.where(ok[:, None], p, 0.0), ok, ring


def extract_features(cfg: SlamConfig, img: RangeImage) -> FeatureSet:
    """`extractFeatures` (`featureAssociation.cpp:381-520`)."""
    v, h = img.valid.shape
    n_sectors = 6
    curv, win_ok = smoothness(img.rng, img.valid)
    banned = occlusion_mask(img.rng, img.valid)

    col = jax.lax.broadcasted_iota(jnp.int32, (v, h), 1)
    sector = col * n_sectors // h      # (V, H) 0..5

    corner_elig = (img.segment_mask & ~img.ground & win_ok & ~banned
                   & (curv > cfg.edge_threshold))
    flat_elig = (img.ground & img.valid & win_ok & ~banned
                 & (curv < cfg.surf_threshold))

    # lanes: (V * n_sectors, H) with out-of-sector columns ineligible
    def lanes(elig):
        e = elig[:, None, :] & (sector[:, None, :] ==
                                jnp.arange(n_sectors)[None, :, None])
        return e.reshape(v * n_sectors, h)

    corner_order = jax.vmap(
        lambda c, e: _pick_lane(c, e, True, 20))(
        jnp.broadcast_to(curv[:, None, :], (v, n_sectors, h)
                         ).reshape(v * n_sectors, h),
        lanes(corner_elig)).reshape(v, n_sectors, h)
    corner_order = jnp.max(corner_order, axis=1)          # merge sectors

    flat_order = jax.vmap(
        lambda c, e: _pick_lane(c, e, False, 4))(
        jnp.broadcast_to(curv[:, None, :], (v, n_sectors, h)
                         ).reshape(v * n_sectors, h),
        lanes(flat_elig)).reshape(v, n_sectors, h)
    flat_order = jnp.max(flat_order, axis=1)

    sharp_m = corner_order >= 0
    sharp2_m = sharp_m & (corner_order < 2)
    flat_m = flat_order >= 0

    # less-flat: every segment/ground pixel not picked as corner,
    # decimated ×4 along the ring (stand-in for the reference's
    # VoxelGrid downsample of surfPointsLessFlatScan).
    less_flat_m = ((img.segment_mask | img.ground) & img.valid
                   & ~sharp_m & (col % 4 == 0))

    sharp, sm, _ = _compact(img.pts, sharp2_m, cfg.max_sharp)
    less_sharp, lsm, lsr = _compact(img.pts, sharp_m, cfg.max_less_sharp)
    flat, fm, _ = _compact(img.pts, flat_m, cfg.max_flat)
    less_flat, lfm, lfr = _compact(img.pts, less_flat_m, cfg.max_less_flat)
    lf_idx = jnp.nonzero(less_flat_m.reshape(-1), size=cfg.max_less_flat,
                         fill_value=0)[0]
    lf_ground = img.ground.reshape(-1)[lf_idx] & lfm
    return FeatureSet(sharp, sm, less_sharp, lsm, flat, fm, less_flat, lfm,
                      lsr, lfr, lf_ground)
