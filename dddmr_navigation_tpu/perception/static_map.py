"""Static map context: ground cloud + map cloud preprocessed into
device-friendly lookup structures.

Replaces the reference's PCL KD-trees over ``mapground``/``mapcloud``
(`static_layer.cpp:146-199`) with:

  * a dense 2D ground **heightmap** (min ground z per XY cell) for
    ground-attachment tests (the reference's 0.05 m radius search of a
    cluster centroid against the ground KD-tree,
    `multilayer_spinning_lidar.cpp:370-373`),
  * a dense 3D **static occupancy grid** over the map bounds for
    static-match rejection (the reference's 0.1 m radius search against the
    map KD-tree, `multilayer_spinning_lidar.cpp:383-393`) and for
    line-of-sight tests,
  * padded ground-node arrays consumed by the distance-field update and the
    global planner.

Construction is host-side NumPy (one-time at map load); lookups are jnp.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MapContext:
    """Immutable per-map device state. Array fields are pytree data; the
    grid resolutions are static metadata (needed for shapes under jit)."""
    ground: jnp.ndarray          # (G, 3) f32 ground node positions
    ground_valid: jnp.ndarray    # (G,) bool (padding mask)
    node_weight: jnp.ndarray     # (G,) f32 static-layer node weights
    # heightmap
    height: jnp.ndarray          # (Hx, Hy) f32 ground z (inf where no ground)
    height_origin: jnp.ndarray   # (2,) f32 world xy of cell (0,0) corner
    # static occupancy
    static_occ: jnp.ndarray      # (Sx, Sy, Sz) uint8
    static_origin: jnp.ndarray   # (3,) f32 world xyz of cell (0,0,0) corner
    height_res: float = dataclasses.field(metadata=dict(static=True), default=0.25)
    static_res: float = dataclasses.field(metadata=dict(static=True), default=0.1)


def build_map_context(ground_pts: np.ndarray, map_pts: np.ndarray | None = None,
                      *, height_res: float = 0.25, static_res: float = 0.1,
                      pad_to: int | None = None,
                      node_weight: np.ndarray | None = None) -> MapContext:
    ground_pts = np.asarray(ground_pts, dtype=np.float32)[:, :3]
    if map_pts is None or len(map_pts) == 0:
        map_pts = np.zeros((1, 3), np.float32) + 1e6  # far away
    map_pts = np.asarray(map_pts, dtype=np.float32)[:, :3]

    g = len(ground_pts)
    pad = pad_to or g
    assert pad >= g
    ground = np.full((pad, 3), 1e6, np.float32)
    ground[:g] = ground_pts
    valid = np.zeros((pad,), bool)
    valid[:g] = True
    nw = np.zeros((pad,), np.float32)
    if node_weight is not None:
        nw[:g] = node_weight[:g]

    # Heightmap over ground bounds (+1 cell border).
    mn = ground_pts.min(0) - height_res
    mx = ground_pts.max(0) + height_res
    hx = int(np.ceil((mx[0] - mn[0]) / height_res)) + 1
    hy = int(np.ceil((mx[1] - mn[1]) / height_res)) + 1
    height = np.full((hx, hy), np.inf, np.float32)
    ix = ((ground_pts[:, 0] - mn[0]) / height_res).astype(np.int64)
    iy = ((ground_pts[:, 1] - mn[1]) / height_res).astype(np.int64)
    np.minimum.at(height, (ix, iy), ground_pts[:, 2])

    # Static occupancy over map bounds.
    all_pts = map_pts
    smn = all_pts.min(0) - static_res
    smx = all_pts.max(0) + static_res
    # Cap grid size for degenerate/far-away sentinel clouds.
    dims = np.minimum(
        np.ceil((smx - smn) / static_res).astype(np.int64) + 1, 2048)
    occ = np.zeros(tuple(dims), np.uint8)
    ci = np.clip(((all_pts - smn) / static_res).astype(np.int64), 0, dims - 1)
    occ[ci[:, 0], ci[:, 1], ci[:, 2]] = 1

    return MapContext(
        ground=jnp.asarray(ground),
        ground_valid=jnp.asarray(valid),
        node_weight=jnp.asarray(nw),
        height=jnp.asarray(height),
        height_origin=jnp.asarray(mn[:2]),
        height_res=float(height_res),
        static_occ=jnp.asarray(occ),
        static_origin=jnp.asarray(smn),
        static_res=float(static_res),
    )


def ground_height_at(ctx: MapContext, xy):
    """Ground z under world xy (3x3 neighborhood min; inf if unmapped)."""
    ij = ((xy - ctx.height_origin) / ctx.height_res).astype(jnp.int32)
    hx, hy = ctx.height.shape
    out = jnp.full(ij.shape[:-1], jnp.inf, dtype=jnp.float32)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            i = jnp.clip(ij[..., 0] + di, 0, hx - 1)
            j = jnp.clip(ij[..., 1] + dj, 0, hy - 1)
            out = jnp.minimum(out, ctx.height[i, j])
    return out


def distance_to_ground(ctx: MapContext, pts):
    """Approximate distance from points to the ground surface: |z - h(x,y)|.
    Stands in for the reference's 3D radius search against the ground
    KD-tree (tolerance-equivalent for near-vertical separations, which is
    what the 0.05 m attach test measures)."""
    h = ground_height_at(ctx, pts[..., :2])
    return jnp.where(jnp.isfinite(h), jnp.abs(pts[..., 2] - h), jnp.inf)


def near_static(ctx: MapContext, pts, radius: float):
    """True where a point has static map occupancy within ``radius``
    (checked on the static grid over a cube neighborhood — the analogue of
    the reference's 0.1 m map KD-tree search)."""
    r_cells = max(int(np.ceil(radius / ctx.static_res)), 1)
    ci = ((pts - ctx.static_origin) / ctx.static_res).astype(jnp.int32)
    sx, sy, sz = ctx.static_occ.shape
    hit = jnp.zeros(pts.shape[:-1], dtype=bool)
    for dx in range(-r_cells, r_cells + 1):
        for dy in range(-r_cells, r_cells + 1):
            for dz in range(-r_cells, r_cells + 1):
                x = jnp.clip(ci[..., 0] + dx, 0, sx - 1)
                y = jnp.clip(ci[..., 1] + dy, 0, sy - 1)
                z = jnp.clip(ci[..., 2] + dz, 0, sz - 1)
                hit = hit | (ctx.static_occ[x, y, z] > 0)
    return hit
