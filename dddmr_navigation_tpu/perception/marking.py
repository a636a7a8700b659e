"""Dynamic obstacle marking / clearing and the ground-node distance field.

This is the JAX re-design of the reference's `Marking` voxel-hash +
`MultiLayerSpinningLidar` mark/clear pipeline + `DynamicGraph`
("3D costmap") — `cluster_marking.cpp`, `multilayer_spinning_lidar.cpp`,
`dynamic_graph.cpp`:

  reference                          | here
  -----------------------------------+----------------------------------
  nested std::map voxel hash         | dense world-anchored scrolled
                                     |   (Nx,Ny,Nz) window grid
  EuclideanClusterExtraction + per-  | connected components by min-label
  cluster centroid accept/reject     |   propagation + centroid table
  per-voxel KD-tree ray casting      | range-image free-space comparison
  incremental dGraph setValue min /  | per-tick recompute of in-window
  removePCPtr restore                |   node distances (exact, no stale
                                     |   mins — see note below)
  node loop + 3D radius search       | pairwise matmul (nodes x marks)

Semantics preserved: truncation voxel keys, centroid-based cluster
rejection thresholds (0.05 m ground-attach, 0.1 m static-match,
`segmentation_ignore_ratio` gate), FOV gating of both marking and
clearing, XY-only distance values with 3D inflation_radius gating on the
robot-plane projection (`cluster_marking.cpp:49-96`), lethal at
``<= inscribed_radius``.

Note on recompute-vs-incremental: the reference's ``removePCPtr`` resets
cleared nodes to max distance even when *another* still-marked cluster
contributed a smaller value (`cluster_marking.cpp:125-138`); recomputing
from the live marked set each tick gives the distances a user would
expect and differs from the reference only in that transient, by at most
one tick.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.geometry import quat_rotate
from dddmr_navigation_tpu.perception.voxel import (
    VoxelSpec, world_to_cell, cell_to_world, window_origin_for, in_window,
    scroll_grid)
from dddmr_navigation_tpu.perception.fov import (
    RangeImageSpec, sensor_frame_spherical, in_fov, build_range_image,
    _bins as _ri_bins)
from dddmr_navigation_tpu.perception.clustering import (
    label_components, label_components_pooled, cluster_table)
from dddmr_navigation_tpu.perception.static_map import (
    MapContext, distance_to_ground, near_static)
from dddmr_navigation_tpu.ops.compaction import first_k_true_indices


class MarkingParams(NamedTuple):
    """Static (jit-constant) marking parameters; names mirror the
    reference's lidar-layer YAML keys."""
    vertical_FOV_top: float = 15.0
    vertical_FOV_bottom: float = -15.0
    scan_effective_positive_start: float = 30.0
    scan_effective_positive_end: float = 180.0
    scan_effective_negative_start: float = -30.0
    scan_effective_negative_end: float = -180.0
    marking_height: float = 2.0
    segmentation_ignore_ratio: float = 1.1
    cluster_tol_cells: int = 2
    cluster_iters: int = 24
    # Cluster on a pooled grid (1 = label the fine grid). 2 at a 0.05 m
    # grid reproduces the REFERENCE's clustering granularity exactly: it
    # voxel-downsamples to a 0.1 m leaf before EuclideanClusterExtraction
    # with a 0.1 m tolerance (`multilayer_spinning_lidar.cpp:268,327`),
    # i.e. connectivity is decided on a 0.1 m lattice there too.
    cluster_pool: int = 1
    max_clusters: int = 64
    max_marked_voxels: int = 2048
    max_window_nodes: int = 8192
    inflation_radius: float = 1.5
    inscribed_radius: float = 0.5
    max_obstacle_distance: float = 9999.0
    clear_range_margin: float = 0.05   # reference: last-5cm ray tolerance
    reobserve_margin: float = 0.10     # reference: resolution-radius re-obs test

    @classmethod
    def from_config(cls, pcfg) -> "MarkingParams":
        """Build from a :class:`PerceptionConfig` — the single source of
        truth for the reference YAML names (lidar FOV/marking keys +
        GlobalUtils inflation block). Prefer this over the bare defaults,
        which exist only for standalone kernel tests."""
        lidar = pcfg.lidar
        return cls(
            vertical_FOV_top=lidar.vertical_FOV_top,
            vertical_FOV_bottom=lidar.vertical_FOV_bottom,
            scan_effective_positive_start=lidar.scan_effective_positive_start,
            scan_effective_positive_end=lidar.scan_effective_positive_end,
            scan_effective_negative_start=lidar.scan_effective_negative_start,
            scan_effective_negative_end=lidar.scan_effective_negative_end,
            marking_height=lidar.marking_height,
            segmentation_ignore_ratio=lidar.segmentation_ignore_ratio,
            max_marked_voxels=pcfg.max_marked_voxels,
            max_window_nodes=getattr(pcfg, "max_window_nodes", 8192),
            cluster_pool=getattr(pcfg, "cluster_pool", 1),
            inflation_radius=pcfg.inflation_radius,
            inscribed_radius=pcfg.inscribed_radius,
            max_obstacle_distance=pcfg.max_obstacle_distance,
        )


class MarkingState(NamedTuple):
    """Per-robot dynamic perception state (device pytree)."""
    grid: jnp.ndarray     # (Nx,Ny,Nz) uint8 marked obstacle cells
    origin: jnp.ndarray   # (3,) int32 window origin in global voxel coords
    dgraph: jnp.ndarray   # (G,) f32 distance-to-obstacle per ground node
    # rotating start of the clear-test extraction window: advancing by
    # max_marked_voxels per tick guarantees every marked cell is
    # clear-tested within ceil(n_cells / max_marked_voxels) ticks even
    # when the marked set exceeds the extraction cap (round-2 advisor
    # finding: a fixed linear-order window could starve late cells).
    clear_offset: jnp.ndarray  # () int32


def init_marking_state(spec: VoxelSpec, params: MarkingParams,
                       num_ground_nodes: int, robot_xyz=None) -> MarkingState:
    if robot_xyz is None:
        robot_xyz = jnp.zeros((3,), jnp.float32)
    return MarkingState(
        grid=jnp.zeros((spec.nx, spec.ny, spec.nz), jnp.uint8),
        origin=window_origin_for(spec, robot_xyz),
        dgraph=jnp.full((num_ground_nodes,), params.max_obstacle_distance,
                        jnp.float32),
        clear_offset=jnp.asarray(0, jnp.int32),
    )


def _window_cell_positions(spec: VoxelSpec, origin):
    """(Nx,Ny,Nz,3) world position of every window cell (voxel corner, the
    reference's representative point)."""
    gx = jax.lax.broadcasted_iota(jnp.int32, (spec.nx, spec.ny, spec.nz), 0)
    gy = jax.lax.broadcasted_iota(jnp.int32, (spec.nx, spec.ny, spec.nz), 1)
    gz = jax.lax.broadcasted_iota(jnp.int32, (spec.nx, spec.ny, spec.nz), 2)
    cells = jnp.stack([gx + origin[0], gy + origin[1], gz + origin[2]], -1)
    return cell_to_world(spec, cells)


def clear_marked(spec: VoxelSpec, ri_spec: RangeImageSpec,
                 params: MarkingParams, grid, origin,
                 sensor_pos, sensor_quat, scan_pts, scan_mask,
                 clear_offset=0):
    """Range-image clearing of the marked grid (selfClear semantics).

    A marked cell is kept when (a) it is outside the sensor FOV, (b) the
    ray toward it is blocked by a current scan return closer than the cell
    (minus the 5 cm tolerance), or (c) it is re-observed (a return at
    ~the cell's range in its direction). Otherwise observed-free ⇒ cleared.

    Like the reference — which iterates the marked voxel hash, not the
    window (`multilayer_spinning_lidar.cpp:456-628`) — the test runs only
    on the ≤ ``max_marked_voxels`` EXTRACTED marked cells, not all window
    cells: spherical coordinates for a full 128³-class window cost about
    100× the extracted set's gather/transcendental work (chosen before the
    port to the H100; not re-measured there). The 3×3-bin neighborhood
    lookup is folded into one min-pool of the (rows, cols) range image (identical result). Cells
    beyond the extraction cap are not clear-tested THIS tick, but the
    window starts at ``clear_offset`` (wrapping), which
    `perception_update` advances by the cap every tick — every marked
    cell is therefore tested within ceil(n_cells / cap) ticks no matter
    how many cells are marked (conservative in between: overflow cells
    stay marked, never wrongly cleared).
    """
    n_valid = jnp.sum(scan_mask)
    img = build_range_image(ri_spec, sensor_pos, sensor_quat, scan_pts, scan_mask)
    # 3×3 min-pool (rows clamp, cols wrap) ≡ lookup_range's neighborhood
    # min, hoisted from 9 per-cell gathers to 9 tiny image ops.
    rows = jnp.arange(ri_spec.rows)
    pooled = img
    for dr in (-1, 0, 1):
        shifted = img[jnp.clip(rows + dr, 0, ri_spec.rows - 1)]
        for dc in (-1, 0, 1):
            pooled = jnp.minimum(pooled, jnp.roll(shifted, dc, axis=1))

    flat = grid.reshape(-1).astype(bool)
    k = params.max_marked_voxels
    n_cells = flat.shape[0]
    off = jnp.asarray(clear_offset, jnp.int32) % n_cells
    idx_rot = first_k_true_indices(jnp.roll(flat, -off), k)
    valid = idx_rot >= 0
    idx = jnp.where(valid, (idx_rot + off) % n_cells, -1)
    safe = jnp.maximum(idx, 0)
    iz = safe % spec.nz
    iy = (safe // spec.nz) % spec.ny
    ix = safe // (spec.ny * spec.nz)
    cells = jnp.stack([ix + origin[0], iy + origin[1], iz + origin[2]], -1)
    pos = cell_to_world(spec, cells)                              # (k, 3)

    rng, elev, azim = sensor_frame_spherical(sensor_pos, sensor_quat, pos)
    fov = in_fov(
        elev, azim,
        vertical_FOV_bottom=params.vertical_FOV_bottom,
        vertical_FOV_top=params.vertical_FOV_top,
        scan_effective_positive_start=params.scan_effective_positive_start,
        scan_effective_positive_end=params.scan_effective_positive_end,
        scan_effective_negative_start=params.scan_effective_negative_start,
        scan_effective_negative_end=params.scan_effective_negative_end,
    )
    row, col = _ri_bins(ri_spec, elev, azim)
    scan_r = pooled[row, col]                                     # (k,)
    blocked = scan_r < rng - params.clear_range_margin
    reobserved = jnp.abs(scan_r - rng) <= params.reobserve_margin
    keep = (~fov) | blocked | reobserved
    # With an (near) empty scan we cannot assert free space — keep all.
    clear = valid & ~keep & (n_valid >= 5)
    new_flat = flat.at[jnp.where(clear, idx, flat.shape[0])].set(
        False, mode="drop")
    return new_flat.reshape(grid.shape).astype(jnp.uint8)


def mark_scan(spec: VoxelSpec, params: MarkingParams, grid, origin,
              map_ctx: MapContext, scan_pts, scan_mask, robot_pos, robot_quat,
              sensor_pos, sensor_quat):
    """Cluster the scan and mark accepted clusters (selfMark semantics)."""
    # Crop: inside window band around the robot, z within marking height.
    rel_z = scan_pts[..., 2] - robot_pos[2]
    cells = world_to_cell(spec, scan_pts)
    local = cells - origin[None, :]
    ok = (
        scan_mask
        & in_window(spec, local)
        & (rel_z >= 0.0) & (rel_z <= params.marking_height)
    )
    local = jnp.clip(local, 0, jnp.asarray([spec.nx - 1, spec.ny - 1, spec.nz - 1]))

    scan_occ = jnp.zeros((spec.nx, spec.ny, spec.nz), bool)
    scan_occ = scan_occ.at[local[:, 0], local[:, 1], local[:, 2]].max(ok)

    if params.cluster_pool > 1:
        labels, root_mask = label_components_pooled(
            scan_occ, params.cluster_pool, params.cluster_iters)
    else:
        labels = label_components(scan_occ, params.cluster_tol_cells,
                                  params.cluster_iters)
        root_mask = None
    pos = _window_cell_positions(spec, origin)
    centroids, sizes, cell_idx = cluster_table(
        labels, scan_occ, pos, params.max_clusters, root_mask=root_mask)

    # Cluster accept tests (reference multilayer_spinning_lidar.cpp:369-432):
    ground_attached = distance_to_ground(map_ctx, centroids) <= 0.05
    if params.segmentation_ignore_ratio <= 0.999:
        static_hit = near_static(map_ctx, centroids, 0.1)
    else:
        static_hit = jnp.zeros(ground_attached.shape, bool)
    # FOV check of the voxelized centroid.
    _, elev_c, azim_c = sensor_frame_spherical(sensor_pos, sensor_quat, centroids)
    fov_c = in_fov(
        elev_c, azim_c,
        vertical_FOV_bottom=params.vertical_FOV_bottom,
        vertical_FOV_top=params.vertical_FOV_top,
        scan_effective_positive_start=params.scan_effective_positive_start,
        scan_effective_positive_end=params.scan_effective_positive_end,
        scan_effective_negative_start=params.scan_effective_negative_start,
        scan_effective_negative_end=params.scan_effective_negative_end,
    )
    accept = (sizes > 0) & (~ground_attached) & (~static_hit) & fov_c

    # Per-cell accept WITHOUT a window-sized element gather: accept is a
    # tiny (K,) table, but `accept[cell_idx]` over the whole window is one
    # element gather per cell. The (cells × K) compare fuses into one
    # any-reduce that reads cell_idx once, for the same result (chosen
    # before the port to the H100; not re-measured there).
    ks = jnp.arange(params.max_clusters)
    cell_accept = jnp.any(
        (cell_idx[..., None] == ks) & accept[None, None, None, :], axis=-1)
    return jnp.maximum(grid, cell_accept.astype(jnp.uint8))


def update_dgraph(spec: VoxelSpec, params: MarkingParams, grid, origin,
                  dgraph, map_ctx: MapContext, robot_pos, robot_quat):
    """Recompute in-window ground-node distances from the marked set.

    Marked cell centers are projected onto the robot's base plane
    (the reference projects cluster clouds with ProjectInliers using the
    base normal, `multilayer_spinning_lidar.cpp:402-416` +
    `cluster_marking.cpp:54-60`), gated by 3D ``inflation_radius``, and the
    recorded value is the XY distance (`cluster_marking.cpp:80-88`).
    """
    flat = grid.reshape(-1).astype(bool)
    k = params.max_marked_voxels
    mark_idx = first_k_true_indices(flat, k)
    mark_valid = mark_idx >= 0
    pos = _window_cell_positions(spec, origin).reshape(-1, 3)
    mpts = pos[jnp.clip(mark_idx, 0, pos.shape[0] - 1)]

    # Project marked points onto the robot base plane.
    normal = quat_rotate(robot_quat, jnp.asarray([0.0, 0.0, 1.0]))
    offs = jnp.sum((mpts - robot_pos) * normal, axis=-1)
    mproj = mpts - offs[:, None] * normal[None, :]

    # Ground nodes near the window.
    half_extent = 0.5 * spec.nx * spec.xy_resolution + params.inflation_radius
    near = (
        map_ctx.ground_valid
        & (jnp.abs(map_ctx.ground[:, 0] - robot_pos[0]) <= half_extent)
        & (jnp.abs(map_ctx.ground[:, 1] - robot_pos[1]) <= half_extent)
    )
    n = params.max_window_nodes
    node_idx = first_k_true_indices(near, n)
    node_valid = node_idx >= 0
    nodes = map_ctx.ground[jnp.clip(node_idx, 0, map_ctx.ground.shape[0] - 1)]

    # Pairwise (n, k): 3D gate on projected points, XY distance value.
    # |a-b|^2 = |a|^2 + |b|^2 - 2 a.b keeps the (n,k) matrix as the only
    # large intermediate and computes the cross term as one matmul.
    # Inputs are recentered on the robot first: at global coordinates of
    # O(100 m) the cancellation otherwise costs centimeters of accuracy.
    def sq_dists(a, b):
        a2 = jnp.sum(a * a, axis=-1)
        b2 = jnp.sum(b * b, axis=-1)
        # HIGHEST: a reduced-precision f32 matmul (TF32 on the GPU) would
        # break the expansion's cancellation; it needs full f32 terms.
        cross = jnp.dot(a, b.T, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        return jnp.maximum(a2[:, None] + b2[None, :] - 2.0 * cross, 0.0)

    nodes_c = nodes - robot_pos
    mproj_c = mproj - robot_pos
    d3sq = sq_dists(nodes_c, mproj_c)
    dxy = jnp.sqrt(sq_dists(nodes_c[:, :2], mproj_c[:, :2]))
    use = mark_valid[None, :] & (d3sq <= params.inflation_radius ** 2)
    dxy = jnp.where(use, dxy, params.max_obstacle_distance)
    node_d = jnp.min(dxy, axis=1)

    new_dgraph = dgraph.at[jnp.where(node_valid, node_idx, dgraph.shape[0])].set(
        jnp.where(node_valid, node_d, 0.0), mode="drop")
    return new_dgraph


def perception_update(spec: VoxelSpec, ri_spec: RangeImageSpec,
                      params: MarkingParams, state: MarkingState,
                      map_ctx: MapContext, scan_pts, scan_mask,
                      robot_pos, robot_quat, sensor_pos, sensor_quat
                      ) -> MarkingState:
    """One mark/clear tick: scroll window → clear → mark → distance field.
    Mirrors `StackedPerception::doClear_then_Mark`
    (`stacked_perception.cpp:72-90`: clear first, then mark)."""
    new_origin = window_origin_for(spec, robot_pos)
    grid = scroll_grid(state.grid, state.origin, new_origin)
    grid = clear_marked(spec, ri_spec, params, grid, new_origin,
                        sensor_pos, sensor_quat, scan_pts, scan_mask,
                        clear_offset=state.clear_offset)
    grid = mark_scan(spec, params, grid, new_origin, map_ctx, scan_pts,
                     scan_mask, robot_pos, robot_quat, sensor_pos, sensor_quat)
    dgraph = update_dgraph(spec, params, grid, new_origin, state.dgraph,
                           map_ctx, robot_pos, robot_quat)
    n_cells = spec.nx * spec.ny * spec.nz
    return MarkingState(
        grid=grid, origin=new_origin, dgraph=dgraph,
        clear_offset=(state.clear_offset + params.max_marked_voxels)
        % n_cells)
