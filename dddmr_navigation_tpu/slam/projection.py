"""Range-image projection + ground removal + segmentation — the JAX
re-design of lego_loam's ``ImageProjection``
(`lego_loam_bor/src/imageProjection.cpp:309-660`).

The reference builds OpenCV ``Mat`` range/label images point-by-point and
runs a BFS flood fill per unlabeled pixel. Here the scan lives as dense
(V, H) arrays end-to-end:

  * projection is a scatter by (ring, column) indices,
  * ground removal is a vectorized inter-ring angle test,
  * segmentation is connected-component labeling by iterative min-label
    propagation where the 4-neighbor connectivity is *gated by the LOAM
    angle criterion* (`labelComponents`' ``segmentTheta`` test) — the BFS
    becomes a fixed number of masked sweeps, and columns wrap (the lidar
    is a cylinder).

Outputs stay in image layout (V, H) with masks — the reference's
compacted per-ring arrays (start/end ring indices) are an artifact of
CPU pointer iteration; feature extraction here consumes the image
directly.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from dddmr_navigation_tpu.config import SlamConfig


class RangeImage(NamedTuple):
    rng: jnp.ndarray      # (V, H) f32 range; 0 where empty
    pts: jnp.ndarray      # (V, H, 3) f32 sensor-frame points
    valid: jnp.ndarray    # (V, H) bool
    ground: jnp.ndarray   # (V, H) bool ground-flagged pixels
    labels: jnp.ndarray   # (V, H) i32 segment label, -1 invalid/outlier
    segment_mask: jnp.ndarray  # (V, H) bool pixels in valid segments (or ground)


def project_scan(cfg: SlamConfig, points, mask):
    """Scatter a raw scan into the (V, H) range image
    (`imageProjection.cpp:317-408`): row from elevation against the
    vertical FOV, column from azimuth. Later points overwrite earlier
    ones in a cell (reference behavior: last write wins)."""
    v, h = cfg.num_vertical_scans, cfg.num_horizontal_scans
    pts = jnp.asarray(points, jnp.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rng = jnp.sqrt(x * x + y * y + z * z)
    elev = jnp.degrees(jnp.arctan2(z, jnp.sqrt(x * x + y * y)))
    ang_res_y = (cfg.vertical_angle_top - cfg.vertical_angle_bottom) / (v - 1)
    row = jnp.round((elev - cfg.vertical_angle_bottom) / ang_res_y).astype(
        jnp.int32)
    # reference column convention: horizonAngle = atan2(x, y), shifted so
    # index 0 faces -y; we keep a plain atan2(y, x) wrap — consistent
    # round-trips matter, not the absolute roll of the image.
    azim = jnp.arctan2(y, x)
    col = jnp.floor((azim + jnp.pi) / (2.0 * jnp.pi) * h).astype(jnp.int32)
    col = jnp.clip(col, 0, h - 1)

    ok = (jnp.asarray(mask, bool)
          & (row >= 0) & (row < v)
          & (rng > 0.1) & (rng <= cfg.maximum_detection_range))
    row_s = jnp.where(ok, row, v)   # drop row for invalid
    img_rng = jnp.zeros((v + 1, h), jnp.float32).at[row_s, col].set(
        jnp.where(ok, rng, 0.0), mode="drop")[:v]
    img_pts = jnp.zeros((v + 1, h, 3), jnp.float32).at[row_s, col].set(
        jnp.where(ok[:, None], pts, 0.0), mode="drop")[:v]
    valid = jnp.zeros((v + 1, h), bool).at[row_s, col].set(ok, mode="drop")[:v]
    return img_rng, img_pts, valid


def mark_ground(cfg: SlamConfig, img_pts, valid):
    """Ground removal (`imageProjection.cpp:408-445`): for rows below
    ``ground_scan_index``, a pixel pair (r, r+1) whose inter-ring vertical
    angle ``atan2(dz, ‖d‖)`` (the reference divides by the full 3D norm,
    `:437`) plus the mount angle is ≤ 10° flags BOTH pixels as ground.
    (The reference's between-ring "patch" emits extra output *points*,
    it does not flag pixels — so no patch term here.)"""
    v, h = valid.shape
    below = img_pts[:-1]          # (V-1, H, 3) lower ring
    above = img_pts[1:]
    d = above - below
    norm3 = jnp.linalg.norm(d, axis=-1)
    ang = jnp.degrees(jnp.arctan2(d[..., 2], norm3))
    pair_ok = valid[:-1] & valid[1:]
    is_ground_pair = pair_ok & (
        ang + cfg.sensor_mount_angle <= cfg.ground_angle_threshold) & (
        ang + cfg.sensor_mount_angle >= -cfg.ground_angle_threshold)

    row_idx = jax.lax.broadcasted_iota(jnp.int32, (v - 1, h), 0)
    in_ground_rows = row_idx < cfg.ground_scan_index
    gp = is_ground_pair & in_ground_rows
    ground = jnp.zeros((v, h), bool)
    ground = ground.at[:-1].set(gp)
    ground = ground.at[1:].max(gp)
    return ground & valid


def _angle_criterion(cfg: SlamConfig, rng_a, rng_b, alpha):
    """LOAM's segmentation angle (`labelComponents`): for two adjacent
    beams with ranges d1≥d2 separated by beam angle alpha,
    beta = atan2(d2 sin a, d1 − d2 cos a); connected when beta >
    segment_theta (a large beta means the surface is smooth across the
    gap)."""
    d1 = jnp.maximum(rng_a, rng_b)
    d2 = jnp.minimum(rng_a, rng_b)
    sa, ca = np.sin(alpha), np.cos(alpha)
    beta = jnp.arctan2(d2 * sa, d1 - d2 * ca)
    return beta > np.radians(cfg.segment_theta)


def segment_image(cfg: SlamConfig, img_rng, valid, ground,
                  num_iters: int = 48):
    """Connected components on non-ground pixels with angle-gated 4-
    connectivity (columns wrap). Returns (labels, segment_mask):

      * labels: (V, H) i32; −1 for invalid/ground/outlier pixels.
      * segment_mask: pixels in segments with ≥ ``segment_valid_point_num``
        points, or ≥ 3 points spanning ≥ ``segment_valid_line_num`` rings
        (`imageProjection.cpp:536-594` acceptance rule). Ground pixels are
        NOT in segment_mask (the reference keeps a decimated ground in the
        output cloud separately).
    """
    v, h = valid.shape
    seg = valid & ~ground

    ang_res_x = 2.0 * np.pi / cfg.num_horizontal_scans
    ang_res_y = np.radians(
        (cfg.vertical_angle_top - cfg.vertical_angle_bottom)
        / (cfg.num_vertical_scans - 1))

    right = jnp.roll(img_rng, -1, axis=1)
    right_ok = seg & jnp.roll(seg, -1, axis=1) & _angle_criterion(
        cfg, img_rng, right, ang_res_x)
    up = jnp.roll(img_rng, -1, axis=0)
    up_ok = seg & jnp.roll(seg, -1, axis=0) & _angle_criterion(
        cfg, img_rng, up, ang_res_y)
    up_ok = up_ok.at[-1].set(False)   # no vertical wrap

    lin = (jax.lax.broadcasted_iota(jnp.int32, (v, h), 0) * h
           + jax.lax.broadcasted_iota(jnp.int32, (v, h), 1))
    big = np.int32(v * h + 1)
    labels = jnp.where(seg, lin, big)

    left_ok = jnp.roll(right_ok, 1, axis=1)
    down_ok = jnp.concatenate(
        [jnp.zeros((1, h), bool), up_ok[:-1]], axis=0)

    def sweep(_, lbl):
        r = jnp.where(right_ok, jnp.roll(lbl, -1, axis=1), big)
        l = jnp.where(left_ok, jnp.roll(lbl, 1, axis=1), big)
        u = jnp.where(up_ok, jnp.roll(lbl, -1, axis=0), big)
        dn = jnp.where(down_ok,
                       jnp.concatenate([jnp.full((1, h), big, lbl.dtype),
                                        lbl[:-1]], axis=0), big)
        m = jnp.minimum(jnp.minimum(r, l), jnp.minimum(u, dn))
        return jnp.where(seg, jnp.minimum(lbl, m), big)

    labels = lax.fori_loop(0, num_iters, sweep, labels)

    # Segment acceptance: size ≥ valid_point_num, or ≥3 points on ≥
    # valid_line_num distinct rings.
    flat_lbl = jnp.where(seg, labels, big).reshape(-1)
    counts = jnp.zeros((v * h + 2,), jnp.int32).at[flat_lbl].add(1)
    # per-(label, ring) presence → rings spanned per label
    ring = jax.lax.broadcasted_iota(jnp.int32, (v, h), 0).reshape(-1)
    pair = jnp.where(seg.reshape(-1), labels.reshape(-1) * v + ring,
                     (v * h + 1) * v)
    ring_hit = jnp.zeros(((v * h + 2) * v,), jnp.int32).at[pair].max(1)
    rings_per_label = ring_hit.reshape(v * h + 2, v).sum(axis=1)

    lbl_flat = labels.reshape(-1)
    size_ok = counts[lbl_flat] >= cfg.segment_valid_point_num
    line_ok = (counts[lbl_flat] >= 3) & (
        rings_per_label[lbl_flat] >= cfg.segment_valid_line_num)
    accepted = seg.reshape(-1) & (size_ok | line_ok)
    accepted = accepted.reshape(v, h)
    labels = jnp.where(accepted, labels, -1)
    return labels, accepted


def project(cfg: SlamConfig, points, mask) -> RangeImage:
    """Full projection pipeline: scatter → ground → segments."""
    img_rng, img_pts, valid = project_scan(cfg, points, mask)
    ground = mark_ground(cfg, img_pts, valid)
    labels, seg_mask = segment_image(cfg, img_rng, valid, ground)
    return RangeImage(rng=img_rng, pts=img_pts, valid=valid, ground=ground,
                      labels=labels, segment_mask=seg_mask)


def patched_ground_points(cfg: SlamConfig, img_pts, valid, ground,
                          first_frame: bool = False):
    """The reference's patched-ground construction
    (`imageProjection.cpp:408-516`, the cloud `pcdSaver` stitches into the
    saved ``ground.pcd`` / per-keyframe ``*_ground.pcd`` via
    ``patchedGroundKeyFrames``, `mapOptimization.cpp:211-217,285`):

      * per azimuth column, every ground ring-pair (i, i+1) below
        ``ground_scan_index`` whose inter-ring gap is under
        ``distance_for_patch_between_rings`` emits interpolated points at
        the C++ loop's exact parametrization ``t = 0, dt, …`` with
        ``dt = 1/(ds/0.1 + 1)`` plus the upper endpoint;
      * the outermost patched ring per column contributes a ground-EDGE
        point (intensity 100 — `patched_ground_edge_`, the cloud the
        ground-edge detection thread refines, `mapOptimization.h:119`);
      * on the first frames (``first_frame``) the blind circle under the
        robot is filled from the closest ring edge toward base_link at the
        ring's own height (`imageProjection.cpp:482-506`);
      * both clouds voxel-downsample at the reference's 0.1 m leaf.

    Host-side (artifact/keyframe rate, not the control path). Returns
    (ground_pts (P, 3), edge_pts (E, 3)) float32 numpy arrays.
    """
    from dddmr_navigation_tpu.io.maps import voxel_downsample

    img_pts = np.asarray(img_pts)
    valid = np.asarray(valid)
    ground = np.asarray(ground)
    v, h = valid.shape
    gsi = int(cfg.ground_scan_index)
    out, edges = [], []
    for j in range(h):
        ring_edge = 0
        closest_ring_edge = gsi
        do_patch = False
        for i in range(gsi):
            if not (valid[i, j] and valid[i + 1, j]
                    and ground[i, j] and ground[i + 1, j]):
                continue
            lo = img_pts[i, j]
            dvec = img_pts[i + 1, j] - lo
            ds = float(np.linalg.norm(dvec))
            if i < closest_ring_edge:
                closest_ring_edge = i
            if ds < cfg.distance_for_patch_between_rings:
                ring_edge = i + 1
                dt = 1.0 / (ds / 0.1 + 1.0)
                t = 0.0
                while t <= 1.0:
                    out.append(lo + dvec * t)
                    t += dt
                out.append(lo + dvec)
                do_patch = True
        if valid[ring_edge, j]:
            edges.append(img_pts[ring_edge, j])
        if do_patch and first_frame and closest_ring_edge < gsi \
                and valid[closest_ring_edge, j]:
            p0 = img_pts[closest_ring_edge, j]
            for t in np.arange(0.0, 1.0 + 1e-6, 0.05):
                out.append([p0[0] * (1 - t), p0[1] * (1 - t), p0[2]])
    gpts = (np.asarray(out, np.float32) if out
            else np.zeros((0, 3), np.float32))
    epts = (np.asarray(edges, np.float32) if edges
            else np.zeros((0, 3), np.float32))
    return (voxel_downsample(gpts, 0.1).astype(np.float32),
            voxel_downsample(epts, 0.1).astype(np.float32))
