"""Depth-camera marking/clearing layer — JAX re-design of
``perception_3d::DepthCameraLayer`` + ``FrustumUtils``
(`plugins/depth_camera/depth_camera_layer.cpp:197-620`,
`frustum_utils.cpp:219-291`).

The reference buffers per-camera observations, computes the 6 frustum
planes of each, and clears marked voxels by point-in-frustum +
re-observation tests with per-voxel KD-tree searches. Here:

  * a camera observation is its pose + intrinsic FOV description; the 6
    frustum plane normals derive from it in closed form,
  * point-in-frustum is 6 dot products, batched over all window voxels
    and all cameras at once (`isinFrustumsObservations` semantics: inside
    ANY camera's latest frustum),
  * re-observation uses the same range-image comparison as the lidar
    layer (`fov.build_range_image`) built from the depth cloud — a voxel
    inside a frustum is kept if the depth image blocks or re-observes it,
    cleared otherwise,
  * marking voxelizes the depth cloud directly (the reference marks
    cluster-free: every buffered point within the marking band,
    `depth_camera_layer.cpp:458-620`).

Also provides :func:`depth_image_to_points` — the
`depthimg2pointcloud` util node (`utils/depthimg2pointcloud_node.cpp`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.geometry import quat_rotate, quat_inverse_rotate
from dddmr_navigation_tpu.perception.voxel import (
    VoxelSpec, world_to_cell, in_window)


class CameraModel(NamedTuple):
    """Static pinhole description (reference DepthCameraObservation
    geometry: near/far planes + half FOV angles)."""
    h_fov: float = 1.0     # full horizontal FOV (radians)
    v_fov: float = 0.8
    min_detect_distance: float = 0.3
    max_detect_distance: float = 2.5


def frustum_planes(cam: CameraModel, cam_pos, cam_quat):
    """6 frustum planes as (normals (6,3), points (6,3)) with inward
    normals — the reference stores plane normals + the BRNear/TLFar
    corners (`depth_camera_observation.cpp` frustum construction).
    Camera convention: +x forward, +y left, +z up (the reference
    transforms optical frames to this before building frustums)."""
    th, tv = cam.h_fov / 2.0, cam.v_fov / 2.0
    n_near = jnp.asarray([1.0, 0.0, 0.0])
    n_far = jnp.asarray([-1.0, 0.0, 0.0])
    cl, sl = jnp.cos(th), jnp.sin(th)
    cv, sv = jnp.cos(tv), jnp.sin(tv)
    n_left = jnp.asarray([sl, -cl, 0.0])    # inward for a left plane
    n_right = jnp.asarray([sl, cl, 0.0])
    n_top = jnp.asarray([sv, 0.0, -cv])
    n_bot = jnp.asarray([sv, 0.0, cv])
    normals = jnp.stack([n_near, n_left, n_right, n_far, n_top, n_bot])
    normals = quat_rotate(cam_quat[None, :], normals)
    near_pt = cam_pos + quat_rotate(
        cam_quat, jnp.asarray([cam.min_detect_distance, 0.0, 0.0]))
    far_pt = cam_pos + quat_rotate(
        cam_quat, jnp.asarray([cam.max_detect_distance, 0.0, 0.0]))
    # side planes contain the apex; near/far contain their axis points
    pts = jnp.stack([near_pt, cam_pos, cam_pos, far_pt, cam_pos, cam_pos])
    return normals, pts


def in_frustum(normals, plane_pts, query):
    """Inside test for (..., 3) points: all 6 signed distances ≥ 0
    (`frustum_utils.cpp:243-285`)."""
    d = query[..., None, :] - plane_pts           # (..., 6, 3)
    s = jnp.sum(d * normals, axis=-1)             # (..., 6)
    return jnp.all(s >= 0.0, axis=-1)


def depth_image_to_points(depth, fx, fy, cx, cy, depth_scale: float = 1.0):
    """`depthimg2pointcloud_node.cpp:27-170`: depth image (H, W) +
    intrinsics → (H*W, 3) optical-frame points (+z forward) and a
    validity mask."""
    h, w = depth.shape
    u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    z = depth.astype(jnp.float32) * depth_scale
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = jnp.stack([x, y, z], axis=-1).reshape(-1, 3)
    mask = (z > 0.05).reshape(-1)
    return pts, mask


def optical_to_forward(pts):
    """Optical (+z forward, +x right, +y down) → body (+x forward,
    +y left, +z up)."""
    return jnp.stack([pts[..., 2], -pts[..., 0], -pts[..., 1]], axis=-1)


class DepthCameraObservation(NamedTuple):
    """One camera's latest observation (device pytree)."""
    cam_pos: jnp.ndarray    # (3,)
    cam_quat: jnp.ndarray   # (4,)
    points: jnp.ndarray     # (P, 3) world-frame depth points
    mask: jnp.ndarray       # (P,)


class DepthCameraBuffer(NamedTuple):
    """N-deep per-camera observation ring with expiry — the
    `DepthCameraObservationBuffer` re-design
    (`depth_camera_observation_buffer.cpp:78` `bufferCloud` +
    `purgeStaleObservations`): clearing must test marked voxels against
    *every* live frustum, so a voxel inside an OLDER (but unexpired)
    frustum still clears even when the camera has since looked away.
    Leading axes are (cameras, depth)."""
    cam_pos: jnp.ndarray    # (C, N, 3)
    cam_quat: jnp.ndarray   # (C, N, 4)
    points: jnp.ndarray     # (C, N, P, 3)
    mask: jnp.ndarray       # (C, N, P)
    stamp: jnp.ndarray      # (C, N) f32, -inf = empty slot
    head: jnp.ndarray       # (C,) int32 next write slot


def init_depth_buffer(n_cameras: int, depth: int, max_points: int
                      ) -> DepthCameraBuffer:
    return DepthCameraBuffer(
        cam_pos=jnp.zeros((n_cameras, depth, 3)),
        cam_quat=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0, 1.0]),
                                  (n_cameras, depth, 4)),
        points=jnp.zeros((n_cameras, depth, max_points, 3)),
        mask=jnp.zeros((n_cameras, depth, max_points), bool),
        stamp=jnp.full((n_cameras, depth), -jnp.inf),
        head=jnp.zeros((n_cameras,), jnp.int32))


def push_observation(buf: DepthCameraBuffer, cam_idx, cam_pos, cam_quat,
                     points, mask, stamp) -> DepthCameraBuffer:
    """bufferCloud: write one observation into camera ``cam_idx``'s ring
    (overwriting the oldest slot)."""
    slot = buf.head[cam_idx]
    return DepthCameraBuffer(
        cam_pos=buf.cam_pos.at[cam_idx, slot].set(cam_pos),
        cam_quat=buf.cam_quat.at[cam_idx, slot].set(cam_quat),
        points=buf.points.at[cam_idx, slot].set(points),
        mask=buf.mask.at[cam_idx, slot].set(mask),
        stamp=buf.stamp.at[cam_idx, slot].set(stamp),
        head=buf.head.at[cam_idx].set(
            (slot + 1) % buf.stamp.shape[1]))


def live_observations(buf: DepthCameraBuffer, now, keep_time: float):
    """(C, N) liveness after expiry (`purgeStaleObservations`:
    observations older than ``observation_keep_time`` drop out)."""
    return jnp.isfinite(buf.stamp) & (now - buf.stamp <= keep_time)


def buffer_as_observations(buf: DepthCameraBuffer, now, keep_time: float):
    """Flatten the (C, N) ring into a leading observation axis for
    :func:`clear_with_frustums` / :func:`mark_depth_points`, with expired
    slots masked out."""
    live = live_observations(buf, now, keep_time)     # (C, N)
    c, n, p, _ = buf.points.shape
    obs = DepthCameraObservation(
        cam_pos=buf.cam_pos.reshape(c * n, 3),
        cam_quat=buf.cam_quat.reshape(c * n, 4),
        points=buf.points.reshape(c * n, p, 3),
        mask=buf.mask.reshape(c * n, p) & live.reshape(c * n)[:, None])
    return obs, live.reshape(c * n)


def latest_live_observations(buf: DepthCameraBuffer, now, keep_time: float
                             ) -> DepthCameraObservation:
    """The most recent LIVE slot per camera (marking uses only the
    freshest frame; clearing uses every live frustum). Cameras with no
    live slot come back fully masked."""
    live = live_observations(buf, now, keep_time)       # (C, N)
    stamp = jnp.where(live, buf.stamp, -jnp.inf)
    newest = jnp.argmax(stamp, axis=1)                  # (C,)
    cams = jnp.arange(buf.stamp.shape[0])
    return DepthCameraObservation(
        cam_pos=buf.cam_pos[cams, newest],
        cam_quat=buf.cam_quat[cams, newest],
        points=buf.points[cams, newest],
        mask=buf.mask[cams, newest] & jnp.any(live, axis=1)[:, None])


def depth_layer_update(spec: VoxelSpec, params, cam: CameraModel, marking,
                       buf: DepthCameraBuffer, now, keep_time: float,
                       map_ctx, robot_pos, robot_quat):
    """One DepthCameraLayer tick on its own marking grid
    (`depth_camera_layer.cpp:226-620`): clear marked voxels against ALL
    live buffered frustums, mark from the LATEST observation per camera,
    recompute the layer dGraph. Shared by the host session and the fused
    device program. Returns the updated MarkingState-like pytree."""
    from dddmr_navigation_tpu.perception.marking import update_dgraph
    from dddmr_navigation_tpu.perception.voxel import (
        window_origin_for, scroll_grid)
    origin = window_origin_for(spec, robot_pos)
    grid = scroll_grid(marking.grid, marking.origin, origin)
    all_obs, all_live = buffer_as_observations(buf, now, keep_time)
    latest = latest_live_observations(buf, now, keep_time)
    grid = clear_with_frustums(spec, cam, grid, origin,
                               all_obs, live=all_live)
    grid = mark_depth_points(spec, grid, origin, latest,
                             robot_pos[2], params.marking_height)
    dgraph = update_dgraph(spec, params, grid, origin,
                           marking.dgraph, map_ctx, robot_pos, robot_quat)
    return marking._replace(grid=grid, origin=origin, dgraph=dgraph), latest


def clear_with_frustums(spec: VoxelSpec, cam: CameraModel, grid, origin,
                        observations: DepthCameraObservation,
                        range_margin: float = 0.1,
                        attach_dist: float = 0.2,
                        live=None):
    """selfClear (`depth_camera_layer.cpp:226-456`): a marked voxel inside
    any LIVE observation's frustum is cleared unless that observation's
    depth cloud blocks the line of sight (range-image test) or the voxel
    is ATTACHED to the cloud — within ``attach_dist`` of any depth point
    in 3D, the reference's `FrustumUtils::isAttachFRUSTUMs` re-observation
    test (`frustum_utils.cpp:219-291`). Observations carry a leading
    observation axis (cameras × buffered frames via
    :func:`buffer_as_observations`); ``live`` masks expired slots."""
    from dddmr_navigation_tpu.perception.marking import _window_cell_positions

    pos = _window_cell_positions(spec, origin)      # (Nx,Ny,Nz,3)
    flat = pos.reshape(-1, 3)

    def per_camera(cam_pos, cam_quat, pts, mask):
        normals, ppts = frustum_planes(cam, cam_pos, cam_quat)
        inside = in_frustum(normals, ppts, flat)
        # camera-frame ranges of voxels and depth points
        d_vox = quat_inverse_rotate(cam_quat[None, :], flat - cam_pos)
        r_vox = jnp.linalg.norm(d_vox, axis=-1)
        d_pts = quat_inverse_rotate(cam_quat[None, :], pts - cam_pos)
        r_pts = jnp.linalg.norm(d_pts, axis=-1)
        # angular bins (azimuth/elevation in camera frame)
        def bins(d):
            az = jnp.arctan2(d[..., 1], d[..., 0])
            el = jnp.arctan2(d[..., 2],
                             jnp.linalg.norm(d[..., :2], axis=-1))
            bi = jnp.floor((az + cam.h_fov / 2) / cam.h_fov * 32)
            bj = jnp.floor((el + cam.v_fov / 2) / cam.v_fov * 24)
            return (jnp.clip(bi, 0, 31).astype(jnp.int32) * 24
                    + jnp.clip(bj, 0, 23).astype(jnp.int32))
        img = jnp.full((32 * 24,), jnp.inf, jnp.float32).at[
            jnp.where(mask, bins(d_pts), 32 * 24 - 1)].min(
            jnp.where(mask, r_pts, jnp.inf))
        seen_r = img[bins(d_vox)]
        blocked = jnp.isfinite(seen_r) & (seen_r < r_vox - range_margin)
        # attach test: 3D proximity to any depth point re-observes the
        # voxel (empty angular bins carry no evidence either way, so the
        # binned image is only used for the in-front occlusion test)
        d2 = jnp.sum((flat[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(mask[None, :], d2, jnp.inf)
        attached = jnp.min(d2, axis=1) <= attach_dist ** 2
        return inside, blocked | attached

    inside_any, keep_any = jax.vmap(per_camera)(
        observations.cam_pos, observations.cam_quat,
        observations.points, observations.mask)
    if live is not None:
        inside_any = inside_any & live[:, None]
    inside = jnp.any(inside_any, axis=0)
    keep = jnp.any(inside_any & keep_any, axis=0)
    cleared = inside & ~keep
    return (grid.reshape(-1).astype(bool) & ~cleared).astype(
        jnp.uint8).reshape(grid.shape)


def mark_depth_points(spec: VoxelSpec, grid, origin,
                      observations: DepthCameraObservation,
                      robot_z, marking_height: float):
    """selfMark (`depth_camera_layer.cpp:458-620`): voxelize all buffered
    world-frame depth points within the marking band."""
    pts = observations.points.reshape(-1, 3)
    ok = observations.mask.reshape(-1)
    rel_z = pts[:, 2] - robot_z
    cells = world_to_cell(spec, pts)
    local = cells - origin[None, :]
    ok = ok & in_window(spec, local) & (rel_z >= 0.0) & (rel_z <= marking_height)
    local = jnp.clip(local, 0,
                     jnp.asarray([spec.nx - 1, spec.ny - 1, spec.nz - 1]))
    add = jnp.zeros(grid.shape, bool).at[
        local[:, 0], local[:, 1], local[:, 2]].max(ok)
    return jnp.maximum(grid, add.astype(jnp.uint8))
