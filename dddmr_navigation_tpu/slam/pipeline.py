"""Mapping session — the JAX re-design of lego_loam's node pipeline
(`lego_loam_node.cpp:19-41`: ImageProjection ─Channel→ FeatureAssociation
─Channel→ MapOptimization).

The reference moves clouds between three threads through blocking
channels; here the per-scan device work (projection → features →
scan matching) is one jitted program and the host driver only sequences
keyframes, loop closures, and pose-graph re-optimization (the
inherently-sequential parts). Artifacts save in the reference's
pose-graph directory format so `state_estimation.submaps` (and the
reference's own mcl_3dl) can localize against them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.config import SlamConfig
from dddmr_navigation_tpu.geometry import (
    quat_multiply, quat_conjugate, quat_normalize, quat_rotate,
    rpy_from_quat)
from dddmr_navigation_tpu.slam.projection import project
from dddmr_navigation_tpu.slam.features import extract_features, FeatureSet
from dddmr_navigation_tpu.slam.scan_matching import (
    match_scans, match_to_map, icp_point2point)
from dddmr_navigation_tpu.slam import pose_graph as pg
from dddmr_navigation_tpu.state_estimation.submaps import (
    PoseGraph, write_pose_graph)


@partial(jax.jit, static_argnums=(0,))
def _frontend(cfg: SlamConfig, points, mask) -> FeatureSet:
    """Projection + feature extraction, one device program per scan."""
    img = project(cfg, points, mask)
    return extract_features(cfg, img)


@partial(jax.jit, static_argnums=(0,))
def _odometry(cfg: SlamConfig, feats: FeatureSet, ref: FeatureSet,
              init_pos, init_quat):
    """Scan-to-keyframe matching (the reference's scan-to-scan GN +
    scan-to-map LM collapse into one matcher against the reference
    keyframe's features — parity target is the pose output).

    Plane sources are the decimated less-flat set (walls + ground), as in
    the reference's scan-to-map stage (`mapOptimization.cpp:1519`:
    `surfTotalLast` = less-flat): ground-only flat features leave x/y
    constrained solely by corner lines, whose picks are
    azimuth-quantization-jittered — wall planes pin translation cleanly.
    """
    return match_scans(
        cfg, feats.sharp, feats.sharp_mask,
        feats.less_flat[::4], feats.less_flat_mask[::4],
        ref.less_sharp, ref.less_sharp_mask, ref.less_flat,
        ref.less_flat_mask, init_pos=init_pos, init_quat=init_quat,
        tgt_less_sharp_ring=ref.less_sharp_ring,
        tgt_less_flat_ring=ref.less_flat_ring)


@partial(jax.jit, static_argnums=(0,))
def _map_refine(cfg: SlamConfig, feats: FeatureSet, sub_sharp, sub_sharp_m,
                sub_flat, sub_flat_m, init_pos, init_quat):
    """Scan-to-map refinement against the accumulated surrounding-keyframe
    submap (`mapOptimization.cpp:1407-1780` scan2MapOptimization): the
    current scan's corners/surfs match the map-frame submap with the
    reference's validated 5-NN eigen-line/lstsq-plane fits. The initial
    guess is the scan-to-keyframe odometry pose
    (`transformAssociateToMap`)."""
    return match_to_map(
        cfg, feats.sharp, feats.sharp_mask,
        feats.less_flat[::4], feats.less_flat_mask[::4],
        sub_sharp, sub_sharp_m, sub_flat, sub_flat_m,
        init_pos=init_pos, init_quat=init_quat, iters=cfg.map_match_iters)


@dataclass
class MappingSession:
    """Host-side SLAM driver (feed scans → keyframes → pose graph)."""
    cfg: SlamConfig = field(default_factory=SlamConfig)
    # pose of the latest scan w.r.t. map
    cur_pos: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    cur_quat: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    keyframe_feats: list = field(default_factory=list)   # FeatureSet per kf
    # per-keyframe PATCHED ground + ground-edge clouds (sensor frame) —
    # the reference's `patchedGroundKeyFrames`/`patchedGroundEdgeKeyFrames`
    # the saved ground.pcd is stitched from (`mapOptimization.cpp:211-217`)
    keyframe_ground: list = field(default_factory=list)
    keyframe_ground_edge: list = field(default_factory=list)
    n_keyframes: int = 0
    n_edges: int = 0
    graph: pg.PoseGraphArrays | None = None
    loop_closures: list = field(default_factory=list)
    paused: bool = False
    _submap: tuple | None = None

    def __post_init__(self):
        self.graph = pg.empty_graph(self.cfg.max_keyframes,
                                    self.cfg.max_edges)

    # -- surrounding-keyframe submap (`extractSurroundingKeyFrames`,
    # `mapOptimization.cpp:1192-1230`: recent-N keyframe queue in map frame)
    def _rebuild_submap(self):
        n_take = self.cfg.surrounding_keyframe_search_num
        if n_take <= 1 or self.n_keyframes == 0:
            self._submap = None
            return
        from dddmr_navigation_tpu.io.maps import voxel_downsample
        first = max(0, self.n_keyframes - n_take)
        sharp_all, flat_all = [], []
        for i in range(first, self.n_keyframes):
            p, q = self._kf_pose(i)
            f = self.keyframe_feats[i]
            qj = jnp.asarray(q)

            def to_map(pts, mask):
                sel = np.asarray(pts)[np.asarray(mask)]
                if not len(sel):
                    return sel
                return np.asarray(quat_rotate(qj[None, :],
                                              jnp.asarray(sel))) + p[None, :]

            sharp_all.append(to_map(f.less_sharp, f.less_sharp_mask))
            flat_all.append(to_map(f.less_flat, f.less_flat_mask))
        sharp = np.concatenate([s for s in sharp_all if len(s)]) \
            if any(len(s) for s in sharp_all) else np.zeros((0, 3), np.float32)
        flat = np.concatenate([s for s in flat_all if len(s)]) \
            if any(len(s) for s in flat_all) else np.zeros((0, 3), np.float32)
        sharp = voxel_downsample(sharp, self.cfg.submap_corner_leaf)
        flat = voxel_downsample(flat, self.cfg.submap_surf_leaf)

        def pad(pts, n):
            if len(pts) > n:
                stride = int(np.ceil(len(pts) / n))
                pts = pts[::stride][:n]
            out = np.full((n, 3), 1e6, np.float32)
            out[:len(pts)] = pts
            m = np.zeros((n,), bool)
            m[:len(pts)] = True
            return jnp.asarray(out), jnp.asarray(m)

        ss, sm = pad(sharp, self.cfg.submap_sharp_pad)
        fs, fm = pad(flat, self.cfg.submap_flat_pad)
        self._submap = (ss, sm, fs, fm)

    # -- helpers ----------------------------------------------------------
    def _kf_pose(self, i):
        return (np.asarray(self.graph.pos[i]), np.asarray(self.graph.quat[i]))

    def _rel(self, pi, qi, pj, qj):
        qi_inv = quat_conjugate(jnp.asarray(qi))
        rel_q = quat_normalize(quat_multiply(qi_inv, jnp.asarray(qj)))
        rel_p = quat_rotate(qi_inv, jnp.asarray(pj) - jnp.asarray(pi))
        return np.asarray(rel_p), np.asarray(rel_q)

    # -- main entry ---------------------------------------------------------
    def pause(self):
        """Mapping panel 'pause' (`mapping_panel.cpp:88-106`): scans are
        ignored until :meth:`resume`; the pose and graph hold still."""
        self.paused = True

    def resume(self):
        self.paused = False

    def process_scan(self, points, mask):
        """Feed one sweep (sensor frame). Returns the current map pose."""
        if self.paused:
            return self.cur_pos, self.cur_quat
        feats = _frontend(self.cfg, jnp.asarray(points), jnp.asarray(mask))

        if self.n_keyframes == 0:
            self._add_keyframe(feats, scan=(points, mask))
            return self.cur_pos, self.cur_quat

        ref_i = self.n_keyframes - 1
        ref_pos, ref_quat = self._kf_pose(ref_i)
        init_p, init_q = self._rel(ref_pos, ref_quat,
                                   self.cur_pos, self.cur_quat)
        rel_pos, rel_quat, _ = _odometry(
            self.cfg, feats, self.keyframe_feats[ref_i],
            jnp.asarray(init_p), jnp.asarray(init_q))
        # compose: T_map_cur = T_map_kf · T_kf_cur
        self.cur_quat = np.asarray(quat_normalize(
            quat_multiply(jnp.asarray(ref_quat), rel_quat)))
        self.cur_pos = ref_pos + np.asarray(
            quat_rotate(jnp.asarray(ref_quat), rel_pos))

        # scan-to-map refinement vs the accumulated submap
        # (`scan2MapOptimization`): corrects the drift scan-to-single-
        # keyframe matching accumulates between loop closures
        if self._submap is not None:
            mpos, mquat, _ = _map_refine(
                self.cfg, feats, *self._submap,
                jnp.asarray(self.cur_pos), jnp.asarray(self.cur_quat))
            self.cur_pos = np.asarray(mpos)
            self.cur_quat = np.asarray(mquat)

        if self._keyframe_due(ref_pos, ref_quat):
            self._add_keyframe(feats, parent=ref_i, scan=(points, mask))
            if self.cfg.enable_loop_closure:
                self._try_loop_closure()
        return self.cur_pos, self.cur_quat

    def _keyframe_due(self, ref_pos, ref_quat):
        """`saveKeyFramesAndFactor` gate: 1 m / 1 rad from last keyframe
        (`distance_between_key_frame` / `angle_between_key_frame`)."""
        d = float(np.linalg.norm(self.cur_pos - ref_pos))
        qrel = quat_multiply(quat_conjugate(jnp.asarray(ref_quat)),
                             jnp.asarray(self.cur_quat))
        a = float(2.0 * np.arccos(np.clip(abs(float(qrel[3])), 0, 1)))
        return (d > self.cfg.distance_between_key_frame
                or a > self.cfg.angle_between_key_frame)

    def _add_keyframe(self, feats, parent: int | None = None, scan=None):
        i = self.n_keyframes
        assert i < self.cfg.max_keyframes, "max_keyframes exceeded"
        self.graph = pg.add_node(self.graph, i, jnp.asarray(self.cur_pos),
                                 jnp.asarray(self.cur_quat))
        self.keyframe_feats.append(jax.device_get(feats))
        if scan is not None:
            # patched-ground keyframe processing (`imageProjection.cpp:
            # 408-516`): the cloud the saved ground.pcd stitches from
            from dddmr_navigation_tpu.slam.projection import (
                patched_ground_points)
            img = jax.device_get(project(self.cfg, jnp.asarray(scan[0]),
                                         jnp.asarray(scan[1])))
            gpts, epts = patched_ground_points(
                self.cfg, img.pts, img.valid, img.ground,
                first_frame=(i == 0))
            self.keyframe_ground.append(gpts)
            self.keyframe_ground_edge.append(epts)
        else:
            self.keyframe_ground.append(None)
            self.keyframe_ground_edge.append(None)
        self.n_keyframes += 1
        if parent is not None:
            pp, pq = self._kf_pose(parent)
            rel_p, rel_q = self._rel(pp, pq, self.cur_pos, self.cur_quat)
            self.graph = pg.add_edge(self.graph, self.n_edges, parent, i,
                                     jnp.asarray(rel_p), jnp.asarray(rel_q),
                                     weight=1.0)
            self.n_edges += 1
        self._rebuild_submap()

    def _try_loop_closure(self):
        cur = self.n_keyframes - 1
        cand, found = pg.detect_loop_candidate(
            self.graph, cur, self.cfg.history_keyframe_search_radius,
            min_index_gap=int(self.cfg.history_keyframe_search_radius))
        if not bool(found):
            return False
        cand = int(cand)
        # verify with ICP between the less-flat clouds in candidate frame
        cf = self.keyframe_feats[cur]
        hf = self.keyframe_feats[cand]
        pp, pq = self._kf_pose(cand)
        init_p, init_q = self._rel(pp, pq, self.cur_pos, self.cur_quat)
        pos, quat, fitness = icp_point2point(
            jnp.asarray(np.concatenate([cf.less_flat, cf.less_sharp])),
            jnp.asarray(np.concatenate([cf.less_flat_mask,
                                        cf.less_sharp_mask])),
            jnp.asarray(np.concatenate([hf.less_flat, hf.less_sharp])),
            jnp.asarray(np.concatenate([hf.less_flat_mask,
                                        hf.less_sharp_mask])),
            self.cfg.icp_iters, 2.0, jnp.asarray(init_p),
            jnp.asarray(init_q))
        if float(fitness) > self.cfg.history_keyframe_fitness_score:
            return False
        w = 1.0 / max(float(fitness), 1e-3)
        self.graph = pg.add_edge(self.graph, self.n_edges, cand, cur,
                                 pos, quat, weight=min(w, 100.0))
        self.n_edges += 1
        self.loop_closures.append((cand, cur, float(fitness)))
        self.graph = pg.optimize_pose_graph(self.graph,
                                            self.cfg.pose_graph_iters)
        # correctPoses: current pose follows the corrected keyframe, and
        # the submap is rebuilt from the corrected poses
        self.cur_pos, self.cur_quat = self._kf_pose(cur)
        self._rebuild_submap()
        return True

    def manual_loop(self, i: int, j: int, max_corr: float = 2.0,
                    fitness_gate: float | None = None):
        """Interactive IN-MAPPING pose-graph edit: run ICP between two
        chosen keyframes, add the verified loop edge, and batch
        re-optimize — the reference's interactive editor triggers exactly
        this between rviz-selected keyframes during mapping
        (`interactive_pose_graph_editor.cpp:1-432`; the offline analogue
        lives in `slam/editor.py`).

        Args:
          i: anchor (earlier) keyframe index.
          j: keyframe to close against (``i < j < n_keyframes``).
          fitness_gate: accept threshold; defaults to the config's
            ``history_keyframe_fitness_score``.
        Returns (accepted, fitness)."""
        assert 0 <= i < j < self.n_keyframes, (i, j, self.n_keyframes)
        gate = (self.cfg.history_keyframe_fitness_score
                if fitness_gate is None else fitness_gate)
        cf = self.keyframe_feats[j]
        hf = self.keyframe_feats[i]
        pp, pq = self._kf_pose(i)
        jp, jq = self._kf_pose(j)
        init_p, init_q = self._rel(pp, pq, jp, jq)
        pos, quat, fitness = icp_point2point(
            jnp.asarray(np.concatenate([cf.less_flat, cf.less_sharp])),
            jnp.asarray(np.concatenate([cf.less_flat_mask,
                                        cf.less_sharp_mask])),
            jnp.asarray(np.concatenate([hf.less_flat, hf.less_sharp])),
            jnp.asarray(np.concatenate([hf.less_flat_mask,
                                        hf.less_sharp_mask])),
            self.cfg.icp_iters, max_corr, jnp.asarray(init_p),
            jnp.asarray(init_q))
        if float(fitness) > gate:
            return False, float(fitness)
        w = 1.0 / max(float(fitness), 1e-3)
        self.graph = pg.add_edge(self.graph, self.n_edges, i, j,
                                 pos, quat, weight=min(w, 100.0))
        self.n_edges += 1
        self.loop_closures.append((i, j, float(fitness)))
        self.graph = pg.optimize_pose_graph(self.graph,
                                            self.cfg.pose_graph_iters)
        # correctPoses semantics: the live pose follows the latest
        # corrected keyframe and the submap is rebuilt
        self.cur_pos, self.cur_quat = self._kf_pose(self.n_keyframes - 1)
        self._rebuild_submap()
        return True, float(fitness)

    # -- artifacts ----------------------------------------------------------
    def save(self, out_dir: str):
        """Write the reference pose-graph directory format."""
        k = self.n_keyframes
        poses = np.zeros((k, 8), np.float32)
        feats, grounds = [], []
        for i in range(k):
            p, q = self._kf_pose(i)
            r, pch, y = (float(x) for x in rpy_from_quat(jnp.asarray(q)))
            poses[i, :3] = p
            poses[i, 4:7] = (r, pch, y)
            f = self.keyframe_feats[i]
            lf = np.asarray(f.less_flat)
            lfm = np.asarray(f.less_flat_mask)
            lfg = np.asarray(f.less_flat_ground)
            # pcdSaver split (`mapOptimization.cpp:191-217,277-293`):
            # {i}_feature.pcd = CORNER features only (cornerCloudKeyFrames
            # — the surf terms are commented out in the reference's map
            # stitch), {i}_ground.pcd = the PATCHED ground keyframe cloud
            # (between-ring interpolation + blind-circle fill,
            # patchedGroundKeyFrames). Keyframes recorded without a raw
            # scan fall back to the feature-mask approximation
            # (ground-flagged less-flat picks).
            feats.append(
                np.asarray(f.less_sharp)[np.asarray(f.less_sharp_mask)])
            pg_cloud = (self.keyframe_ground[i]
                        if i < len(self.keyframe_ground) else None)
            grounds.append(pg_cloud if pg_cloud is not None
                           and len(pg_cloud) else lf[lfm & lfg])
        write_pose_graph(out_dir, PoseGraph(
            poses=poses, feature_clouds=feats, ground_clouds=grounds))
