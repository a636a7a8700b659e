"""Batched wavefront shortest-path over the ground graph.

Replaces `A_Star_on_Graph::getPath` (`a_star_on_pc.cpp:200-329`) — a
sequential best-first expansion with per-pop radius searches — with
**Bellman–Ford-style parallel relaxation** on the precomputed (G, K)
neighbor table: every iteration relaxes all nodes at once (one gather +
min-reduce, elementwise), converging in O(path-diameter) iterations. The
composite edge cost reproduces `a_star_on_pc.cpp:278-288`:

  g += step_dist + exp(-inflation_descending_rate · (dGraph - inscribed))
       + node_weight + avg_intensity   [+ θ·turning_weight — see note]

with the lethal prune ``dGraph < inscribed_radius``
(`a_star_on_pc.cpp:263-266`). The parent-angle turning term θ·w_turn
(`:284-287`) depends on the expansion *tree*, which a plain
label-correcting relaxation doesn't maintain — so for w_turn > 0 the
state space is expanded over incoming-direction bins
(:func:`wavefront_distances_turning`), carrying the term exactly (up to
bin quantization); extraction then scores successors with the exact
reference θ (quirks included, :func:`theta_reference`). Parity evidence:
`tests/test_dwa_planner.py::test_turning_term_parity_against_full_astar`
holds extracted-path cost within 5% of a reference-faithful A* optimum
even at w_turn = 1.0 (and exact at w_turn = 0).

Distances are computed **from the goal** so one relaxation serves every
start (and every robot sharing the map) — path extraction is then greedy
descent, batched over starts.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class WavefrontResult(NamedTuple):
    dist: jnp.ndarray        # (G,) cost-to-goal
    reachable: jnp.ndarray   # (G,) bool
    iters: jnp.ndarray       # () int32 iterations run


def node_costs(dgraph, node_weight, *, inscribed_radius,
               inflation_descending_rate):
    """Cost of *entering* a node — the dGraph inflation factor plus the
    static node weight (`a_star_on_pc.cpp:278-288`: both are evaluated on
    the expanded successor). Lethal nodes (dGraph < inscribed) are +inf
    (`:263-266`). The avg-intensity term is a property of the expansion
    *source* and is added separately in the relaxation."""
    factor = jnp.exp(-inflation_descending_rate * (dgraph - inscribed_radius))
    cost = factor + node_weight
    lethal = dgraph < inscribed_radius
    return jnp.where(lethal, jnp.inf, cost)


def edge_azimuth(positions, nbr_idx):
    """(G, K) XY azimuth of each edge u→v."""
    safe = jnp.maximum(nbr_idx, 0)
    d = positions[safe] - positions[:, None, :]
    return jnp.arctan2(d[..., 1], d[..., 0])


def _wrap_angle(a):
    return jnp.mod(a + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def _theta_capped(theta_abs):
    """The reference's turning angle with its ≤0.345 rad dead zone
    (`a_star_on_pc.cpp:163-164`)."""
    return jnp.where(theta_abs <= 0.345, 0.0, theta_abs)


def theta_reference(p_parent, p_cur, p_exp):
    """`getThetaFromParent2Expanding` (`a_star_on_pc.cpp:142-166`) in jnp,
    quirks included: zero for vanishing XY vectors, zero when the |x|
    components agree within 1e-4, dead zone ≤ 0.345 rad. Broadcasts over
    leading dims of ``p_exp``."""
    v1 = (p_cur - p_parent)[..., :2]
    v2 = (p_exp - p_cur)[..., :2]
    n1 = jnp.linalg.norm(v1, axis=-1)
    n2 = jnp.linalg.norm(v2, axis=-1)
    cos_t = jnp.sum(v1 * v2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
    theta = jnp.arccos(jnp.clip(cos_t, -1.0, 1.0))
    zero = ((n1 == 0.0) | (n2 == 0.0)
            | (jnp.abs(jnp.abs(v1[..., 0]) - jnp.abs(v2[..., 0])) <= 1e-4))
    theta = jnp.where(zero, 0.0, theta)
    return _theta_capped(theta)


def turning_penalty_table(nbr_idx, positions, turning_weight: float):
    """(G, K, K) static table: w_turn·θ for every (arrival edge u→v,
    out-edge v→w) pair, exact reference θ (`theta_reference`) from the
    actual parent. Pure map geometry — compute ONCE at map build and
    reuse every tick instead of re-gathering the (G,K,K) position triples
    per tick (chosen before the port to the H100; not re-measured
    there)."""
    safe_idx = jnp.maximum(nbr_idx, 0)
    pos_u = positions[:, None, None, :]                    # (G,1,1,3)
    pos_v = positions[safe_idx][:, :, None, :]             # (G,K,1,3)
    pos_w = positions[safe_idx][safe_idx]                  # (G,K,K,3)
    return turning_weight * theta_reference(pos_u, pos_v, pos_w)


def wavefront_distances_turning(nbr_idx, nbr_dist, nbr_valid, enter_cost,
                                avg_intensity, goal_idx, positions,
                                turning_weight: float, *,
                                n_dir_bins: int = 16,
                                max_iters: int = 512, dist0=None,
                                az=None, bin_of_edge=None):
    """Direction-expanded relaxation for ``turning_weight > 0``: the state
    is (node, incoming-direction bin), so the reference's parent-angle
    term θ·w_turn (`a_star_on_pc.cpp:284-288`) is carried EXACTLY inside
    the relaxation (up to the incoming-bin quantization of 2π/B; the
    outgoing leg uses the exact edge azimuth). One extra tensor axis is
    the data-parallel answer to a term that breaks plain label-correcting
    relaxation.

    ``dist0`` warm-starts the relaxation from a previous tick's field (see
    :func:`wavefront_distances` for the correctness argument); the
    fixpoint operator here is the plain Bellman update (no monotone
    clamp), so costs that ROSE since the warm field was computed are
    repaired, not frozen.

    Returns (dist (G, B) cost-to-goal given arrival bin, edge_bins (G, K),
    iters).
    """
    g, k = nbr_idx.shape
    b = n_dir_bins
    big = jnp.float32(jnp.inf)
    # az / bin_of_edge are pure map geometry — pass precomputed tables
    # (e.g. from FusedMap) to keep per-tick trig off the critical path
    if az is None:
        az = edge_azimuth(positions, nbr_idx)              # (G, K)
    if bin_of_edge is None:
        bin_of_edge = jnp.mod(
            jnp.floor((az + jnp.pi) / (2.0 * jnp.pi) * b).astype(jnp.int32),
            b)
    centers = -jnp.pi + (jnp.arange(b, dtype=jnp.float32) + 0.5) * (2.0 * jnp.pi / b)

    safe_idx = jnp.maximum(nbr_idx, 0)
    if dist0 is None:
        dist0 = jnp.full((g, b), big)
    dist0 = dist0.at[goal_idx, :].set(0.0)

    # The loop body row-gathers the full (B,) bin vector per edge (one
    # vectorized row instead of single elements) and selects the edge's
    # arrival bin with a {0, +inf} masked min — an elementwise reduction
    # that returns the bin's value EXACTLY (x + 0.0 == x), so the result
    # stays bit-identical to the take_along_axis formulation and the NumPy
    # parity oracle. The loop-invariant enter-cost gather is hoisted; the
    # remaining additions keep the original association order
    # (reassociating them drifts the relaxed field ~3e-3 over the real
    # map's ~300 iterations). The (G,K,B) bin_sel / dtheta tensors are
    # recomputed INSIDE the body from their (G,K) parents: at real-map
    # scale (27k nodes) two cached (G,K,B) f32 tensors are ~55 MB of
    # device-memory reads per iteration, while recomputing them is a
    # handful of elementwise ops on fusion-internal values. Row gathers
    # and recomputation were chosen before the port to the H100; not
    # re-measured there.
    enter_g = enter_cost[safe_idx]                         # (G, K), hoisted
    bins_iota = jnp.arange(b)

    def body(carry):
        dist, _, it = carry
        bin_sel = jnp.where(
            bin_of_edge[:, :, None] == bins_iota[None, None, :],
            0.0, big)                                      # (G, K, B)
        dtheta = _theta_capped(jnp.abs(_wrap_angle(
            az[:, :, None] - centers[None, None, :])))     # (G, K, B)
        nd = dist[safe_idx]                                # (G, K, B) rows
        nd_in = jnp.min(nd + bin_sel, axis=2)              # (G, K) bin select
        base = (nd_in + nbr_dist + enter_g
                + avg_intensity[:, None])                  # (G, K)
        base = jnp.where(nbr_valid, base, big)
        cand = base[:, :, None] + turning_weight * dtheta  # (G, K, B)
        # Plain Bellman operator (goal pinned): from an inf init this is
        # bit-identical to min(dist, ·) — see wavefront_distances — and
        # from a warm init it can RAISE stale-low values.
        new = jnp.min(cand, axis=1).at[goal_idx, :].set(0.0)
        changed = jnp.any(new != dist)
        return new, changed, it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_iters)

    dist, _, iters = lax.while_loop(
        cond, body, (dist0, jnp.asarray(True), jnp.asarray(0, jnp.int32)))
    return dist, bin_of_edge, iters


def wavefront_distances(nbr_idx, nbr_dist, nbr_valid, enter_cost, avg_intensity,
                        goal_idx, *, max_iters: int = 512,
                        dist0=None) -> WavefrontResult:
    """Cost-to-goal for every node by iterative relaxation.

    ``dist[u] = min_v dist[v] + step_uv + enter_cost[v] + avg_intensity[u]``
    — the start→goal edge (u→v) pays the successor's inflation/node terms
    and the source's neighborhood intensity, matching the reference A*
    (`a_star_on_pc.cpp:288`).

    Warm start: passing the previous tick's field as ``dist0`` re-converges
    in O(field-change) iterations instead of O(path-diameter). The body is
    the plain Bellman operator (no ``min(dist, ·)`` clamp) with the goal
    pinned at 0, so it is self-correcting in BOTH directions: costs that
    dropped propagate as usual, and stale-low values from costs that ROSE
    (a new obstacle) are raised toward the true fixpoint — each lap of the
    cheapest sustaining cycle adds at least its weight, so finite rises
    repair in (Δcost / min-cycle-weight) iterations. The one slow case is
    a region becoming fully unreachable (its values must rise without
    bound and the loop runs to ``max_iters``, after which extraction
    reports failure exactly as a cold solve would). From an inf init the
    operator is bit-identical, iteration by iteration, to the clamped
    form — cand ≤ dist always holds — so cold parity is unchanged.

    Args:
      nbr_idx/nbr_dist/nbr_valid: (G, K) padded neighbor table.
      enter_cost: (G,) per-node entry cost (inf = lethal).
      avg_intensity: (G,) per-source neighborhood intensity.
      goal_idx: () int32 goal node.
      max_iters: upper bound; the loop exits early at fixpoint.
      dist0: optional (G,) warm-start field (defaults to inf-init).
    """
    g = nbr_idx.shape[0]
    big = jnp.float32(jnp.inf)
    if dist0 is None:
        dist0 = jnp.full((g,), big)
    dist0 = dist0.at[goal_idx].set(0.0)
    safe_idx = jnp.maximum(nbr_idx, 0)
    enter_g = enter_cost[safe_idx]                       # (G, K), hoisted

    def body(carry):
        dist, _, it = carry
        # Lane-replicate so the neighbor lookup is a vectorized ROW gather
        # instead of single elements — same trick as the turning variant
        # above (chosen before the port to the H100; not re-measured).
        # The addition order matches the original formulation exactly so
        # the relaxed field stays bit-identical to the parity oracle.
        nd = jnp.broadcast_to(dist[:, None], (g, 8))[safe_idx][:, :, 0]
        cand = nd + nbr_dist + enter_g + avg_intensity[:, None]
        cand = jnp.where(nbr_valid, cand, big)
        new = jnp.min(cand, axis=1).at[goal_idx].set(0.0)
        changed = jnp.any(new != dist)
        return new, changed, it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_iters)

    dist, _, iters = lax.while_loop(
        cond, body, (dist0, jnp.asarray(True), jnp.asarray(0, jnp.int32)))
    return WavefrontResult(dist=dist, reachable=jnp.isfinite(dist), iters=iters)


def fleet_wavefront_distances_turning(nbr_idx, nbr_dist, nbr_valid_r,
                                      enter_cost_r, avg_intensity,
                                      goal_idx_r, turning_weight: float, *,
                                      az, bin_of_edge, n_dir_bins: int = 16,
                                      max_iters: int = 512, dist0_r=None):
    """Direction-expanded relaxation for a FLEET sharing one graph.

    A vmap of :func:`wavefront_distances_turning` makes each robot gather
    its own (G,K,B) neighbor rows — R separate gather passes per
    iteration, and the gather COUNT is what the relaxation paid for
    before the port to the H100 (not re-measured). Since every robot
    shares the same ``nbr_idx``, the fleet's
    fields can ride ONE gather in node-major layout: ``dist`` is
    (G, R, B) and ``dist.reshape(G, R·B)[safe_idx]`` fetches ALL robots'
    bin vectors for a neighbor in a single (R·B)-lane row — the gather
    count drops R-fold (64× at config-4 scale) while the update math
    stays the per-robot Bellman operator, element for element.

    Args mirror the single-robot version with a leading robot axis where
    per-robot: ``nbr_valid_r``/``enter_cost_r``/``goal_idx_r``/
    ``dist0_r`` are (R,G,K)/(R,G)/(R,)/(R,G,B).

    Returns (dist (R,G,B), iters ()). ``iters`` is the shared count (the
    vmapped form also runs every lane to the slowest robot's fixpoint).
    """
    g, k = nbr_idx.shape
    r = enter_cost_r.shape[0]
    b = n_dir_bins
    big = jnp.float32(jnp.inf)
    safe_idx = jnp.maximum(nbr_idx, 0)
    centers = -jnp.pi + (jnp.arange(b, dtype=jnp.float32) + 0.5) \
        * (2.0 * jnp.pi / b)
    bins_iota = jnp.arange(b)

    # node-major per-robot tensors, gathered/hoisted once
    enter_t = jnp.moveaxis(enter_cost_r, 0, 1)             # (G, R)
    enter_g = enter_t[safe_idx]                            # (G, K, R)
    valid_gkr = jnp.moveaxis(nbr_valid_r, 0, 2)            # (G, K, R)
    if dist0_r is None:
        dist0 = jnp.full((g, r, b), big)
    else:
        dist0 = jnp.moveaxis(dist0_r, 0, 1)                # (G, R, B)
    node_iota = jnp.arange(g)
    goal_mask = node_iota[:, None] == goal_idx_r[None, :]  # (G, R)
    dist0 = jnp.where(goal_mask[:, :, None], 0.0, dist0)

    def body(carry):
        dist, _, it = carry                                # (G, R, B)
        bin_sel = jnp.where(
            bin_of_edge[:, :, None] == bins_iota[None, None, :],
            0.0, big)                                      # (G, K, B)
        dtheta = _theta_capped(jnp.abs(_wrap_angle(
            az[:, :, None] - centers[None, None, :])))     # (G, K, B)
        nd = dist.reshape(g, r * b)[safe_idx].reshape(g, k, r, b)
        nd_in = jnp.min(nd + bin_sel[:, :, None, :], axis=3)   # (G, K, R)
        base = (nd_in + nbr_dist[:, :, None] + enter_g
                + avg_intensity[:, None, None])            # (G, K, R)
        base = jnp.where(valid_gkr, base, big)
        cand = base[:, :, :, None] \
            + turning_weight * dtheta[:, :, None, :]       # (G, K, R, B)
        new = jnp.min(cand, axis=1)                        # (G, R, B)
        new = jnp.where(goal_mask[:, :, None], 0.0, new)
        changed = jnp.any(new != dist)
        return new, changed, it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_iters)

    dist, _, iters = lax.while_loop(
        cond, body, (dist0, jnp.asarray(True), jnp.asarray(0, jnp.int32)))
    return jnp.moveaxis(dist, 0, 1), iters                 # (R, G, B)


def fleet_wavefront_distances(nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r,
                              avg_intensity, goal_idx_r, *,
                              max_iters: int = 512, dist0_r=None):
    """Plain (turning_weight == 0) fleet relaxation sharing one graph —
    the node-major one-gather-for-all-robots trick of
    :func:`fleet_wavefront_distances_turning` with the field as (G, R).

    Returns (dist (R, G), iters ())."""
    g, k = nbr_idx.shape
    r = enter_cost_r.shape[0]
    big = jnp.float32(jnp.inf)
    safe_idx = jnp.maximum(nbr_idx, 0)
    enter_t = jnp.moveaxis(enter_cost_r, 0, 1)             # (G, R)
    valid_gkr = jnp.moveaxis(nbr_valid_r, 0, 2)            # (G, K, R)
    dist0 = (jnp.full((g, r), big) if dist0_r is None
             else jnp.moveaxis(dist0_r, 0, 1))
    node_iota = jnp.arange(g)
    goal_mask = node_iota[:, None] == goal_idx_r[None, :]  # (G, R)
    dist0 = jnp.where(goal_mask, 0.0, dist0)

    # Potential transform: relax F = dist + enter instead of dist. The
    # update dist[u] = min_v (dist[v] + d_uv + enter[v]) + int[u] becomes
    # F[u] = min_v (F[v] + d_uv) + (int[u] + enter[u]) — the per-neighbor
    # enter gather (a (G, K, R) stream per iteration, ~1/3 of the loop's
    # device-memory traffic at 27k-node fleet scale) collapses into a per-node
    # constant added AFTER the min. One exact dist-space pass at the end
    # recovers dist for EVERY node — including lethal nodes (enter = inf)
    # where F is inf but dist itself is finite, which the warm-start
    # carry and the start-reachability check both rely on.
    c_node = enter_t + avg_intensity[:, None]              # (G, R)
    f0 = jnp.where(goal_mask, enter_t, dist0 + enter_t)

    def body(carry):
        f, _, it = carry                                   # (G, R)
        nf = f[safe_idx]                                   # (G, K, R)
        cand = jnp.where(valid_gkr, nf + nbr_dist[:, :, None], big)
        new = jnp.min(cand, axis=1) + c_node               # (G, R)
        new = jnp.where(goal_mask, enter_t, new)
        changed = jnp.any(new != f)
        return new, changed, it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_iters)

    f, _, iters = lax.while_loop(
        cond, body, (f0, jnp.asarray(True), jnp.asarray(0, jnp.int32)))
    # exact dist-space finish (the defining update, one pass)
    nf = f[safe_idx]
    cand = jnp.where(valid_gkr,
                     nf + nbr_dist[:, :, None]
                     + avg_intensity[:, None, None], big)
    dist = jnp.where(goal_mask, 0.0, jnp.min(cand, axis=1))
    return jnp.moveaxis(dist, 0, 1), iters                 # (R, G)


def _walk_table(succ, stuck, e0, stuck0, node_of, start_idx, goal_idx,
                      max_len: int):
    """The greedy-descent walk with a ONE-GATHER body and heavy unroll:
    the 512-step stepwise walk paid per-step op-LAUNCH overhead (its body
    issued ~6 small ops per iteration), not compute (chosen before the
    port to the H100; not re-measured there). Terminal states (stuck, or
    arriving at the goal) are first rewritten to SELF-LOOPS, which moves every per-step
    decision out of the loop: the body is a single (batched-robot) table
    gather, `unroll=32` amortizes the loop bookkeeping, and the
    valid/length/final bookkeeping is recovered VECTORIZED from the
    emitted state sequence afterwards. (A pointer-doubling variant —
    O(log L) squared jump tables — was rejected before the port to the
    H100: the per-robot (S,)[(S,)] squarings lower to batched middle-axis
    gathers, slower than the stepwise walk at fleet scale; not
    re-measured there.) Emitted
    (idxs, valids, length, final) are element-for-element identical to
    the stepwise form: validity is the prefix before the first terminal
    flag, and frozen slots re-emit the freeze node.

    Args:
      succ: (S,) int32 successor-state table.
      stuck: (S,) bool — states with no feasible continuation (their succ
        entries are meaningless).
      e0: () int32 initial state (after the start's first hop).
      stuck0: () bool — no feasible first hop from the start.
      node_of: (S,) int32 node emitted on arrival in each state.
      max_len: emitted path slots.
    """
    s = succ.shape[0]
    term = stuck | (node_of == goal_idx)
    succ2 = jnp.where(term, jnp.arange(s), succ)

    def step(e, _):
        return succ2[e], e

    _, es = lax.scan(step, e0.astype(jnp.int32), None, length=max_len - 1,
                     unroll=32)
    # es[t] = succ2^t(e0); node sequence: cur_0 = start,
    # cur_t = node_of[es[t-1]]
    idxs_raw = jnp.concatenate([jnp.asarray([start_idx], jnp.int32),
                                node_of[es[:max_len - 1]]])
    # terminal flags: F_0 = start==goal | stuck0;
    # F_t = cur_t==goal | stuck(e_{t-1})
    F = jnp.concatenate([
        jnp.asarray([(start_idx == goal_idx) | stuck0]),
        (idxs_raw[1:] == goal_idx) | stuck[es[:max_len - 1]]])
    done_before = jnp.concatenate([
        jnp.asarray([False]), jnp.cumsum(F.astype(jnp.int32))[:-1] > 0])
    valids = ~done_before
    length = jnp.sum(valids)
    stop = jnp.minimum(jnp.argmax(F), max_len - 1)
    has_f = jnp.any(F)
    final = jnp.where(has_f, idxs_raw[stop], idxs_raw[max_len - 1])
    idxs = jnp.where(valids, idxs_raw, final)     # stepwise freeze re-emit
    return idxs, valids, length, final


def extract_path_turning(nbr_idx, nbr_dist, nbr_valid, enter_cost, dist_gb,
                         bin_of_edge, start_idx, goal_idx, positions,
                         turning_weight: float, *, max_len: int = 512,
                         turn_pen=None):
    """Greedy descent over the direction-expanded field: each step scores
    successors with the EXACT reference turning angle from the actual
    parent (`theta_reference`) plus the remaining cost at the successor's
    arrival bin. Returns (indices, valid, length, ok).

    Structure: the greedy decision at a node depends only on the edge
    just traversed (parent, current) — so the whole decision function is a
    SUCCESSOR TABLE over the (G·K) edge states, built in one vectorized
    pass (the (G, K, K) candidate tensor scores every possible next hop of
    every possible arrival edge, exact reference θ included), and the
    inherently sequential walk collapses to one scalar table lookup per
    step (chosen before the port to the H100; not re-measured there).
    Decisions are identical to the stepwise
    form (same candidate formula, same argmin order). Memory: the build
    is O(G·K²) — fine per-robot; for vmapped fleets prefer
    turning_weight=0 (node-table path below)."""
    g, k = nbr_idx.shape
    safe_idx = jnp.maximum(nbr_idx, 0)
    big = jnp.float32(jnp.inf)

    # score_next[u, k'] = dist_gb[v', arrival-bin] + step + enter(v'):
    # the parent-independent part of the candidate formula, with edge
    # validity folded in as +inf (so the (G,K,K) gather below needs no
    # separate mask read). Bin selection uses the same {0, inf} masked-min
    # as the relaxation (bit-identical to take_along_axis, vectorized).
    nd_rows = dist_gb[safe_idx]                            # (G, K, B)
    b = dist_gb.shape[1]
    bin_sel = jnp.where(
        bin_of_edge[:, :, None] == jnp.arange(b)[None, None, :], 0.0, big)
    nd_in = jnp.min(nd_rows + bin_sel, axis=2)             # (G, K)
    score_next = nd_in + nbr_dist + enter_cost[safe_idx]   # (G, K)
    score_next = jnp.where(nbr_valid, score_next, big)

    # Edge-state successor table: edge e = u*K + k means "arrived at
    # v = nbr_idx[u,k] from u". Candidates for the next hop score
    # score_next[v, k'] + w_turn·θ(pos_u, pos_v, pos_w) — θ from the
    # ACTUAL parent, reference quirks included. The θ term is pure map
    # geometry; pass the precomputed table (`turning_penalty_table`) to
    # avoid re-gathering (G,K,K) position triples every tick.
    if turn_pen is None:
        turn_pen = turning_penalty_table(nbr_idx, positions, turning_weight)
    cand = score_next[safe_idx] + turn_pen                 # (G,K,K)
    kbest = jnp.argmin(cand, axis=2)                       # (G,K)
    succ_edge = (safe_idx * k + kbest).reshape(-1)         # (G*K,)
    edge_stuck = (~jnp.isfinite(jnp.min(cand, axis=2))).reshape(-1)
    edge_dst = safe_idx.reshape(-1)

    # First hop: prev == cur ⇒ θ = 0 for every candidate (the n1 == 0
    # quirk), so the start scores are plain score_next[start].
    cand0 = score_next[start_idx]
    e0 = (start_idx * k + jnp.argmin(cand0)).astype(jnp.int32)
    stuck0 = ~jnp.isfinite(jnp.min(cand0))

    idxs, valids, length, final = _walk_table(
        succ_edge.astype(jnp.int32), edge_stuck, e0, stuck0, edge_dst,
        start_idx, goal_idx, max_len)
    ok = jnp.isfinite(jnp.min(dist_gb[start_idx])) & (final == goal_idx)
    return idxs, valids, length, ok


def _fleet_walk_table(succ_rs, stuck_rs, e0_r, stuck0_r, node_of,
                      start_idx_r, goal_idx_r, max_len: int):
    """Fleet walk over per-robot successor tables with FLAT global state:
    a vmapped `_walk_table` makes each step's gather a batched
    middle-axis gather ((R,) picks from (R, S)), which lowered to a slow
    path before the port to the H100 (not re-measured there). With
    states flattened to robot-offset ids in ONE (R·S,) table, each step
    is a plain first-axis 1D gather of (R,) — the fast path. Semantics
    identical to `_walk_table` per robot.

    Args: ``succ_rs``/``stuck_rs`` are (S, R) state tables (node-major,
    as the fleet extractors build them), ``node_of`` (S,) shared,
    ``e0_r``/``stuck0_r``/``start_idx_r``/``goal_idx_r`` (R,).
    Returns (idxs (R, L), valids (R, L), length (R,), final (R,)).
    """
    s, r = succ_rs.shape
    term = stuck_rs | (node_of[:, None] == goal_idx_r[None, :])  # (S, R)
    succ2 = jnp.where(term, jnp.arange(s)[:, None], succ_rs)
    # flatten robot-major: flat id = robot * S + state
    flat_succ = (jnp.moveaxis(succ2, 1, 0)
                 + (jnp.arange(r) * s)[:, None]).reshape(-1)    # (R*S,)
    e0_flat = (jnp.arange(r) * s + e0_r).astype(jnp.int32)

    def step(e, _):
        return flat_succ[e], e

    _, es = lax.scan(step, e0_flat, None, length=max_len - 1, unroll=8)
    es_state = (es % s).astype(jnp.int32)                       # (L-1, R)

    idxs_raw = jnp.concatenate(
        [start_idx_r[None, :].astype(jnp.int32), node_of[es_state]], axis=0)
    stuck_flat = jnp.moveaxis(stuck_rs, 1, 0).reshape(-1)       # (R*S,)
    F = jnp.concatenate([
        ((start_idx_r == goal_idx_r) | stuck0_r)[None, :],
        (idxs_raw[1:] == goal_idx_r[None, :]) | stuck_flat[es]], axis=0)
    done_before = jnp.concatenate([
        jnp.zeros((1, r), bool),
        jnp.cumsum(F.astype(jnp.int32), axis=0)[:-1] > 0], axis=0)
    valids = ~done_before                                       # (L, R)
    length = jnp.sum(valids, axis=0)
    stop = jnp.minimum(jnp.argmax(F, axis=0), max_len - 1)      # (R,)
    has_f = jnp.any(F, axis=0)
    final_stop = jnp.take_along_axis(idxs_raw, stop[None, :], axis=0)[0]
    final = jnp.where(has_f, final_stop, idxs_raw[max_len - 1])
    idxs = jnp.where(valids, idxs_raw, final[None, :])
    return (jnp.moveaxis(idxs, 0, 1), jnp.moveaxis(valids, 0, 1),
            length, final)


def fleet_extract_path_turning(nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r,
                               dist_r, bin_of_edge, start_idx_r, goal_idx_r,
                               turn_pen, *, max_len: int = 512):
    """Fleet successor-table extraction in NODE-MAJOR layout: a vmap of
    :func:`extract_path_turning` makes `dist_gb[safe_idx]` and
    `score_next[safe_idx]` per-robot batched gathers, which XLA lowered to
    a slow middle-axis gather path before the port to the H100 (not
    re-measured there; the walk itself was not the cost). With the fields
    node-major — (G, R, B) / (G, K, R) — the same tables ride shared-index
    first-axis gathers like the fleet relaxation; only the (cheap) walks
    stay per-robot.

    Args are the per-robot tensors with a leading robot axis where
    per-robot: ``nbr_valid_r``/``enter_cost_r``/``dist_r``/``start_idx_r``/
    ``goal_idx_r`` are (R,G,K)/(R,G)/(R,G,B)/(R,)/(R,).

    Returns (idxs (R, L), valids (R, L), length (R,), ok (R,)).
    """
    g, k = nbr_idx.shape
    r = enter_cost_r.shape[0]
    b = dist_r.shape[2]
    big = jnp.float32(jnp.inf)
    safe_idx = jnp.maximum(nbr_idx, 0)

    dist_grb = jnp.moveaxis(dist_r, 0, 1)                    # (G, R, B)
    nd = dist_grb.reshape(g, r * b)[safe_idx].reshape(g, k, r, b)
    bin_sel = jnp.where(
        bin_of_edge[:, :, None] == jnp.arange(b)[None, None, :], 0.0, big)
    nd_in = jnp.min(nd + bin_sel[:, :, None, :], axis=3)     # (G, K, R)
    enter_g = jnp.moveaxis(enter_cost_r, 0, 1)[safe_idx]     # (G, K, R)
    score_next = nd_in + nbr_dist[:, :, None] + enter_g      # (G, K, R)
    score_next = jnp.where(jnp.moveaxis(nbr_valid_r, 0, 2), score_next, big)

    cand = score_next.reshape(g, k * r)[safe_idx] \
        .reshape(g, k, k, r) + turn_pen[:, :, :, None]       # (G, K, K, R)
    kbest = jnp.argmin(cand, axis=2)                         # (G, K, R)
    succ_edge = (safe_idx[:, :, None] * k + kbest) \
        .reshape(g * k, r)                                   # (G*K, R)
    edge_stuck = (~jnp.isfinite(jnp.min(cand, axis=2))) \
        .reshape(g * k, r)
    edge_dst = safe_idx.reshape(-1)                          # (G*K,) shared

    # first hop per robot: θ = 0 from the start (n1 == 0 quirk)
    cand0 = jnp.take_along_axis(
        jnp.moveaxis(score_next, 2, 0), start_idx_r[:, None, None],
        axis=1)[:, 0, :]                                     # (R, K)
    e0 = (start_idx_r * k + jnp.argmin(cand0, axis=1)).astype(jnp.int32)
    stuck0 = ~jnp.isfinite(jnp.min(cand0, axis=1))
    start_ok = jnp.isfinite(jnp.min(
        jnp.take_along_axis(jnp.moveaxis(dist_grb, 1, 0),
                            start_idx_r[:, None, None], axis=1)[:, 0, :],
        axis=1))

    idxs, valids, length, final = _fleet_walk_table(
        succ_edge, edge_stuck, e0, stuck0, edge_dst, start_idx_r,
        goal_idx_r, max_len)
    return idxs, valids, length, start_ok & (final == goal_idx_r)


def fleet_extract_path(nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r,
                       dist_r, start_idx_r, goal_idx_r, *,
                       max_len: int = 512):
    """Node-major fleet extraction for the plain (w_turn = 0) node-table
    field — see :func:`fleet_extract_path_turning`. ``dist_r`` is (R, G).

    Returns (idxs (R, L), valids (R, L), length (R,), ok (R,))."""
    g, k = nbr_idx.shape
    big = jnp.float32(jnp.inf)
    safe_idx = jnp.maximum(nbr_idx, 0)

    nd = jnp.moveaxis(dist_r, 0, 1)[safe_idx]                # (G, K, R)
    en = jnp.moveaxis(enter_cost_r, 0, 1)[safe_idx]          # (G, K, R)
    cand = jnp.where(jnp.moveaxis(nbr_valid_r, 0, 2),
                     nd + nbr_dist[:, :, None] + en, big)    # (G, K, R)
    kbest = jnp.argmin(cand, axis=1)                         # (G, R)
    succ = jnp.take_along_axis(
        safe_idx[:, :, None], kbest[:, None, :], axis=1)[:, 0, :]  # (G, R)
    node_stuck = ~jnp.isfinite(jnp.min(cand, axis=1))        # (G, R)

    start_dist = jnp.take_along_axis(dist_r, start_idx_r[:, None],
                                     axis=1)[:, 0]
    start_ok = jnp.isfinite(start_dist)

    e0_r = jnp.take_along_axis(succ, start_idx_r[None, :], axis=0)[0]
    stuck0_r = jnp.take_along_axis(node_stuck, start_idx_r[None, :],
                                   axis=0)[0]
    idxs, valids, length, final = _fleet_walk_table(
        succ, node_stuck, e0_r.astype(jnp.int32), stuck0_r,
        jnp.arange(g, dtype=jnp.int32), start_idx_r, goal_idx_r, max_len)
    return idxs, valids, length, start_ok & (final == goal_idx_r)


def extract_path(nbr_idx, nbr_dist, nbr_valid, enter_cost, dist, start_idx,
                 goal_idx, *, max_len: int = 512, turning_weight: float = 0.0,
                 positions=None):
    """Greedy descent start → goal over the relaxed distance field.

    At each node the successor minimizes ``dist[j] + step_ij`` (the edge
    we'd traverse); with ``turning_weight > 0`` and node positions given,
    near-ties are broken toward the straightest continuation, emulating
    the reference's θ·turning_weight term.

    Returns (indices (max_len,), valid (max_len,), length, ok).

    Structure (turning_weight == 0 path): the greedy decision is a pure
    per-node function, so the successor of EVERY node is computed in one
    vectorized argmin (a (G, K) candidate tensor) and the sequential walk
    is a scalar table lookup per step — same decisions as in-loop scoring
    (see extract_path_turning).
    """
    g = nbr_idx.shape[0]
    safe_idx = jnp.maximum(nbr_idx, 0)
    big = jnp.float32(jnp.inf)

    if positions is not None and turning_weight > 0.0:
        # parent-dependent tie-break variant (not used by plan_on_graph —
        # the direction-expanded extractor handles w_turn > 0): stepwise.
        def step(carry, _):
            cur, prev, done = carry
            nd = dist[safe_idx[cur]]
            cand = nd + nbr_dist[cur] + enter_cost[safe_idx[cur]]
            cand = jnp.where(nbr_valid[cur], cand, big)
            v_in = positions[cur] - positions[prev]
            v_out = positions[safe_idx[cur]] - positions[cur]
            norm_in = jnp.linalg.norm(v_in) + 1e-9
            norm_out = jnp.linalg.norm(v_out, axis=1) + 1e-9
            cosang = jnp.clip(
                jnp.sum(v_in[None, :] * v_out, axis=1) / (norm_in * norm_out),
                -1.0, 1.0)
            theta = jnp.arccos(cosang)
            has_prev = prev != cur
            cand = cand + jnp.where(has_prev, theta * turning_weight, 0.0)
            nxt = safe_idx[cur][jnp.argmin(cand)]
            at_goal = cur == goal_idx
            stuck = ~jnp.isfinite(jnp.min(cand))
            new_done = done | at_goal | stuck
            nxt = jnp.where(new_done, cur, nxt)
            return (nxt, jnp.where(new_done, prev, cur), new_done), \
                (cur, ~done)

        (final, _, done), (idxs, valids) = lax.scan(
            step, (start_idx, start_idx, jnp.asarray(False)), None,
            length=max_len)
        ok = jnp.isfinite(dist[start_idx]) & (final == goal_idx)
        return idxs, valids, jnp.sum(valids), ok

    # node-successor table, one vectorized pass (8-lane row-gather trick
    # for the per-neighbor dist/enter lookups, as in the relaxation)
    nd = jnp.broadcast_to(dist[:, None], (g, 8))[safe_idx][:, :, 0]
    en = jnp.broadcast_to(enter_cost[:, None], (g, 8))[safe_idx][:, :, 0]
    cand = jnp.where(nbr_valid, nd + nbr_dist + en, big)   # (G, K)
    kbest = jnp.argmin(cand, axis=1)
    succ = jnp.take_along_axis(safe_idx, kbest[:, None], axis=1)[:, 0]
    node_stuck = ~jnp.isfinite(jnp.min(cand, axis=1))

    # node-table walk: state = node, first "hop" is the start itself
    # (stuck0 folds into the start's own stuck flag; the pointer-doubling
    # walk then matches the stepwise emission element for element)
    idxs, valids, length, final = _walk_table(
        succ.astype(jnp.int32), node_stuck,
        succ[start_idx].astype(jnp.int32), node_stuck[start_idx],
        jnp.arange(g, dtype=jnp.int32), start_idx, goal_idx, max_len)
    ok = jnp.isfinite(dist[start_idx]) & (final == goal_idx)
    return idxs, valids, length, ok
