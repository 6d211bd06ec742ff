"""Distributed pose-graph optimization over a mesh axis (mirrors
``tinyslam_tpu/parallel/dist_pose_graph.py``).

Edge-sharded (``optimize_pose_graph_sharded``): as the trajectory grows,
the edge count E (odometry and loop closures) dominates the Jacobian and
assembly work while the node state stays small.  Each rank evaluates its
E/D edges and assembles its part of the (6N x 6N) normal equations; one
sum over the axis a Gauss-Newton iteration (``_pose_graph_core``'s
``preduce``) gives every rank the whole H and g, and the solve and the node
update run on every rank alike.

Node-sharded (``optimize_pose_graph_node_sharded``): the replicated dense
solve is what stops the edge-sharded solver from scaling, so here the
NODES are split into contiguous blocks of B = N/D and each rank solves an
overlapping-Schwarz window of W = B + 2 halo nodes around its own block:

- edges are bucketed to every rank whose WINDOW they touch (each window
  row then carries its complete global gradient, which restricted additive
  Schwarz needs); one rank is an edge's primary owner, so the sums over the
  axis count it once;
- fine sweeps alternate red/black block parity (adjacent windows updated
  together overcorrect shared modes and oscillate); after each, the
  boundary poses go to the ring neighbours (the JAX package's
  ``lax.ppermute``, here one ``all_gather`` of every rank's two boundary
  slices of ``halo`` x 12 floats, which works on NCCL and gloo and at one
  rank), and the whole pose state is gathered every ``sync_every`` sweeps;
- a coarse phase (one rigid 6-DoF correction per block, assembled by a sum
  over the axis, a (6D)^2 solve on every rank) precedes each red/black
  pair, so a loop closure's error crosses the trajectory in one step.

The exact optimum is a fixed point; the sharded solver converges to the
replicated one's, not step for step.  Where the JAX package takes
``jax.jacfwd`` of the residual, the Jacobians here are the closed-form
``backend/pose_graph.py:edge_jacobians``; where it zeroes a non-finite
step after ``jnp.linalg.cholesky``, ``cholesky_ex`` zeroes it where
``info != 0`` as well.  JAX's ``lax.scan``/``switch``/``cond`` are a
Python loop and ``if``: the offsets are Python ints of the rank.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyslam_tpu_torch.backend.pose_graph import (
    _pose_graph_core,
    assembly_plan,
    edge_jacobians,
    edge_residual,
    normal_equations,
)
from tinyslam_tpu_torch.geometry.se3 import se3_compose, se3_exp
from tinyslam_tpu_torch.parallel.mesh import axis_gather, axis_size, axis_sum


def optimize_pose_graph_sharded(mesh, R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
                                edge_weight=None, node_valid=None, iters: int = 20,
                                damping: float = 1e-6, axis: str = "landmark") -> dict:
    """``backend.pose_graph.optimize_pose_graph``'s contract and result (up
    to the order of the cross-shard sums), with the edges split over
    ``axis``.  Pad the edge set (edge_valid false) to a multiple of the axis
    size: invalid edges contribute zero."""
    D = axis_size(mesh, axis)
    E = edge_i.shape[0]
    if E % D:
        raise ValueError(f"optimize_pose_graph_sharded: E={E} does not divide by "
                         f"the {axis} axis ({D}); pad with invalid edges")
    if edge_weight is None:
        edge_weight = torch.ones(edge_i.shape, dtype=R.dtype, device=R.device)
    per = E // D
    d = mesh.get_local_rank(axis)
    s = slice(d * per, (d + 1) * per)
    return _pose_graph_core(R, t, edge_i[s], edge_j[s], edge_R[s], edge_t[s],
                            edge_valid[s], edge_weight[s], node_valid, iters=iters,
                            damping=damping, preduce=axis_sum(mesh, axis))


def partition_edges_by_node(edge_i, edge_j, n_nodes: int, n_shards: int, halo: int = 0):
    """Host-side edge bucketing: (sel, valid, primary) of shape (n_shards,
    E_max), where sel indexes the original edge arrays.  A shard's bucket
    holds every edge touching its WINDOW [d*B - halo, (d+1)*B + halo),
    clipped into the graph as the solver clips it, not just its own block:
    the window solve couples own rows with halo rows, so halo rows must
    carry their true global gradient and Hessian, every edge incident to a
    halo node (cross-shard edges are duplicated; each copy only ever updates
    its own side).  ``primary`` marks the copy in the shard of edge_i."""
    B = n_nodes // n_shards
    halo = min(halo, B)
    W = min(B + 2 * halo, n_nodes)
    ei = np.asarray(edge_i)
    ej = np.asarray(edge_j)
    buckets = []
    for d in range(n_shards):
        lo = int(np.clip(d * B - halo, 0, n_nodes - W))
        hi = lo + W
        touch = ((ei >= lo) & (ei < hi)) | ((ej >= lo) & (ej < hi))
        buckets.append(np.nonzero(touch)[0])
    e_max = max(max(len(b) for b in buckets), 1)
    sel = np.zeros((n_shards, e_max), np.int32)
    valid = np.zeros((n_shards, e_max), bool)
    primary = np.zeros((n_shards, e_max), bool)
    owner = np.clip(ei // B, 0, n_shards - 1)
    for d, b in enumerate(buckets):
        sel[d, : len(b)] = b
        valid[d, : len(b)] = True
        primary[d, : len(b)] = owner[b] == d
    return sel, valid, primary


def _damped_step(H, g, damping: float) -> torch.Tensor:
    """Pin blocks with no constraints (identity), damp the diagonal, solve
    by Cholesky; a step that is not finite or whose factor failed is zero.
    Returns (n_blocks, 6)."""
    pinned = H.diagonal().view(-1, 6).sum(-1) < 1e-12
    H = H + torch.diag(pinned.repeat_interleave(6).to(H.dtype))
    H = H + damping * torch.diag(torch.clamp_min(H.diagonal(), 1.0))
    L, info = torch.linalg.cholesky_ex(H)
    dx = torch.cholesky_solve(g[:, None], L)[:, 0]
    return torch.where(torch.isfinite(dx) & (info == 0), dx, torch.zeros_like(dx)).view(-1, 6)


def optimize_pose_graph_node_sharded(mesh, R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
                                     edge_weight=None, iters: int = 40, halo: int = 8,
                                     sync_every: int = 4, damping: float = 1e-4,
                                     axis: str = "landmark") -> dict:
    """Node-sharded Gauss-Newton pose graph (two-level overlapping Schwarz
    with a halo exchange).  Same measurement convention as
    ``optimize_pose_graph``; node 0 is the gauge; N must divide by the axis
    size.  Returns {"R", "t", "costs" (3 iters,)}: the whole state on every
    rank and the cost after each coarse, red and black sweep."""
    n = R.shape[0]
    D = axis_size(mesh, axis)
    if n % D:
        raise ValueError(f"optimize_pose_graph_node_sharded: N={n} does not divide "
                         f"by the {axis} axis ({D})")
    halo = min(halo, n // D)
    dev, dt = R.device, R.dtype
    if edge_weight is None:
        edge_weight = torch.ones(edge_i.shape, dtype=dt, device=dev)
    sel, sel_valid, sel_prim = partition_edges_by_node(
        edge_i.cpu().numpy(), edge_j.cpu().numpy(), n, D, halo)
    d = mesh.get_local_rank(axis)
    idx = torch.from_numpy(sel[d]).to(dev).long()
    ei, ej = edge_i[idx].long(), edge_j[idx].long()
    eR, et = edge_R[idx], edge_t[idx]
    ev = torch.from_numpy(sel_valid[d]).to(dev) & edge_valid[idx]
    w_e = edge_weight[idx] * ev.to(dt)
    # Primary weights: every edge counted once across the ranks, so the
    # coarse sums and the reported cost do not count window copies twice.
    w_p = w_e * torch.from_numpy(sel_prim[d]).to(dev).to(dt)
    psum = axis_sum(mesh, axis)

    B = n // D
    W = min(B + 2 * halo, n)
    own0 = d * B                                         # own block start
    win0 = int(np.clip(own0 - halo, 0, n - W))           # window start
    own = slice(own0, own0 + B)

    # Coarse level: block ids, block 0 the gauge.
    bi, bj = torch.clamp(ei // B, 0, D - 1), torch.clamp(ej // B, 0, D - 1)
    coarse_i = (bi != 0)[:, None, None].to(dt)
    coarse_j = (bj != 0)[:, None, None].to(dt)
    coarse_plan = assembly_plan(bi, bj, D, 6)
    node_block = torch.arange(n, device=dev) // B
    # Fine level: window-local ids; endpoints outside the window, and the
    # gauge node 0, are fixed (their Jacobian columns dropped).
    wi, wj = ei - win0, ej - win0
    fine_i = ((wi >= 0) & (wi < W) & (ei != 0))[:, None, None].to(dt)
    fine_j = ((wj >= 0) & (wj < W) & (ej != 0))[:, None, None].to(dt)
    fine_plan = assembly_plan(torch.clamp(wi, 0, W - 1), torch.clamp(wj, 0, W - 1), W, 6)

    def jacobians(R_cur, t_cur):
        return edge_jacobians((R_cur[ei], t_cur[ei]), (R_cur[ej], t_cur[ej]), (eR, et))

    def coarse_phase(R_cur, t_cur):
        r, Ji, Jj = jacobians(R_cur, t_cur)
        Hc, gc = normal_equations(coarse_plan, 6 * D, r, Ji * coarse_i, Jj * coarse_j, w_p)
        dxc = _damped_step(psum(Hc), psum(gc), damping)
        # The block correction applied to every node: the same inputs on
        # every rank after the sums, so the ranks stay equal.
        return se3_compose(*se3_exp(dxc[node_block]), R_cur, t_cur)

    def fine_phase(R_cur, t_cur, parity: int, it: int):
        r, Ji, Jj = jacobians(R_cur, t_cur)
        H, g = normal_equations(fine_plan, 6 * W, r, Ji * fine_i, Jj * fine_j, w_e)
        dx = _damped_step(H, g, damping)
        # Only the own block (Schwarz restriction), and only on this
        # half-sweep's parity (red/black block Gauss-Seidel across the ring).
        dx = dx * float(d % 2 == parity)
        R_own, t_own = se3_compose(*se3_exp(dx[own0 - win0:own0 - win0 + B]),
                                   R_cur[own], t_cur[own])
        R_new, t_new = R_cur.clone(), t_cur.clone()
        R_new[own], t_new[own] = R_own, t_own
        if D > 1 and halo > 0:
            # Halo exchange: every rank's top and bottom boundary slices.
            send = torch.cat([R_own[B - halo:].reshape(-1), t_own[B - halo:].reshape(-1),
                              R_own[:halo].reshape(-1), t_own[:halo].reshape(-1)])
            ring = axis_gather(send[None], mesh, axis)
            k = 9 * halo
            if d > 0:                   # the left neighbour's top rows
                lo = own0 - halo
                R_new[lo:lo + halo] = ring[d - 1, :k].view(halo, 3, 3)
                t_new[lo:lo + halo] = ring[d - 1, k:k + 3 * halo].view(halo, 3)
            if d < D - 1:               # the right neighbour's bottom rows
                hi = min(own0 + B, n - halo)
                R_new[hi:hi + halo] = ring[d + 1, 12 * halo:12 * halo + k].view(halo, 3, 3)
                t_new[hi:hi + halo] = ring[d + 1, 12 * halo + k:].view(halo, 3)
        if (it + 1) % sync_every == 0:  # periodic resync for long-range edges
            R_new = axis_gather(R_new[own], mesh, axis)
            t_new = axis_gather(t_new[own], mesh, axis)
        return R_new, t_new

    R_cur, t_cur = R, t
    costs = []
    # Each Gauss-Newton iteration is a coarse, a red and a black sweep.
    for it in range(3 * iters):
        if it % 3 == 0:
            R_cur, t_cur = coarse_phase(R_cur, t_cur)
        else:
            R_cur, t_cur = fine_phase(R_cur, t_cur, it % 3 - 1, it)
        r = edge_residual(R_cur[ei], t_cur[ei], R_cur[ej], t_cur[ej], eR, et)
        costs.append(psum((w_p * (r * r).sum(-1)).sum()))
    # Final gather, so every rank returns the same whole state.
    return {"R": axis_gather(R_cur[own], mesh, axis),
            "t": axis_gather(t_cur[own], mesh, axis), "costs": torch.stack(costs)}
