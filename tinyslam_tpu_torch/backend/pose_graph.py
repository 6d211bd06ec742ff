"""Pose-graph optimization, the loop-closure back-end (mirrors
``tinyslam_tpu/backend/pose_graph.py``).

Nodes are keyframe poses (world->camera); edges carry measured relative
transforms T_ij (T_j = T_ij o T_i) from odometry and loop closures, with a
validity mask so the problem keeps its shape.  The residual of an edge is

    r_e = log( T_ij_meas^-1 o T_j o T_i^-1 )

in se(3) (6) or, for monocular scale drift, in sim(3) (7).  Gauss-Newton
with the edge Jacobians at xi = 0, the dense (nD x nD) normal equations
assembled by a scatter-add of D x D blocks (in a fixed order, on the card
too: ``ops/scatter_cuda.py``), node 0 and invalid nodes held
by identity blocks, and a Cholesky solve, for a fixed number of
iterations with nothing read back to the host (``device_loop``: inside a
captured CUDA graph one step, run by a WHILE node).

Two choices differ from the JAX package's mechanics, not its results:

- The Jacobians are closed form where the JAX package takes ``jax.jacfwd``
  of the residual at xi = 0.  With E = T_m^-1 o T_j o T_i^-1 the edge's
  error and r = log E, a left perturbation gives
      J_j = Jl(r)^-1 Ad(T_m^-1),   J_i = -Jl(r)^-1 Ad(E),
  the left Jacobian Jl(r) = sum_n ad(r)^n / (n+1)! summed to 24 terms and
  applied by a batched solve.  No autograd state is involved, so solves on
  several threads at once (the watchdog's resubmitted solve beside the one
  it abandoned) are independent.
- ``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
  definite, and the NaN step is then zeroed; ``torch.linalg.cholesky_ex``
  returns a partial factor with ``info > 0``, so the step is zeroed where
  ``info != 0`` as well as where it is not finite.
"""

from __future__ import annotations

import torch

from tinyslam_tpu_torch.geometry.se3 import (
    se3_compose,
    se3_exp,
    se3_inverse,
    se3_log,
    so3_hat,
)
from tinyslam_tpu_torch.geometry.sim3 import (
    sim3_compose,
    sim3_exp,
    sim3_inverse,
    sim3_log,
)
from tinyslam_tpu_torch.ops.scatter_cuda import (
    ScatterPlan,
    ordered_scatter_add,
    scatter_plan,
)
from tinyslam_tpu_torch.utils.cuda_graph import device_loop


def _identity(x):
    return x


def _edge_error(node_i: tuple, node_j: tuple, meas: tuple):
    """E = T_m^-1 o T_j o T_i^-1 and T_m^-1, as (R, t) or (R, t, s)."""
    if len(meas) == 2:
        inv_m = se3_inverse(*meas)
        return se3_compose(*inv_m, *se3_compose(*node_j, *se3_inverse(*node_i))), inv_m
    inv_m = sim3_inverse(*meas)
    return sim3_compose(*inv_m, *sim3_compose(*node_j, *sim3_inverse(*node_i))), inv_m


def edge_residual(Ri, ti, Rj, tj, Rm, tm):
    """r = log(Tm^-1 o T_j o T_i^-1) for SE(3) edges, (..., 6)."""
    return se3_log(*_edge_error((Ri, ti), (Rj, tj), (Rm, tm))[0])


def sim3_edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log_sim3(Sm^-1 o S_j o S_i^-1) for Sim(3) edges, (..., 7)."""
    return sim3_log(*_edge_error((Ri, ti, si), (Rj, tj, sj), (Rm, tm, sm))[0])


def _adjoint(R, t, s=None) -> torch.Tensor:
    """Ad of (R, t) on [rho, phi] tangents (..., 6, 6), or of the
    similarity (R, t, s) on [rho, phi, sigma] tangents (..., 7, 7)."""
    D = 6 if s is None else 7
    A = R.new_zeros((*R.shape[:-2], D, D))
    A[..., :3, :3] = R if s is None else s[..., None, None] * R
    A[..., :3, 3:6] = so3_hat(t) @ R
    A[..., 3:6, 3:6] = R
    if s is not None:
        A[..., :3, 6] = -t
        A[..., 6, 6] = 1.0
    return A


def _left_jacobian(xi: torch.Tensor, terms: int = 24) -> torch.Tensor:
    """Jl(xi) = sum_n ad(xi)^n / (n+1)!, (..., D, D), by Horner's rule;
    ad(xi) y = [xi, y] for xi = [rho, phi(, sigma)].  24 terms leave a
    truncation below float32's rounding while |sigma| + |phi| < 5."""
    D = xi.shape[-1]
    rho, phi = xi[..., :3], xi[..., 3:6]
    ad = xi.new_zeros((*xi.shape[:-1], D, D))
    ad[..., :3, :3] = so3_hat(phi)
    ad[..., :3, 3:6] = so3_hat(rho)
    ad[..., 3:6, 3:6] = so3_hat(phi)
    eye = torch.eye(D, dtype=xi.dtype, device=xi.device)
    if D == 7:
        ad[..., :3, :3] += xi[..., 6, None, None] * eye[:3, :3]
        ad[..., :3, 6] = -rho
    J = eye.expand(ad.shape)
    for k in range(terms, 0, -1):
        J = eye + (ad @ J) / (k + 1)
    return J


def edge_jacobians(node_i: tuple, node_j: tuple, meas: tuple):
    """Residuals (E, D) and their Jacobians J_i, J_j (E, D, D) with respect
    to left perturbations exp(xi) o T of the two end nodes, at xi = 0.

    node_i, node_j, meas: (R, t) tables for SE(3) (D = 6) or (R, t, s) for
    Sim(3) (D = 7), each with a leading edge dimension E."""
    err, inv_m = _edge_error(node_i, node_j, meas)
    r = se3_log(*err) if len(meas) == 2 else sim3_log(*err)
    D = r.shape[-1]
    rhs = torch.cat([-_adjoint(*err), _adjoint(*inv_m)], -1)     # (E, D, 2D)
    J = torch.linalg.solve_ex(_left_jacobian(r), rhs)[0]
    return r, J[..., :D], J[..., D:]


def block_offsets(bi, bj, n: int, D: int):
    """Flat offsets into an (nD, nD) matrix of the four D x D blocks (i, i),
    (j, j), (i, j), (j, i) that each edge (bi, bj) adds, and into an (nD,)
    vector of its two D-rows."""
    a = torch.arange(D, device=bi.device)
    rows, cols = torch.cat([bi, bj, bi, bj]), torch.cat([bi, bj, bj, bi])
    h_at = (((rows[:, None, None] * D + a[:, None]) * (n * D)
             + cols[:, None, None] * D + a[None, :]).reshape(-1))
    g_at = (torch.cat([bi, bj])[:, None] * D + a).reshape(-1)
    return h_at, g_at


def assembly_plan(bi, bj, n: int, D: int) -> ScatterPlan:
    """The scatter of ``normal_equations`` for the edges (bi, bj) of an
    n-node graph: H's slots, then g's after them, in one plan, built once a
    solve."""
    h_at, g_at = block_offsets(bi, bj, n, D)
    m = n * D
    return scatter_plan(torch.cat([h_at, m * m + g_at]), m * m + m)


def normal_terms(r, Ji, Jj, w) -> torch.Tensor:
    """The values ``normal_equations`` scatters, flat in ``assembly_plan``'s
    order: w Ji^T Ji, w Jj^T Jj, w Ji^T Jj and its transpose for every edge,
    then -w Ji^T r and -w Jj^T r."""
    we = w[:, None, None]
    Hij = we * torch.einsum("eab,eac->ebc", Ji, Jj)
    blocks = torch.cat([we * torch.einsum("eab,eac->ebc", Ji, Ji),
                        we * torch.einsum("eab,eac->ebc", Jj, Jj),
                        Hij, Hij.transpose(-1, -2)])
    g_rows = torch.cat([-torch.einsum("eab,ea->eb", Ji * we, r),
                        -torch.einsum("eab,ea->eb", Jj * we, r)])
    return torch.cat([blocks.reshape(-1), g_rows.reshape(-1)])


def normal_equations(plan: ScatterPlan, m: int, r, Ji, Jj, w):
    """H (m, m) and g (m,) of the edges' Gauss-Newton terms weighted by w,
    scattered by ``assembly_plan``: H += w J^T J, g -= w J^T r.  Each slot
    adds its terms in the JAX package's order (the (i, i) blocks of every
    edge, then (j, j), (i, j), (j, i); g's i-rows, then j-rows), on the card
    too (``ops/scatter_cuda.py``), so a solve is the same every run."""
    Hg = ordered_scatter_add(plan, normal_terms(r, Ji, Jj, w))
    return Hg[:m * m].view(m, m), Hg[m * m:]


def _gauss_newton(nodes: tuple, meas: tuple, edge_i, edge_j, edge_valid, edge_weight,
                  node_valid, exp_fn, compose_fn, D: int, iters: int,
                  damping: float, preduce, reduce_cost: bool):
    """The Gauss-Newton loop shared by the SE(3) and Sim(3) graphs.
    ``nodes``: the node tables (R, t[, s]); ``meas``: the edge tables."""
    R = nodes[0]
    n = R.shape[0]
    dev, dt = R.device, R.dtype
    if edge_weight is None:
        edge_weight = torch.ones(edge_valid.shape, dtype=dt, device=dev)
    if node_valid is None:
        node_valid = torch.ones((n,), dtype=torch.bool, device=dev)
    w_e = edge_weight * edge_valid.to(dt)
    ei, ej = edge_i.long(), edge_j.long()
    # Gauge: node 0 fixed; invalid nodes also held (their edges are invalid).
    free = node_valid & (torch.arange(n, device=dev) != 0)
    fr = free.to(dt).repeat_interleave(D)                  # (nD,)
    held = torch.diag(1.0 - fr) + damping * torch.eye(n * D, dtype=dt, device=dev)
    plan = assembly_plan(ei, ej, n, D)

    def step(nodes):
        ni = tuple(x[ei] for x in nodes)
        nj = tuple(x[ej] for x in nodes)
        r, Ji, Jj = edge_jacobians(ni, nj, meas)
        H, g = normal_equations(plan, n * D, r, Ji, Jj, w_e)
        # Cross-shard reduction point (identity on a single device).
        H, g = preduce(H), preduce(g)
        Hm = H * fr[:, None] * fr[None, :] + held
        L, info = torch.linalg.cholesky_ex(Hm)
        # Two triangular solves, not cholesky_solve (equal on the CPU): in a
        # captured loop's body cuSOLVER's potrs could allocate its cuBLAS
        # scratch with memory nodes, which such a body may not hold.
        y = torch.linalg.solve_triangular(L, (g * fr)[:, None], upper=False)
        dx = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
        dx = torch.where(torch.isfinite(dx) & (info == 0), dx, torch.zeros_like(dx))
        nodes = tuple(compose_fn(*exp_fn(dx.view(n, D)), *nodes))
        cost = (w_e * (r * r).sum(-1)).sum()
        return nodes, (preduce(cost) if reduce_cost else cost)

    # The reference's lax.scan: a Python loop eagerly, one WHILE node whose
    # body is one step inside a capture.
    return device_loop(iters, step, tuple(nodes))


def optimize_pose_graph(R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
                        edge_weight=None, node_valid=None, iters: int = 20,
                        damping: float = 1e-6) -> dict:
    """SE(3) pose graph.  R (N, 3, 3), t (N, 3) node poses; edge_i/edge_j
    (E,) int source and target nodes; edge_R (E, 3, 3), edge_t (E, 3)
    measured relative transforms; edge_valid (E,) bool; edge_weight (E,)
    relative information scale; node_valid (N,) bool.  Returns {"R", "t",
    "costs" (iters,)}, the cost before each step."""
    return _pose_graph_core(R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
                            edge_weight, node_valid, iters=iters, damping=damping)


def _pose_graph_core(R, t, edge_i, edge_j, edge_R, edge_t, edge_valid,
                     edge_weight=None, node_valid=None, iters: int = 20,
                     damping: float = 1e-6, preduce=_identity) -> dict:
    """The SE(3) Gauss-Newton core.  ``preduce`` hooks the reduction of the
    normal equations and the cost: the identity on one device, a sum over
    the edge shards where the edges are split across devices (each shard
    assembles H and g from its own edges, the solve runs replicated)."""
    (R_out, t_out), costs = _gauss_newton(
        (R, t), (edge_R, edge_t), edge_i, edge_j, edge_valid, edge_weight, node_valid,
        se3_exp, se3_compose, 6, iters, damping, preduce, True)
    return {"R": R_out, "t": t_out, "costs": costs}


def optimize_pose_graph_sim3(R, t, s, edge_i, edge_j, edge_R, edge_t, edge_s,
                             edge_valid, edge_weight=None, node_valid=None,
                             iters: int = 20, damping: float = 1e-6) -> dict:
    """Gauss-Newton over Sim(3) nodes (7 DoF each; node 0 fixes the scale
    gauge too): s (N,) node scales, edge_s (E,) measured relative scales
    (odometry edges carry 1).  The loop edges' measured scales spread the
    scale drift along the odometry chain, which an SE(3) graph cannot do.
    Returns {"R", "t", "s", "costs"}."""
    (R_out, t_out, s_out), costs = _gauss_newton(
        (R, t, s), (edge_R, edge_t, edge_s), edge_i, edge_j, edge_valid, edge_weight,
        node_valid, sim3_exp, sim3_compose, 7, iters, damping,
        _identity, False)
    return {"R": R_out, "t": t_out, "s": s_out, "costs": costs}
