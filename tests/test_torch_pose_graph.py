"""The port's SE(3) and Sim(3) pose graphs against the JAX package's.

Edge Jacobians at xi = 0 (the port's closed forms against ``jax.jacfwd``)
atol 1e-5, for exact measurements (a converged graph: the residual's Sim(3)
log in ``_sim3_W``'s small-value branches) and for residuals of 0.3.
Sim(3) residuals of 1e-4 to 2e-2 are left out of that comparison: there
the JAX package's derivative of its closed forms cancels in float32 and
stands up to 4e-4 from the float64 value.  The port's float32 Jacobians
are held against its own float64 ones at every residual size instead,
atol 2e-6; a 12-node noisy loop with two loop edges (one
measuring scale 0.8), padded with invalid nodes and edges, solved over 20
Gauss-Newton iterations: R, t and s within 1e-4, the costs within rtol
1e-4; a singular system (a free node without edges, no damping): the step
is zeroed as the reference's NaN Cholesky zeroes it, with no NaN.  The
normal equations' assembly (``assembly_plan`` + ``normal_equations``)
equals, bit for bit, two serial ``index_add_`` calls, numpy's ``add.at``,
the JAX package's four ``.at[].add`` calls and the kernel's segment order
(``ops/scatter_cuda.py:ordered_scatter_segments``), for the same blocks,
also on a graph padded as ``models/slam.py:solve_graph`` pads it.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as P  # noqa: F401  (sets the torch thread count)
from tinyslam_tpu.backend import pose_graph as jpg
from tinyslam_tpu.geometry import se3 as jse3, sim3 as jsim3
from tinyslam_tpu_torch.backend import pose_graph as tpg

N, N_PAD, E_PAD = 12, 16, 20


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _random_sim3(rng, n, rot=0.5, scale=0.3, trans=1.0):
    xi = np.concatenate([rng.normal(0, trans, (n, 3)), rng.normal(0, rot, (n, 3)),
                         rng.normal(0, scale, (n, 1))], axis=1).astype(np.float32)
    return [np.asarray(a) for a in jsim3.sim3_exp(jnp.asarray(xi))]


def _jax_res(kind):
    if kind == "se3":
        def res(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
            return jpg.edge_residual(*jse3.se3_compose(*jse3.se3_exp(xi_i), Ri, ti),
                                     *jse3.se3_compose(*jse3.se3_exp(xi_j), Rj, tj), Rm, tm)
        return res, 6

    def res(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        return jpg.sim3_edge_residual(
            *jsim3.sim3_compose(*jsim3.sim3_exp(xi_i), Ri, ti, si),
            *jsim3.sim3_compose(*jsim3.sim3_exp(xi_j), Rj, tj, sj), Rm, tm, sm)
    return res, 7


@functools.lru_cache(maxsize=None)
def _jax_jacobian_fn(kind):
    """The reference's residuals and ``jax.jacfwd`` Jacobians at xi = 0,
    vmapped over edges and jitted (once per kind)."""
    res, D = _jax_res(kind)
    z = jnp.zeros(D, jnp.float32)

    def all_three(*a):
        return (jax.vmap(lambda *b: res(z, z, *b))(*a),
                jax.vmap(lambda *b: jax.jacfwd(res, argnums=0)(z, z, *b))(*a),
                jax.vmap(lambda *b: jax.jacfwd(res, argnums=1)(z, z, *b))(*a))
    return jax.jit(all_three)


def _jax_jacobians(kind, nodes_i, nodes_j, meas):
    out = _jax_jacobian_fn(kind)(*(jnp.asarray(a) for a in (*nodes_i, *nodes_j, *meas)))
    return [np.asarray(a) for a in out]


def _edges(kind, noise, seed=0, E=24):
    """Node pairs near each other and measurements of their relative
    transform perturbed by ``noise``; SE(3) edges at unit scale."""
    rng = np.random.default_rng(seed)
    sc = 0.0 if kind == "se3" else 1.0
    J = lambda arrs: [jnp.asarray(v) for v in arrs]   # noqa: E731
    a = _random_sim3(rng, E, scale=0.3 * sc)
    b = [np.asarray(x) for x in jsim3.sim3_compose(
        *J(_random_sim3(rng, E, rot=0.05, scale=0.05 * sc)), *J(a))]
    m = jsim3.sim3_compose(*J(b), *jsim3.sim3_inverse(*J(a)))
    m = [np.asarray(x) for x in jsim3.sim3_compose(
        *J(_random_sim3(rng, E, rot=noise, scale=noise * sc, trans=noise)), *m)]
    k = 3 if kind == "sim3" else 2
    return a[:k], b[:k], m[:k]


@pytest.mark.parametrize("noise", [0.0, 0.3], ids=["consistent", "noisy"])
@pytest.mark.parametrize("kind", ["se3", "sim3"])
def test_edge_jacobians_match_jax_jacfwd(kind, noise):
    nodes_i, nodes_j, meas = _edges(kind, noise)
    D = 6 if kind == "se3" else 7
    r, Ji, Jj = tpg.edge_jacobians(tuple(map(T, nodes_i)), tuple(map(T, nodes_j)),
                                   tuple(map(T, meas)))
    want = _jax_jacobians(kind, nodes_i, nodes_j, meas)
    assert Ji.shape == Jj.shape == (len(r), D, D)
    for got, w in zip((r, Ji, Jj), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("noise", [1e-4, 1e-3, 1e-2, 1.0])
@pytest.mark.parametrize("kind", ["se3", "sim3"])
def test_edge_jacobians_hold_float32(kind, noise):
    """No cancellation at any residual size: float32 against float64."""
    edges = _edges(kind, noise)
    got = tpg.edge_jacobians(*(tuple(map(T, x)) for x in edges))
    want = tpg.edge_jacobians(*(tuple(T(np.asarray(a, np.float64)) for a in x)
                                for x in edges))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-6)


def _loop_graph(seed=0):
    """A 12-node ring: odometry edges 0->1->...->11 measured with noise,
    loop edges 11->0 (scale 0.8) and 3->9, initial nodes integrated from
    the noisy odometry; padded to 16 nodes and 20 edges with invalid
    entries holding junk."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    xi_gt = np.zeros((N, 7), np.float32)
    xi_gt[:, 0], xi_gt[:, 2] = 3 * np.cos(ang), 3 * np.sin(ang)
    xi_gt[:, 4] = ang
    xi_gt[:, 6] = np.linspace(0, 0.2, N)
    gt = [np.asarray(a) for a in jsim3.sim3_exp(jnp.asarray(xi_gt))]
    gt = [jnp.asarray(a) for a in gt]

    def rel(i, j):
        gi = [g[i] for g in gt]
        gj = [g[j] for g in gt]
        return jsim3.sim3_compose(*gj, *jsim3.sim3_inverse(*gi))

    def noisy(S, sigma):
        d = jsim3.sim3_exp(jnp.asarray(rng.normal(0, sigma, 7).astype(np.float32)))
        return jsim3.sim3_compose(*d, *S)

    pairs = [(i, i + 1) for i in range(N - 1)] + [(N - 1, 0), (3, 9)]
    edges = [noisy(rel(i, j), 0.01) for i, j in pairs]
    edges[-2] = (edges[-2][0], edges[-2][1], jnp.float32(0.8) * edges[-2][2])
    # Initial estimate: node 0 at ground truth, the chain integrated.
    nodes = [[g[0] for g in gt]]
    for k in range(N - 1):
        nodes.append(jsim3.sim3_compose(*edges[k], *nodes[-1]))
    R0 = np.tile(np.eye(3, dtype=np.float32), (N_PAD, 1, 1))
    t0 = rng.normal(size=(N_PAD, 3)).astype(np.float32)
    s0 = np.ones(N_PAD, np.float32)
    for k, (R, t, s) in enumerate(nodes):
        R0[k], t0[k], s0[k] = R, t, s
    ei = rng.integers(0, N_PAD, E_PAD)
    ej = rng.integers(0, N_PAD, E_PAD)
    eR = np.array(jsim3.sim3_exp(jnp.asarray(rng.normal(size=(E_PAD, 7)).astype(
        np.float32)))[0])
    et = rng.normal(size=(E_PAD, 3)).astype(np.float32)
    es = rng.uniform(0.5, 2.0, E_PAD).astype(np.float32)
    for k, ((i, j), (R, t, s)) in enumerate(zip(pairs, edges)):
        ei[k], ej[k], eR[k], et[k], es[k] = i, j, R, t, s
    ev = np.arange(E_PAD) < len(pairs)
    ew = np.where(np.arange(E_PAD) >= len(pairs) - 2, 5.0, 1.0).astype(np.float32)
    return dict(R=R0, t=t0, s=s0, edge_i=ei.astype(np.int32), edge_j=ej.astype(np.int32),
                edge_R=eR, edge_t=et, edge_s=es, edge_valid=ev, edge_weight=ew,
                node_valid=np.arange(N_PAD) < N)


def _solve(kind, g, pkg, **kw):
    if pkg == "jax":
        A, fn = jnp.asarray, (jpg.optimize_pose_graph if kind == "se3"
                              else jpg.optimize_pose_graph_sim3)
    else:
        A, fn = T, (tpg.optimize_pose_graph if kind == "se3" else tpg.optimize_pose_graph_sim3)
    names = (["R", "t"] + (["s"] if kind == "sim3" else []) + ["edge_i", "edge_j", "edge_R",
             "edge_t"] + (["edge_s"] if kind == "sim3" else []) + ["edge_valid"])
    out = fn(*(A(g[k]) for k in names), edge_weight=A(g["edge_weight"]),
             node_valid=A(g["node_valid"]), iters=20, **kw)
    return {k: np.asarray(v) if pkg == "jax" else v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("kind", ["se3", "sim3"])
def test_loop_graph_matches_jax(kind):
    g = _loop_graph()
    got, want = _solve(kind, g, "torch"), _solve(kind, g, "jax")
    assert set(got) == set(want)
    for k in ("R", "t", "s"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-4)
    # The solve did something: the cost fell, node 0 and the padding held.
    assert want["costs"][-1] < 0.5 * want["costs"][0]
    np.testing.assert_array_equal(got["R"][0], g["R"][0])
    np.testing.assert_array_equal(got["t"][N:], g["t"][N:])


@pytest.mark.parametrize("kind", ["se3", "sim3"])
def test_singular_system_zeroes_the_step(kind):
    g = _loop_graph(seed=1)
    # Node 5 loses its edges but stays free: with no damping its block of
    # the normal equations is zero, the Cholesky fails, the step is zeroed.
    dead = (g["edge_i"] == 5) | (g["edge_j"] == 5)
    g["edge_valid"] = g["edge_valid"] & ~dead
    got, want = _solve(kind, g, "torch", damping=0.0), _solve(kind, g, "jax", damping=0.0)
    for k in ("R", "t", "s"):
        if k in want:
            assert np.isfinite(got[k]).all()
            np.testing.assert_allclose(got[k], g[k], rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert np.isfinite(got["costs"]).all()
    np.testing.assert_allclose(got["costs"], got["costs"][0], rtol=1e-6)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-4)


@pytest.mark.parametrize("kind", ["se3", "sim3", "coarse", "fine", "padded"])
def test_assembly_equals_serial_index_add(kind):
    """The assembly of H and g in one ordered scatter equals, bit for bit,
    H and g added in their listed order: two serial ``index_add_`` (the
    assembly before the order-fixed kernel), numpy's ``add.at``, the JAX
    package's ``.at[].add`` in its order (the (i, i) blocks of every edge,
    then (j, j), (i, j), (j, i); g's i-rows, then j-rows), and the kernel's
    own arithmetic (segments of a stable sort, each summed from 0), on
    graphs where 120 of 240 edges hit one node pair, and on a 32-node graph
    padded to 128 edges as ``solve_graph`` pads it (node 0's slots hold
    segments of ~400 terms, most of them +-0)."""
    from tinyslam_tpu_torch.ops import scatter_cuda

    n, D, r, Ji, Jj, w, bi, bj = P.dense_graph_terms(kind)
    m = n * D
    plan = tpg.assembly_plan(bi, bj, n, D)
    H, g = tpg.normal_equations(plan, m, r, Ji, Jj, w)

    E = bi.shape[0]
    vals = tpg.normal_terms(r, Ji, Jj, w)
    blocks, rows = vals[:4 * E * D * D], vals[4 * E * D * D:]
    h_at, g_at = tpg.block_offsets(bi, bj, n, D)
    H_serial = torch.zeros(m * m).index_add_(0, h_at, blocks.reshape(-1)).view(m, m)
    g_serial = torch.zeros(m).index_add_(0, g_at, rows.reshape(-1))
    assert torch.equal(H, H_serial) and torch.equal(g, g_serial)

    H_np, g_np = np.zeros(m * m, np.float32), np.zeros(m, np.float32)
    np.add.at(H_np, h_at.numpy(), blocks.reshape(-1).numpy())
    np.add.at(g_np, g_at.numpy(), rows.reshape(-1).numpy())
    np.testing.assert_array_equal(H.numpy(), H_np.reshape(m, m))
    np.testing.assert_array_equal(g.numpy(), g_np)

    ji, jj = jnp.asarray(bi.numpy()), jnp.asarray(bj.numpy())
    b = jnp.asarray(blocks.numpy()).reshape(4, E, D, D)
    H_jax = (jnp.zeros((n, D, n, D), jnp.float32).at[ji, :, ji, :].add(b[0])
             .at[jj, :, jj, :].add(b[1]).at[ji, :, jj, :].add(b[2]).at[jj, :, ji, :].add(b[3]))
    gr = jnp.asarray(rows.numpy()).reshape(2, E, D)
    g_jax = jnp.zeros((n, D), jnp.float32).at[ji].add(gr[0]).at[jj].add(gr[1])
    np.testing.assert_array_equal(H.numpy(), np.asarray(H_jax).reshape(m, m))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_jax).reshape(m))

    Hg = scatter_cuda.ordered_scatter_segments(plan.at, plan.size, vals)
    assert torch.equal(Hg[:m * m].view(m, m), H) and torch.equal(Hg[m * m:], g)
