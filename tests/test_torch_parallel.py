"""The port's distributed layer (``tinyslam_tpu_torch/parallel/``) on
``torch.distributed`` over ``gloo``, against the JAX package's sharded
functions on the conftest's 8-device virtual mesh, case for case as
``tests/test_sharding.py``.

Each world size (1, 2 and 4 ranks) is one group of processes that runs
every case once (``_WORKER``: ``import jax`` fails there, it imports torch
and the port only); inputs are made here from seeds with numpy (and the
JAX test helpers), handed over in an ``.npz``, and each rank writes its
outputs to one.  Tolerances:

- world 2 and 4 against the JAX sharded function: ``test_sharding.py``'s
  own, R atol 5e-4, t and X atol 5e-3 (the same optimization up to the
  order of the float sums); the node-sharded pose graph: camera centres
  within 0.05 m of the replicated optimum, as there;
- ``frontend_dp``: every frame bit-equal to the port's per-frame
  ``extract_features``; against the JAX batch descriptors (on the rendered
  frames, see ``test_frontend_dp``), levels and ``valid`` equal, xy atol
  1e-5 and the angle atol 1e-4 (``test_torch_frontend.py``'s);
- world 1: bit for bit against the port's unsharded ``bundle_adjust`` and
  ``optimize_pose_graph`` (the sums over a group of one are the identity);
- every rank returns the same global result, bit for bit.

The batched extraction (``frontend/orb.py:extract_batch``) and K1's
batched plain path equal the per-frame ones bit for bit.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parity as P  # noqa: F401  (sets the torch thread count)
from tests.golden import dot_grid
from tests.test_ba import _window_problem
from tinyslam_tpu.backend.pose_graph import optimize_pose_graph as j_optimize_pose_graph
from tinyslam_tpu.config import FrontendConfig as JFrontendConfig
from tinyslam_tpu.config import MeshConfig as JMeshConfig
from tinyslam_tpu.parallel import bundle_adjust_sharded as j_ba_sharded
from tinyslam_tpu.parallel import extract_features_batch as j_extract_batch
from tinyslam_tpu.parallel import make_mesh as j_make_mesh
from tinyslam_tpu.parallel.dist_pose_graph import (
    optimize_pose_graph_sharded as j_edge_sharded,
)
from tinyslam_tpu.parallel.dist_pose_graph import (
    partition_edges_by_node as j_partition,
)
from tinyslam_tpu_torch.config import FrontendConfig
from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
from tinyslam_tpu_torch.frontend.orb import extract_batch, extract_features
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.se3 import se3_compose as tse3_compose
from tinyslam_tpu_torch.geometry.se3 import se3_exp as tse3_exp
from tinyslam_tpu_torch.geometry.se3 import se3_inverse as tse3_inverse
from tinyslam_tpu_torch.ops.fast import fast_maps
from tinyslam_tpu_torch.ops.fast_cuda import fast_pyramid_maps
from tinyslam_tpu_torch.ops.image import build_pyramid
from tinyslam_tpu_torch.parallel.dist_pose_graph import partition_edges_by_node

REPO = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
# (frame, landmark) layouts asked of make_mesh; None = all on landmark.
# At 4 ranks (3, 2) does not tile the world: (3, 1), rank 3 outside.
MESH_CFGS = {"none": None, "1x1": (1, 1), "2x2": (2, 2), "3x2": (3, 2),
             "1x8": (1, 8), "4x1": (4, 1)}
FE = dict(height=96, width=128, num_levels=2, features_per_level=64, threshold=0.1,
          adaptive_threshold=False)
FIELDS = ("xy", "level", "angle", "score", "desc", "valid")
BA_ITERS = 8
PG_ITERS = 10
NODE = dict(iters=80, halo=12, sync_every=4)

_WORKER = r"""
import sys
sys.modules["jax"] = None           # any import of jax now raises ImportError
import numpy as np, torch
torch.set_num_threads(2)
import torch.distributed as dist
from tinyslam_tpu_torch.backend.ba import bundle_adjust
from tinyslam_tpu_torch.backend.pose_graph import optimize_pose_graph
from tinyslam_tpu_torch.config import FrontendConfig, MeshConfig
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.parallel import (
    bundle_adjust_sharded, extract_features_batch, initialize_multihost, make_mesh,
    optimize_pose_graph_node_sharded, optimize_pose_graph_sharded)

rank, world = int(sys.argv[1]), int(sys.argv[2])
port, inp, out = sys.argv[3:6]
initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
I = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
res = {}
x = torch.tensor([float(rank + 1)])
dist.all_reduce(x)                  # crosses the process boundary
res["bringup"] = x.numpy()
for name, layout in %(mesh_cfgs)r.items():
    m = make_mesh(None if layout is None else MeshConfig(*layout), "cpu")
    res["mesh_" + name] = np.array([*m.shape, *(m.get_coordinate() or (-1, -1))])
flat = make_mesh(None, "cpu")                       # (1, world)
grid = make_mesh(MeshConfig(2, 2), "cpu")           # (2, 2), (2, 1) or (1, 1)
frames = make_mesh(MeshConfig(world, 1), "cpu")     # (world, 1)
if grid.get_coordinate() is None:
    raise SystemExit("every rank is inside the 2x2 layout")

cam = PinholeCamera.create(*I["cam"].tolist())
for case, mesh in (("ba", flat), ("bapv", grid)):
    a = [I[f"{case}_{k}"] for k in ("R", "t", "X", "z", "mask", "pose_free")]
    pv = I["bapv_point_valid"] if case == "bapv" else None
    o = bundle_adjust_sharded(mesh, cam, *a, point_valid=pv, max_iters=%(ba_iters)d)
    res.update({f"{case}_{k}": v.numpy() for k, v in o.items()})
    if world == 1:
        o = bundle_adjust(cam, *a, point_valid=pv, max_iters=%(ba_iters)d)
        res.update({f"{case}_single_{k}": v.numpy() for k, v in o.items()})

cfg = FrontendConfig(**%(fe)r)
for images in ("room", "dots"):
    for layout, mesh in (("grid", grid), ("frames", frames)):
        f = extract_features_batch(I["fe_" + images], cfg.threshold, cfg, mesh=mesh)
        res.update({f"fe_{images}_{layout}_{k}": getattr(f, k).numpy() for k in %(fields)r})

edge = [I[f"pg_{k}"] for k in ("R", "t", "ei", "ej", "eR", "et", "ev", "ew")]
o = optimize_pose_graph_sharded(flat, *edge, iters=%(pg_iters)d)
res.update({f"pg_{k}": v.numpy() for k, v in o.items()})
if world == 1:
    o = optimize_pose_graph(*edge, iters=%(pg_iters)d)
    res.update({f"pg_single_{k}": v.numpy() for k, v in o.items()})

node = [I[f"node_{k}"] for k in ("R", "t", "ei", "ej", "eR", "et", "ev", "ew")]
o = optimize_pose_graph_node_sharded(flat, *node, **%(node)r)
res.update({f"node_{k}": v.numpy() for k, v in o.items()})
np.savez(out, **res)
dist.destroy_process_group()
""" % dict(mesh_cfgs=MESH_CFGS, ba_iters=BA_ITERS, fe=FE, fields=FIELDS,
           pg_iters=PG_ITERS, node=NODE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _se3(xi: np.ndarray):
    R, t = tse3_exp(torch.from_numpy(np.asarray(xi, np.float32)))
    return R.numpy(), t.numpy()


def _perturb(rng, R_gt, t_gt, X, rot=0.02, trans=0.05, pt=0.05, keep_first=2):
    """``test_ba.py:_perturb``'s noise, composed by the port's SE(3)."""
    xi = np.concatenate([rng.normal(0, trans, (len(R_gt), 3)),
                         rng.normal(0, rot, (len(R_gt), 3))], axis=-1).astype(np.float32)
    xi[:keep_first] = 0.0
    R0, t0 = tse3_compose(*(torch.from_numpy(a) for a in (*_se3(xi), R_gt, t_gt)))
    return R0.numpy(), t0.numpy(), X + rng.normal(0, pt, X.shape).astype(np.float32)


def _noisy_chain(rng, n, extra):
    """``test_sharding.py``'s graphs: the drifting odometry chain over n
    circle poses (``test_pose_graph.py:_circle_poses``, radius 5; noise 0.01
    rad and 0.005 m), plus the ``extra`` (a, b, weight) edges at their true
    relative transforms; composed by the port's SE(3)."""
    T = lambda *a: [torch.from_numpy(np.asarray(x, np.float32)) for x in a]  # noqa: E731
    ang = 2 * np.pi * np.arange(n) / n
    zero = np.zeros(n)
    Rg, _ = _se3(np.stack([zero, zero, zero, zero, ang, zero], -1))
    C = np.stack([5.0 * np.sin(ang), zero, 5.0 * (1 - np.cos(ang))], -1)
    tg = -np.einsum("nab,nb->na", Rg, C).astype(np.float32)

    def relative(a, b):
        return tse3_compose(*T(Rg[b], tg[b]), *tse3_inverse(*T(Rg[a], tg[a])))

    est, edges = [T(Rg[0], tg[0])], []
    for i in range(n - 1):
        noise = np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]
        Rm, tm = tse3_compose(*T(*_se3(noise)), *relative(i, i + 1))
        edges.append((i, i + 1, Rm.numpy(), tm.numpy(), 1.0))
        est.append(tse3_compose(Rm, tm, *est[-1]))
    for a, b, w in extra:
        Rm, tm = relative(a, b)
        edges.append((a, b, Rm.numpy(), tm.numpy(), w))
    return [(R.numpy(), t.numpy()) for R, t in est], edges


def _graph_arrays(est, edges, pad: int = 0) -> dict:
    """Node and edge tables, with ``pad`` invalid edges (0 -> 1) appended."""
    eye = np.eye(3, dtype=np.float32)
    return {
        "R": np.stack([p[0] for p in est]).astype(np.float32),
        "t": np.stack([p[1] for p in est]).astype(np.float32),
        "ei": np.array([e[0] for e in edges] + [0] * pad, np.int32),
        "ej": np.array([e[1] for e in edges] + [1] * pad, np.int32),
        "eR": np.stack([e[2] for e in edges] + [eye] * pad).astype(np.float32),
        "et": np.stack([e[3] for e in edges] + [np.zeros(3, np.float32)] * pad),
        "ev": np.array([True] * len(edges) + [False] * pad),
        "ew": np.array([e[4] for e in edges] + [0.0] * pad, np.float32),
    }


def _centres(R, t) -> np.ndarray:
    return np.stack([-(Ri.T @ ti) for Ri, ti in zip(np.asarray(R), np.asarray(t))])


@pytest.fixture(scope="module")
def problems():
    """Every case's inputs: (numpy arrays for the ranks, the JAX camera)."""
    out = {}
    rng = np.random.default_rng(0)
    cam, X, R_gt, t_gt, z, mask = _window_problem(rng, K=6, L=256)
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X)
    out.update(ba_R=R0, ba_t=t0, ba_X=X0, ba_z=z, ba_mask=mask,
               ba_pose_free=np.r_[[False, False], np.ones(4, bool)])
    out["cam"] = np.array([float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)],
                          np.float32)
    rng = np.random.default_rng(1)
    _, X, R_gt, t_gt, z, mask = _window_problem(rng, K=5, L=512)
    R0, t0, X0 = _perturb(rng, R_gt, t_gt, X)
    out.update(bapv_R=R0, bapv_t=t0, bapv_X=X0, bapv_z=z, bapv_mask=mask,
               bapv_pose_free=np.r_[[False, False], np.ones(3, bool)],
               bapv_point_valid=rng.random(512) > 0.2)
    # Four frames of the textured room, and test_sharding.py's dot grids.
    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    cam96 = PinholeCamera.create(80.0, 80.0, 63.5, 47.5)
    out["fe_room"] = np.stack([room.render(cam96, R, t, 128, 96) for R, t in orbit_trajectory(
        4, radius=2.0, step=0.02, start=-0.35, target=(0.0, 0.0, 2.0))]).astype(np.float32)
    out["fe_dots"] = np.stack([dot_grid(96, 128, spacing=12 + i, offset=24)
                               for i in range(4)]).astype(np.float32)
    # The edge-sharded loop: 15 odometry edges and the closing one, with at
    # least one invalid pad edge for every world (padded to a multiple of 8).
    est, edges = _noisy_chain(np.random.default_rng(3), 16, [(15, 0, 10.0)])
    out.update({f"pg_{k}": v for k, v in _graph_arrays(est, edges, pad=8).items()})
    # The node-sharded loop: n = 64 with a long-range and a mid-range edge.
    est, edges = _noisy_chain(np.random.default_rng(5), 64, [(63, 0, 10.0), (10, 40, 5.0)])
    out.update({f"node_{k}": v for k, v in _graph_arrays(est, edges).items()})
    return out, cam


@pytest.fixture(scope="module")
def jax_ref(problems):
    """The JAX package's sharded functions on the 8-device virtual mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    arr, cam = problems
    J = lambda k: jnp.asarray(arr[k])  # noqa: E731
    mesh = j_make_mesh(JMeshConfig(frame_axis=2, landmark_axis=4))
    ref = {}
    for case in ("ba", "bapv"):
        pv = J("bapv_point_valid") if case == "bapv" else None
        o = j_ba_sharded(mesh, cam, *(J(f"{case}_{k}") for k in
                                      ("R", "t", "X", "z", "mask", "pose_free")),
                         point_valid=pv, max_iters=BA_ITERS)
        ref.update({f"{case}_{k}": np.asarray(v) for k, v in o.items()})
    for images in ("room", "dots"):
        f = j_extract_batch(J("fe_" + images), FE["threshold"], JFrontendConfig(**FE),
                            mesh=mesh)
        ref.update({f"fe_{images}_{k}": np.asarray(getattr(f, k)) for k in FIELDS})
    flat = j_make_mesh(JMeshConfig(frame_axis=1, landmark_axis=8))
    o = j_edge_sharded(flat, *(J(f"pg_{k}") for k in ("R", "t", "ei", "ej", "eR", "et",
                                                       "ev", "ew")), iters=PG_ITERS)
    ref.update({f"pg_{k}": np.asarray(v) for k, v in o.items()})
    o = j_optimize_pose_graph(*(J(f"node_{k}") for k in ("R", "t", "ei", "ej", "eR", "et",
                                                          "ev", "ew")), iters=25)
    ref["node_optimum"] = _centres(o["R"], o["t"])
    devs = jax.devices()
    for w in WORLDS:
        for name, layout in MESH_CFGS.items():
            m = j_make_mesh(None if layout is None else JMeshConfig(*layout), devs[:w])
            ref[f"mesh_{w}_{name}"] = (m.shape["frame"], m.shape["landmark"])
    return ref


@pytest.fixture(scope="module")
def groups(problems, tmp_path_factory):
    """Start one group of gloo ranks per world size, all at once (they run
    while the JAX references compile); yields (the directory, {world: its
    processes}) and kills whatever is left at the end."""
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "in.npz", **problems[0])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    started = {}
    for w in WORLDS:
        port = str(_free_port())
        started[w] = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(w), port, str(tmp / "in.npz"),
             str(tmp / f"out{w}_{r}.npz")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env) for r in range(w)]
    yield tmp, started
    for procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, groups):
    """The outputs of ``request.param`` ranks: (world size, each rank's
    dict).  Every rank must exit 0 within the time limit."""
    w = request.param
    tmp, started = groups
    procs = started[w]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {w} failed:\n{log[-4000:]}"
    return w, [dict(np.load(tmp / f"out{w}_{r}.npz")) for r in range(w)]


def _same_on_every_rank(outs, prefix):
    for r, o in enumerate(outs[1:], 1):
        for k in o:
            if k.startswith(prefix):
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"rank {r}: {k}")


def test_two_process_bringup(world):
    """The counterpart of ``test_multihost.py``: ``initialize_multihost``
    joins the ranks and a sum crosses the process boundary."""
    w, outs = world
    for o in outs:
        assert float(o["bringup"][0]) == w * (w + 1) / 2


def test_mesh_shape(world, jax_ref):
    w, outs = world
    for name in MESH_CFGS:
        shape = jax_ref[f"mesh_{w}_{name}"]
        coords = [tuple(o[f"mesh_{name}"][2:]) for o in outs]
        for o in outs:
            assert tuple(o[f"mesh_{name}"][:2]) == shape, name
        inside = [c for c in coords if c != (-1, -1)]
        # Ranks fill the mesh row-major; the rest are outside it.
        assert inside == [divmod(r, shape[1]) for r in range(shape[0] * shape[1])], name
        assert len(coords) - len(inside) == w - shape[0] * shape[1]
    if w == 4:
        assert jax_ref["mesh_4_3x2"] == (3, 1)


@pytest.mark.parametrize("case", ["ba", "bapv"])
def test_dist_ba(world, jax_ref, case):
    """K=6, L=256 on (1, W); K=5, L=512 with point_valid on the 2x2 layout."""
    w, outs = world
    o = outs[0]
    _same_on_every_rank(outs, case + "_")
    if w == 1:
        for k in ("R", "t", "X", "cost", "initial_cost", "lam"):
            np.testing.assert_array_equal(o[f"{case}_{k}"], o[f"{case}_single_{k}"], err_msg=k)
    else:
        np.testing.assert_allclose(o[f"{case}_R"], jax_ref[f"{case}_R"], rtol=0, atol=5e-4)
        np.testing.assert_allclose(o[f"{case}_t"], jax_ref[f"{case}_t"], rtol=0, atol=5e-3)
        np.testing.assert_allclose(o[f"{case}_X"], jax_ref[f"{case}_X"], rtol=0, atol=5e-3)
    assert np.isfinite(o[f"{case}_X"]).all()
    # test_sharding.py's bars: 0.1 of the initial cost, 0.2 with point_valid.
    bar = 0.1 if case == "ba" else 0.2
    assert float(o[f"{case}_cost"]) < bar * float(o[f"{case}_initial_cost"])


@pytest.fixture(scope="module")
def per_frame(problems):
    """The port's own per-frame ``extract_features`` of every frame."""
    cfg = FrontendConfig(**FE)
    return {images: [extract_features(torch.from_numpy(im), cfg.threshold, cfg)
                     for im in problems[0]["fe_" + images]] for images in ("room", "dots")}


@pytest.mark.parametrize("layout", ["grid", "frames"])
@pytest.mark.parametrize("images", ["room", "dots"])
def test_frontend_dp(world, jax_ref, per_frame, images, layout):
    """4 frames of 96x128, split over ``frame`` (the 2x2 layout replicates
    over ``landmark``): each frame bit-equal to the port's per-frame
    extraction, and to the JAX sharded batch within test_sharding.py's
    tolerances.  On the dot grids every dot is symmetric, its centroid
    moments are sums that cancel, and the port's moments round as the JAX
    package's eager ones do while its jitted XLA program rounds some
    otherwise (up to 1.7e-5): the orientations still agree within 1e-5, but
    they sit on BRIEF bin edges, so the binned descriptors are compared on
    the room frames only."""
    w, outs = world
    case = f"fe_{images}_{layout}"
    _same_on_every_rank(outs, case + "_")
    o = outs[0]
    for i, single in enumerate(per_frame[images]):
        for k in FIELDS:
            np.testing.assert_array_equal(o[f"{case}_{k}"][i], getattr(single, k).numpy(),
                                          err_msg=f"frame {i}: {k}")
    ref = lambda k: jax_ref[f"fe_{images}_{k}"]  # noqa: E731
    for k in ("valid", "level") + (("desc",) if images == "room" else ()):
        np.testing.assert_array_equal(o[f"{case}_{k}"].view(ref(k).dtype), ref(k), err_msg=k)
    np.testing.assert_allclose(o[f"{case}_xy"], ref("xy"), rtol=0, atol=1e-5)
    np.testing.assert_allclose(o[f"{case}_angle"], ref("angle"), rtol=0, atol=1e-4)
    assert o[f"{case}_valid"].sum(-1).min() > 20


def test_edge_sharded_pose_graph(world, jax_ref):
    """n=16, a loop of 16 edges padded with 8 invalid ones, on (1, W)."""
    w, outs = world
    o = outs[0]
    _same_on_every_rank(outs, "pg_")
    if w == 1:
        for k in ("R", "t", "costs"):
            np.testing.assert_array_equal(o[f"pg_{k}"], o[f"pg_single_{k}"], err_msg=k)
    else:
        np.testing.assert_allclose(o["pg_R"], jax_ref["pg_R"], rtol=0, atol=5e-4)
        np.testing.assert_allclose(o["pg_t"], jax_ref["pg_t"], rtol=0, atol=5e-3)
    assert o["pg_costs"][-1] < o["pg_costs"][0]


def test_node_sharded_pose_graph(world, jax_ref, problems):
    """n=64, halo 12, 80 iterations, D = W: the camera centres converge to
    the replicated solver's optimum."""
    w, outs = world
    o = outs[0]
    _same_on_every_rank(outs, "node_")
    assert o["node_costs"].shape == (3 * NODE["iters"],)
    err = np.linalg.norm(_centres(o["node_R"], o["node_t"]) - jax_ref["node_optimum"], axis=-1)
    assert err.max() < 0.05, err.max()
    arr = problems[0]
    drift = np.linalg.norm(_centres(arr["node_R"], arr["node_t"]) - jax_ref["node_optimum"],
                           axis=-1)
    assert drift.max() > 0.1


@pytest.mark.parametrize("n,shards,halo", [(64, 4, 12), (64, 1, 12), (16, 4, 0),
                                           (30, 3, 20)])
def test_partition_edges_by_node_matches_jax(n, shards, halo):
    rng = np.random.default_rng(n + shards + halo)
    ei = rng.integers(0, n, 3 * n).astype(np.int32)
    ej = rng.integers(0, n, 3 * n).astype(np.int32)
    got = partition_edges_by_node(ei, ej, n, shards, halo)
    want = j_partition(ei, ej, n, shards, halo)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    """No fallback: without CUDA, make_mesh() and initialize_multihost()
    raise unless given "cpu" or "gloo"; no coordinator is a no-op."""
    import torch.distributed as dist

    from tinyslam_tpu_torch.parallel import initialize_multihost, make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        initialize_multihost("127.0.0.1:1", 1, 0)
    initialize_multihost()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh(device_type="cpu")


def test_parallel_package_is_lazy():
    """Importing the package and its names creates no process group and
    imports no solver until one is used."""
    script = ("import sys; sys.modules['jax'] = None\n"
              "import torch.distributed as dist, tinyslam_tpu_torch.parallel as p\n"
              "assert 'tinyslam_tpu_torch.parallel.dist_ba' not in sys.modules\n"
              "p.bundle_adjust_sharded, p.make_mesh, p.partition_edges_by_node\n"
              "assert 'tinyslam_tpu_torch.parallel.dist_ba' in sys.modules\n"
              "assert not dist.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _images(kind: str, b: int) -> torch.Tensor:
    rng = np.random.default_rng(b)
    if kind == "float32":
        return torch.from_numpy(rng.random((b, 96, 128), np.float32))
    shape = (b, 96, 128, 3) if kind == "rgb" else (b, 96, 128)
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8))


@pytest.mark.parametrize("kind", ["float32", "uint8", "rgb"])
@pytest.mark.parametrize("b", [1, 3])
def test_extract_batch_equals_per_frame(kind, b):
    cfg = FrontendConfig(**FE)
    images = _images(kind, b)
    batch = extract_batch(images, cfg.threshold, cfg)
    assert batch.xy.shape == (b, cfg.max_features, 2)
    for i in range(b):
        single = extract_features(images[i], cfg.threshold, cfg)
        for k in FIELDS:
            assert torch.equal(getattr(batch, k)[i], getattr(single, k)), (i, k)
    assert int(batch.valid.sum()) > 50 * b


def test_fast_pyramid_maps_batched_plain_path():
    """(B, H_l, W_l) levels on the CPU: each frame's maps are the plain
    version's; levels of mixed rank or batch are refused."""
    gray = torch.from_numpy(np.random.default_rng(4).random((3, 96, 128), np.float32))
    t = torch.tensor(0.1)
    maps = fast_pyramid_maps(build_pyramid(gray, 3), t)
    assert len(maps) == 3
    for lvl, level_maps in enumerate(maps):
        for b in range(3):
            want = fast_maps(build_pyramid(gray[b], 3)[lvl], t)
            for got, w in zip(level_maps, want):
                assert got.shape[0] == 3 and torch.equal(got[b], w)
    with pytest.raises(ValueError):
        fast_pyramid_maps([gray, gray[0]], t)
    with pytest.raises(ValueError):
        fast_pyramid_maps([gray, gray[:2]], t)
