"""Full SLAM: visual odometry, place recognition and Sim(3) pose-graph
loop closure (mirrors ``tinyslam_tpu/models/slam.py``).

A loop candidate is verified by PnP-ing the CURRENT keyframe against the
OLD keyframe's landmarks, reached through descriptor chains (current
feature -> old keyframe feature -> the 3D point that keyframe associated
at its creation).  That pose lies in the old map's gauge, so comparing the
depths of the same scene under it and under the drifted odometry pose
measures the relative scale s_e of the new local map: the 7th residual
dimension an SE(3) graph cannot see.  A probe of all candidates reads the
device back once (``_loop_probe``, ``PROBE_FIELDS``).

After the Sim(3) solve, corrections are applied as similarities: keyframe
poses become (R, t / s), and each landmark moves and rescales with the
keyframe that created it:  X' = S_anchor_new^-1 ( T_anchor_old X ).

``Slam`` runs over the host-stepped ``VisualOdometry``; ``DeviceSlam``
over ``DeviceVO``, syncing keyframes at chunk boundaries.  Draws of the
loop probe's PnP-RANSAC come from the tracker's ``Sampler`` under the key
``("loop", kf_id * 131 + old_id)``, a hash of the sampler's seed and that
number computed where the number lies (``utils/draws.py``).

Each of the layer's three stages, ``kf_ingest``, ``loop_probe`` and
``solve_graph``, is one jitted dispatch with one readback in the JAX
package.  Each stage function here returns the stage's packed rows, read
back once, and one function unpacks them (``unpack_ingest``,
``unpack_probe``, ``unpack_solve``).  On the card a stage is one replay of
a captured CUDA graph (``utils/cuda_graph.py:Program``, one a stage,
shape, config and sampler type, the seed one of its inputs; captured
when a ``Slam`` is built or, for a solve's next padded shape, a few
keyframes before a solve can need it, and kept for the process);
elsewhere, or with ``eager=True``, the eager functions run
(``_ingest_rows``, ``_loop_probe``, ``_solve_rows``), which are the plain
versions.  The solve's 20 Gauss-Newton steps are one WHILE
node of its graph (``device_loop``).  The ingest's and the probe's graphs
share one memory pool; the solves', which the asynchronous back-end
replays on its worker thread, another.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from tinyslam_tpu_torch.backend.pose_graph import (
    optimize_pose_graph,
    optimize_pose_graph_sim3,
)
from tinyslam_tpu_torch.config import SlamConfig
from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.pnp import pnp_ransac
from tinyslam_tpu_torch.geometry.sim3 import sim3_compose, sim3_inverse, sim3_to_se3
from tinyslam_tpu_torch.models.vo import VisualOdometry, _match_to_map
from tinyslam_tpu_torch.models.vo_device import KF_RING, DeviceVO
from tinyslam_tpu_torch.ops.hamming import match_descriptors
from tinyslam_tpu_torch.ops.stats import nanmedian
from tinyslam_tpu_torch.models.vo import MapState
from tinyslam_tpu_torch.types import Features, descriptor_signs
from tinyslam_tpu_torch.utils.cuda_graph import (
    CAPTURE_LOCK,
    Program,
    indexed_device,
    tree_leaves,
)
from tinyslam_tpu_torch.utils.draws import Sampler, seed_word

SIGNATURE_BITS = 256     # a keyframe's place-recognition signature

# Per-candidate row of a probe's packed readback (float32; the counts are
# exact below 2^24).
PROBE_FIELDS = ("n_appear", "n_chain", "num_inliers", "rmse", "R", "t", "s_e",
                "n_scale_pairs", "s_e_med", "n_scale_old", "n_scale_new")
_PROBE_WIDTH = {"R": 9, "t": 3}


def _kf_signature(feats: Features) -> torch.Tensor:
    """Cheap global descriptor: the mean of the valid features' BRIEF sign
    vectors (256,), a poor man's bag of words for place recognition."""
    signs = descriptor_signs(feats.desc).to(torch.float32)
    w = feats.valid.to(torch.float32)[:, None]
    return (signs * w).sum(0) / torch.clamp_min(w.sum(), 1.0)


def _kf_ingest(cam: PinholeCamera, feats: Features, map_state, R: torch.Tensor,
               t: torch.Tensor, max_distance: int, ratio: float):
    """A keyframe's landmark association (guided by its own pose) and its
    place-recognition signature.

    The association is a 3D SNAPSHOT, each feature's landmark position
    frozen at keyframe creation, not live-map indices: the loop probe's
    old-gauge geometry then survives culling, slot reuse and submap
    reboots.  Returns (X (N, 3), ok (N,), signature (256,))."""
    idx, ok = _match_to_map(feats, map_state, max_distance, ratio, cam=cam, R=R, t=t)
    i = idx.long()
    return map_state.X[i], ok & map_state.valid[i], _kf_signature(feats)


def _ingest_rows(cam: PinholeCamera, feats: Features, map_state, R: torch.Tensor,
                 t: torch.Tensor, max_distance: int, ratio: float) -> torch.Tensor:
    """``_kf_ingest``'s outputs packed for one readback: X (3N), ok (N)
    and the signature (256), float32."""
    X, ok, sig = _kf_ingest(cam, feats, map_state, R, t, max_distance, ratio)
    return torch.cat([X.reshape(-1), ok.to(torch.float32), sig])


def unpack_ingest(rows) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An ingest's rows on the host as X (N, 3), ok (N,), signature (256,)."""
    rows = np.asarray(rows)
    n = (rows.size - SIGNATURE_BITS) // 4
    return rows[:3 * n].reshape(n, 3), rows[3 * n:4 * n] > 0.5, rows[4 * n:]


def _reanchor_landmarks(X, anchor_kf, valid, R_old, t_old, R_new, t_new, s_new=None):
    """Move landmarks with their anchor keyframe's correction.

    R_old/t_old (KF, 3, 3)/(KF, 3): SE(3) keyframe poses before the solve;
    R_new/t_new/s_new: the solved Sim(3) nodes.  A landmark rides the
    similarity X' = S_new^-1 (T_old X): with s_new it moves AND rescales
    (s_new None keeps the rigid SE(3) correction)."""
    a = anchor_kf.long().clamp(0, R_old.shape[0] - 1)
    Xc = torch.einsum("mij,mj->mi", R_old[a], X) + t_old[a]
    Xw = torch.einsum("mji,mj->mi", R_new[a], Xc - t_new[a])
    if s_new is not None:
        Xw = Xw / torch.clamp_min(s_new[a], 1e-6)[:, None]
    return torch.where(valid[:, None], Xw, X)


def _loop_probe(cam: PinholeCamera, cur: Features, old_feats: Features, old_ids,
                old_lm_X: torch.Tensor, old_lm_valid: torch.Tensor, map_state,
                anchor_offset, R_cur: torch.Tensor, t_cur: torch.Tensor, kf_id,
                sampler: Sampler, max_distance: int, ratio: float, num_hypotheses: int,
                pnp_iters: int, inlier_px: float) -> torch.Tensor:
    """The loop-closure measurement of C candidates: for each, appearance
    verification, the old-gauge PnP-RANSAC of the CURRENT keyframe and the
    relative-scale estimates.

    old_feats: Features with a leading C; old_ids: their global keyframe
    ids (C ints or a (C,) integer tensor); old_lm_X (C, N, 3) /
    old_lm_valid (C, N): their association snapshots; anchor_offset: the
    global id of the current submap's local keyframe 0; kf_id: the current
    keyframe's global id (each an int or a 0-d integer tensor: a captured
    probe takes them from its static buffers, so that nothing reads them
    on the host).  The candidates are unrolled, as in the reference.
    Returns the (C, len) float32 rows of ``PROBE_FIELDS``, on the device:
    the caller reads them back once (``unpack_probe``)."""

    def depth(R, t, X):
        return (X @ R.T + t)[..., 2]

    # New-gauge association of cur, shared by the candidates: landmarks the
    # drifted pose projects nearby, the "recent map" side of the ratio.
    idx_n, val_n = _match_to_map(cur, map_state, max_distance, ratio, cam=cam,
                                 R=R_cur, t=t_cur)
    in_ = idx_n.long()
    z_new = depth(R_cur, t_cur, map_state.X[in_])
    anchor_global = map_state.anchor_kf[in_] + anchor_offset
    nan = torch.full((), float("nan"), device=z_new.device)
    rows = []
    for c, old_id in enumerate(old_ids):
        old = old_feats.map(lambda x: x[c])
        m = match_descriptors(cur.desc, cur.valid, old.desc, old.valid,
                              max_distance=max_distance, ratio=ratio, cross_check=True)
        ib = m["idx_b"].long()
        # Chain: cur i -> old j = idx_b[i] -> the 3D point the old keyframe
        # associated at its creation (old gauge).
        X_chain = old_lm_X[c][ib]
        chain = m["valid"] & old_lm_valid[c][ib]
        # RANSAC, not refine-only: under real scale drift the odometry pose
        # can lie outside the Gauss-Newton basin (it rides along as a prior).
        sample = sampler.choice(chain, (num_hypotheses, 6), key=("loop", kf_id * 131 + old_id))
        out = pnp_ransac(cam, X_chain, cur.xy, chain, sample, inlier_px=inlier_px,
                         refine_iters=pnp_iters, R_prior=R_cur, t_prior=t_cur)
        # Relative scale: depth under the drifted pose (new gauge) over depth
        # under the old-gauge PnP pose.  Per feature where both associations
        # exist; the ratio of the two sides' median depths as the fallback.
        z_old = depth(out["R"], out["t"], X_chain)
        old_ok = chain & out["inliers"] & (z_old > 1e-3)
        new_ok = val_n & (anchor_global > old_id) & (z_new > 1e-3)
        both = old_ok & new_ok
        s_pair = nanmedian(torch.where(both, z_new / torch.clamp_min(z_old, 1e-6), nan))
        med_new = nanmedian(torch.where(new_ok, z_new, nan))
        med_old = nanmedian(torch.where(old_ok, z_old, nan))
        count = lambda b: b.sum().to(torch.float32)   # noqa: E731
        rows.append(torch.cat([
            torch.stack([count(m["valid"]), count(chain), out["num_inliers"].to(torch.float32),
                         out["rmse"]]),
            out["R"].reshape(9), out["t"],
            torch.stack([s_pair, count(both), med_new / torch.clamp_min(med_old, 1e-6),
                         count(old_ok), count(new_ok)])]))
    return torch.stack(rows)


def unpack_probe(rows) -> dict[str, np.ndarray]:
    """The probe's (C, len) rows, on the host, as arrays keyed by
    ``PROBE_FIELDS`` (R (C, 3, 3), t (C, 3), the rest (C,))."""
    rows = np.asarray(rows)
    out, k = {}, 0
    for name in PROBE_FIELDS:
        w = _PROBE_WIDTH.get(name, 1)
        v = rows[:, k:k + w]
        out[name] = v.reshape(-1, 3, 3) if name == "R" else v if w > 1 else v[:, 0]
        k += w
    return out


def padded_shape(pg, n: int, E: int) -> tuple[int, int]:
    """The padded (nodes, edges) of a graph of n nodes and E edges: to
    multiples of 32 and 128, capped at ``pg.max_nodes``/``max_edges``, as
    the JAX package pads them against recompiles."""
    return (max(min(-(-max(n, 1) // 32) * 32, pg.max_nodes), n),
            max(min(-(-max(E, 1) // 128) * 128, pg.max_edges), E))


def _blank_tables(n_pad: int, e_pad: int) -> dict[str, np.ndarray]:
    """``padded_graph``'s tables of an (n_pad, e_pad) graph with every node
    and edge masked."""
    eye = lambda k: np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))  # noqa: E731
    return {"R": eye(n_pad), "t": np.zeros((n_pad, 3), np.float32),
            "s": np.ones(n_pad, np.float32), "edge_i": np.zeros(e_pad, np.int64),
            "edge_j": np.zeros(e_pad, np.int64), "edge_R": eye(e_pad),
            "edge_t": np.zeros((e_pad, 3), np.float32), "edge_s": np.ones(e_pad, np.float32),
            "edge_weight": np.ones(e_pad, np.float32), "edge_valid": np.zeros(e_pad, bool),
            "node_valid": np.zeros(n_pad, bool)}


def padded_graph(pg, snap) -> tuple[dict[str, np.ndarray], int]:
    """The solve's tables of a snapshot (R_old (n, 3, 3), t_old (n, 3),
    edges), padded to ``padded_shape`` and masked, so that both packages
    solve the same system and one captured solve serves every graph of its
    padded shape.  Returns the tables (``_solve_rows``'s names) and n."""
    R_old, t_old, edges = snap
    n, E = len(R_old), len(edges)
    tb = _blank_tables(*padded_shape(pg, n, E))
    tb["R"][:n], tb["t"][:n] = R_old, t_old
    for k, e in enumerate(edges):
        (tb["edge_i"][k], tb["edge_j"][k], tb["edge_R"][k], tb["edge_t"][k], tb["edge_s"][k],
         tb["edge_weight"][k]) = e
    tb["edge_valid"][:E] = True
    tb["node_valid"][:n] = True
    return tb, n


def _solve_rows(sim3: bool, iters: int, tb: dict[str, torch.Tensor]) -> torch.Tensor:
    """The pose-graph solve of ``padded_graph``'s tables (tensors on one
    device): (n_pad, 13) float32 rows of the solved nodes, R (9), t (3), s
    (with ``sim3`` off the SE(3) solver runs and s is one)."""
    common = dict(edge_valid=tb["edge_valid"], edge_weight=tb["edge_weight"],
                  node_valid=tb["node_valid"], iters=iters)
    if sim3:
        out = optimize_pose_graph_sim3(tb["R"], tb["t"], tb["s"], tb["edge_i"], tb["edge_j"],
                                       tb["edge_R"], tb["edge_t"], tb["edge_s"], **common)
        s = out["s"]
    else:
        out = optimize_pose_graph(tb["R"], tb["t"], tb["edge_i"], tb["edge_j"], tb["edge_R"],
                                  tb["edge_t"], **common)
        s = torch.ones_like(tb["s"])
    return torch.cat([out["R"].reshape(-1, 9), out["t"], s[:, None]], 1)


def unpack_solve(rows) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A solve's (n, 13) rows on the host as the nodes' R (n, 3, 3), t (n,
    3), s (n,)."""
    rows = np.asarray(rows)
    return (np.ascontiguousarray(rows[:, :9]).reshape(-1, 3, 3),
            np.ascontiguousarray(rows[:, 9:12]), np.ascontiguousarray(rows[:, 12]))


# ---------------- the stages: a captured program on the card ----------------
_PROGRAMS: dict = {}
_POOLS: dict = {}


def _program_key(kind: str, params: tuple, inputs, device: torch.device) -> tuple:
    return (kind, params, indexed_device(device),
            tuple((tuple(x.shape), x.dtype) for x in tree_leaves(inputs)))


def _program(kind: str, params: tuple, fn, inputs, device: torch.device) -> Program:
    """The ``Program`` of ``fn`` for this stage, config (``params``), device
    and input shapes, captured at first use (warmed on that call's inputs)
    and kept for the process.  The solves share one memory pool, the
    ingests and probes another: a solve may replay on the back-end's worker
    while the main thread probes, and each stage reads its outputs back
    before the next replay of its pool."""
    device = indexed_device(device)
    key = _program_key(kind, params, inputs, device)
    program = _PROGRAMS.get(key)
    if program is None:
        with CAPTURE_LOCK:
            if key not in _PROGRAMS:
                pool = (device, kind == "solve")
                if pool not in _POOLS:
                    _POOLS[pool] = torch.cuda.graph_pool_handle()
                _PROGRAMS[key] = Program(fn, inputs, device, pool=_POOLS[pool])
            program = _PROGRAMS[key]
    return program


def _cpu_tensor(a, dtype=np.float32) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _ingest_params(cfg: SlamConfig) -> dict:
    return dict(max_distance=cfg.matcher.max_distance, ratio=cfg.matcher.ratio)


def _ingest_spec(cam: PinholeCamera, cfg: SlamConfig, feats: Features, map_state, R, t):
    """``kf_ingest``'s program: (kind, params, body, inputs)."""
    kw = _ingest_params(cfg)
    inputs = {"feats": feats, "map": map_state, "R": _cpu_tensor(R), "t": _cpu_tensor(t)}
    return ("ingest", (cam, tuple(kw.items())),
            lambda s: _ingest_rows(cam, s["feats"], s["map"], s["R"], s["t"], **kw), inputs)


def kf_ingest(cam: PinholeCamera, cfg: SlamConfig, feats: Features, map_state, R, t,
              eager: bool = False) -> np.ndarray:
    """A keyframe's association snapshot and signature (``_kf_ingest``) at
    its pose (R, t numpy) as packed rows, read back once
    (``unpack_ingest``).  On the card one replay of a captured program, or
    with ``eager`` the eager function there; elsewhere the eager
    function."""
    dev = feats.desc.device
    if dev.type == "cuda" and not eager:
        spec = _ingest_spec(cam, cfg, feats, map_state, R, t)
        rows = _program(*spec, dev)(spec[3])
    else:
        rows = _ingest_rows(cam, feats, map_state, _cpu_tensor(R).to(dev),
                            _cpu_tensor(t).to(dev), **_ingest_params(cfg))
    return rows.cpu().numpy()


def _probe_params(cfg: SlamConfig) -> dict:
    return dict(max_distance=cfg.matcher.max_distance, ratio=cfg.matcher.ratio,
                num_hypotheses=cfg.vo.reloc_hypotheses, pnp_iters=cfg.vo.pnp_iters,
                inlier_px=cfg.vo.pnp_inlier_px)


def _probe_spec(cam: PinholeCamera, cfg: SlamConfig, cur: Features, old_feats: Features,
                old_ids, old_lm_X, old_lm_valid, map_state, anchor_offset: int, R_cur, t_cur,
                kf_id: int, sampler: Sampler):
    """``loop_probe``'s program: (kind, params, body, inputs).  The ids, the
    offset and the sampler's seed are device scalars in its static buffers,
    and the draws are keyed on the device by that seed: one program serves
    every seed."""
    kw = _probe_params(cfg)
    inputs = {"cur": cur, "old": old_feats, "old_ids": _cpu_tensor(old_ids, np.int64),
              "old_X": _cpu_tensor(old_lm_X), "old_ok": _cpu_tensor(old_lm_valid, np.bool_),
              "map": map_state, "anchor_offset": torch.tensor(int(anchor_offset)),
              "R": _cpu_tensor(R_cur), "t": _cpu_tensor(t_cur),
              "kf_id": torch.tensor(int(kf_id)),
              "seed": torch.tensor(seed_word(sampler), dtype=torch.int64)}

    def probe(s):
        return _loop_probe(cam, s["cur"], s["old"], s["old_ids"], s["old_X"], s["old_ok"],
                           s["map"], s["anchor_offset"], s["R"], s["t"], s["kf_id"],
                           sampler.keyed_on(s["seed"]), **kw)

    params = (cam, tuple(kw.items()), type(sampler))
    return "probe", params, probe, inputs


def loop_probe(cam: PinholeCamera, cfg: SlamConfig, cur: Features, old_feats: Features,
               old_ids, old_lm_X, old_lm_valid, map_state, anchor_offset: int, R_cur, t_cur,
               kf_id: int, sampler: Sampler, eager: bool = False) -> np.ndarray:
    """``_loop_probe``'s (C, len) rows, read back once (``unpack_probe``):
    the host's numbers (old_ids, the snapshots old_lm_X (C, N, 3) and
    old_lm_valid (C, N), anchor_offset, R_cur, t_cur, kf_id) as numpy or
    ints, the features and the map on the device.  On the card one replay
    of a captured program, or with ``eager`` the eager function there with
    the ids as ints; elsewhere the eager function."""
    dev = cur.desc.device
    if dev.type == "cuda" and not eager:
        spec = _probe_spec(cam, cfg, cur, old_feats, old_ids, old_lm_X, old_lm_valid,
                           map_state, anchor_offset, R_cur, t_cur, kf_id, sampler)
        rows = _program(*spec, dev)(spec[3])
    else:
        T = lambda a, dtype=np.float32: _cpu_tensor(a, dtype).to(dev)   # noqa: E731
        rows = _loop_probe(cam, cur, old_feats, [int(i) for i in old_ids], T(old_lm_X),
                           T(old_lm_valid, np.bool_), map_state, int(anchor_offset), T(R_cur),
                           T(t_cur), int(kf_id), sampler, **_probe_params(cfg))
    return rows.cpu().numpy()


def solve_graph(cfg: SlamConfig, snap, device, eager: bool = False) -> np.ndarray:
    """Solve a snapshot (R_old (n, 3, 3), t_old (n, 3), edges) on
    ``device``, padded by ``padded_graph``: the solved Sim(3) nodes' (n,
    13) rows, read back once (``unpack_solve``; with ``cfg.pose_graph.sim3``
    off the SE(3) solver runs and s is all ones).  On the card one replay
    of the captured solve of the padded shape (``solve_program``) on the
    current stream, or with ``eager`` the eager ``_solve_rows`` there;
    elsewhere the eager function."""
    pg = cfg.pose_graph
    dev = torch.device(device)
    tables, n = padded_graph(pg, snap)
    inputs = {k: torch.from_numpy(v) for k, v in tables.items()}
    if dev.type == "cuda" and not eager:
        # A capture on another thread must not see this readback (and
        # solves replay one at a time: they share the buffers of a shape).
        with CAPTURE_LOCK:
            return solve_program(pg, *padded_shape(pg, n, len(snap[2])), dev)(
                inputs)[:n].cpu().numpy()
    return _solve_rows(pg.sim3, pg.gn_iters, {k: v.to(dev) for k, v in inputs.items()}
                       )[:n].cpu().numpy()


def _solve_spec(pg, n_pad: int, e_pad: int):
    """The solve's program at a padded shape: (kind, params, body, inputs),
    the inputs every node and edge masked."""
    inputs = {k: torch.from_numpy(v) for k, v in _blank_tables(n_pad, e_pad).items()}
    return ("solve", (pg.sim3, pg.gn_iters),
            lambda s: _solve_rows(pg.sim3, pg.gn_iters, s), inputs)


def solve_captured(pg, n_pad: int, e_pad: int, device) -> bool:
    """Whether the solve of this padded shape is captured on ``device``."""
    kind, params, _, inputs = _solve_spec(pg, n_pad, e_pad)
    return _program_key(kind, params, inputs, device) in _PROGRAMS


def solve_program(pg, n_pad: int, e_pad: int, device) -> Program:
    """The captured solve of a padded shape on the card, captured here on
    first use (warmed on a graph with every node and edge masked)."""
    return _program(*_solve_spec(pg, n_pad, e_pad), device)


def capture_slam_programs(cam: PinholeCamera, cfg: SlamConfig, sampler: Sampler,
                          device) -> None:
    """Capture the layer's programs on the card before their first use,
    without replaying them: the ingest and the probe at the config's shapes
    (N features, the map's capacity, C candidates) and the solve of the
    first padded shape, so that no stage pays a capture on the tracking
    path."""
    dev = indexed_device(device)
    N, C = cfg.frontend.max_features, max(2, cfg.pose_graph.loop_candidates)
    feats = Features.empty(N, dev)
    stack = feats.map(lambda x: x.expand(C, *x.shape).clone())
    map_state = MapState.empty(cfg.vo.max_map_points, dev)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    _program(*_ingest_spec(cam, cfg, feats, map_state, eye, zero), dev)
    _program(*_probe_spec(cam, cfg, feats, stack, np.zeros(C, np.int64),
                          np.zeros((C, N, 3), np.float32), np.zeros((C, N), bool), map_state,
                          0, eye, zero, 0, sampler), dev)
    solve_program(cfg.pose_graph, *padded_shape(cfg.pose_graph, 0, 0), dev)


def _host(fn, *arrays) -> tuple[np.ndarray, ...]:
    """Apply a torch group operation to float32 numpy arrays on the CPU."""
    out = fn(*(torch.from_numpy(np.array(a, np.float32)) for a in arrays))
    return tuple(o.numpy() for o in out)


def _world_moved(W, R, t) -> tuple[np.ndarray, ...]:
    """Poses (R (F, 3, 3), t (F, 3)) composed on the world side with the
    similarity W = (R_w, t_w, s_w): the Sim(3) T o W and its SE(3) pose,
    (R, t, s, R_se, t_se)."""
    F = len(R)

    def move(R, t, one, R_w, t_w, s_w):
        out = sim3_compose(R, t, one, R_w, t_w, s_w)
        return out + sim3_to_se3(*out)

    return _host(move, R, t, np.ones(F), np.broadcast_to(W[0], (F, 3, 3)),
                 np.broadcast_to(W[1], (F, 3)), np.full(F, W[2]))


def _window(state) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(valid (K,), kf ids (K,), R (K, 3, 3), t (K, 3)) of a VOState's window,
    in one readback."""
    K = state.win_valid.shape[0]
    packed = torch.cat([state.win_valid.to(torch.float32), state.win_kf_id.to(torch.float32),
                        state.win_R.reshape(-1), state.win_t.reshape(-1)]).cpu().numpy()
    return (packed[:K] > 0.5, packed[K:2 * K].astype(np.int64),
            packed[2 * K:11 * K].reshape(K, 3, 3), packed[11 * K:].reshape(K, 3))


class Slam:
    """VO with loop closure over the host-stepped ``VisualOdometry``; use
    it like the tracker (``process``/``run``).

    With ``async_backend`` the pose-graph solve runs on a supervised worker
    thread (``utils/faults.py:Watchdog``; on a GPU on a CUDA stream of its
    own), so tracking does not wait for it: the correction is applied at
    the first frame boundary after the solve finishes, and the frames
    tracked meanwhile are rescaled then (``_landed_late``).  Only once a
    solve is ``solve_lag_frames`` frames old (None: never) does tracking
    wait for it, at the next boundary: until the correction lands, every
    frame is tracked against the uncorrected map.  ``finalize()`` (which
    ``run`` calls) applies a solve still in flight.  ``sampler`` draws every
    RANSAC sample (a ``Sampler(0)`` if None); ``device`` is required.
    """

    # Frames after which tracking waits for an asynchronous solve (None:
    # never): 16 is half a second of a 30 Hz camera, about one solve.
    solve_lag_frames: int | None = 16
    # Keyframes (and edges) ahead of the graph at which the next padded
    # solve shape is captured on the card (``_capture_solve_ahead``).
    solve_ahead: int = 4

    def __init__(self, cfg: SlamConfig, camera: PinholeCamera, async_backend: bool = False,
                 solve_timeout_s: float = 30.0, sampler: Sampler | None = None, *, device):
        self.cfg = cfg
        self.camera = camera
        self.sampler = Sampler() if sampler is None else sampler
        self.vo = self._make_tracker(torch.device(device))
        self.device = self.vo.device
        if self.device.type == "cuda":
            capture_slam_programs(camera, cfg, self.sampler, self.device)
        self.kf_store: list[Features] = []       # per-keyframe features
        # Per-keyframe feature -> landmark 3D snapshot (X (N, 3), ok (N,)),
        # frozen at creation: the loop probe's old gauge.  Snapshots ride
        # their keyframe's Sim(3) correction whenever a solve is applied.
        self.kf_assoc: list[tuple[np.ndarray, np.ndarray]] = []
        self.kf_signatures: list[np.ndarray] = []
        self.kf_R: list[np.ndarray] = []         # running best pose per keyframe
        self.kf_t: list[np.ndarray] = []
        self.kf_frame_of: dict[int, int] = {}    # keyframe id -> global frame
        # Sim(3) edges (i, j, R, t, s, weight) measuring S_j o S_i^-1
        # (odometry edges carry s = 1).
        self.edges: list[tuple[int, int, np.ndarray, np.ndarray, float, float]] = []
        self.num_loop_closures = 0
        self.loop_log: list[dict] = []           # every evaluated candidate
        self.timings: dict[str, float] = {}      # wall seconds by stage
        self._loop_cooldown_until = 0
        # (snapshot, frames tracked, submap) at each asynchronous submit.
        self._submits: list[tuple] = []
        self._worker = None
        self._stream = None
        if async_backend:
            from tinyslam_tpu_torch.utils.faults import Watchdog

            self._worker = Watchdog(solve_timeout_s=solve_timeout_s)
            if self.device.type == "cuda":
                # The legacy default stream is shared by every thread: a
                # solve there would serialize with tracking.
                self._stream = torch.cuda.Stream(self.device)

    def _make_tracker(self, device: torch.device):
        return VisualOdometry(self.cfg, self.camera, device=device, sampler=self.sampler)

    @contextlib.contextmanager
    def _timed(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[key] = self.timings.get(key, 0.0) + time.perf_counter() - t0

    # ------------- keyframe bookkeeping -------------
    def _sync_new_keyframes(self):
        """Pull the keyframes the tracker created since the last call; the
        features come from the keyframe's own window slot."""
        vo = self.vo
        while len(self.kf_store) < vo.num_keyframes:
            kf_id = len(self.kf_store)
            _, R, t = vo.kf_poses_log[kf_id]
            if kf_id < len(vo.kf_frames_log):
                self.kf_frame_of[kf_id] = vo.kf_frames_log[kf_id]
            slots = np.nonzero(vo.win_valid & (vo.win_kf_id == kf_id))[0]
            if len(slots) and vo.win_feats[int(slots[0])] is not None:
                feats = vo.win_feats[int(slots[0])]
            elif kf_id == 0 and vo.kf0_feats is not None:
                feats = vo.kf0_feats
            else:
                feats = vo.kf_feats
            self._append_keyframe(kf_id, R, t, feats)

    def _append_keyframe(self, kf_id: int, R, t, feats: Features, edge_weight: float = 1.0):
        assert kf_id == len(self.kf_store)
        self.kf_R.append(np.asarray(R, np.float32))
        self.kf_t.append(np.asarray(t, np.float32))
        self.kf_store.append(feats)
        # Freeze the keyframe's association snapshot against the map as it
        # is NOW, and its signature: one packed readback.
        with self._timed("kf_ingest"):
            X, ok, sig = unpack_ingest(kf_ingest(self.camera, self.cfg, feats, self.vo.map,
                                                 self.kf_R[-1], self.kf_t[-1]))
        self.kf_assoc.append((X, ok))
        self.kf_signatures.append(sig)
        if kf_id > 0:
            Rp, tp = self.kf_R[kf_id - 1], self.kf_t[kf_id - 1]
            Re = self.kf_R[-1] @ Rp.T
            self.edges.append((kf_id - 1, kf_id, Re, self.kf_t[-1] - Re @ tp, 1.0,
                               float(edge_weight)))
            self._detect_loop(kf_id)
        self._capture_solve_ahead()

    # ------------- loop closure -------------
    def _detect_loop(self, kf_id: int):
        pg = self.cfg.pose_graph
        if kf_id < pg.loop_min_gap or kf_id < self._loop_cooldown_until:
            return
        old_ids = np.arange(0, kf_id - pg.loop_min_gap + 1)
        if len(old_ids) == 0:
            return
        # Top-C place recognition: one matmul over the stacked signatures.
        sims = np.stack(self.kf_signatures[:len(old_ids)]) @ self.kf_signatures[kf_id]
        C = max(2, pg.loop_candidates)
        n_cand = min(C, len(old_ids))
        cand = old_ids[np.argsort(-sims)[:n_cand]].astype(np.int32)
        if n_cand < C:                  # a fixed candidate count: pad by repeat
            cand = np.concatenate([cand, np.repeat(cand[:1], C - n_cand)])
        cand = [int(c) for c in cand]
        old_stack = Features(**{
            f.name: torch.stack([getattr(self.kf_store[c], f.name) for c in cand])
            for f in dataclasses.fields(Features)})
        with self._timed("loop_probe"):
            probe = unpack_probe(loop_probe(
                self.camera, self.cfg, self.kf_store[kf_id], old_stack, cand,
                np.stack([self.kf_assoc[c][0] for c in cand]),
                np.stack([self.kf_assoc[c][1] for c in cand]), self.vo.map,
                self._anchor_offset(), self.kf_R[kf_id], self.kf_t[kf_id], kf_id,
                self.sampler))
        seen = set()
        for c, old in enumerate(cand):
            if old in seen:
                continue
            seen.add(old)
            n_in = int(probe["num_inliers"][c])
            n_chain = max(int(probe["n_chain"][c]), 1)
            rmse = float(probe["rmse"][c])
            rec = {"kf": kf_id, "old": old, "n_appear": int(probe["n_appear"][c]),
                   "n_chain": n_chain, "num_inliers": n_in, "rmse": rmse,
                   "s_e": float(probe["s_e"][c]),
                   "n_scale_pairs": int(probe["n_scale_pairs"][c]),
                   "s_e_med": float(probe["s_e_med"][c]),
                   "n_scale_old": int(probe["n_scale_old"][c]),
                   "n_scale_new": int(probe["n_scale_new"][c]), "accepted": False}
            self.loop_log.append(rec)
            if rec["n_appear"] < pg.loop_min_matches:
                continue
            if (n_in < pg.loop_min_matches or n_in / n_chain < pg.loop_min_inlier_ratio
                    or not np.isfinite(rmse) or rmse > pg.loop_max_rmse_px):
                continue
            rec["accepted"] = True
            # Relative scale of the new local map: the per-feature ratio with
            # enough pairs, else the median-of-medians fallback at reduced
            # weight (its two landmark subsets may be distributed unlike),
            # else no scale information.
            s_e, weight = rec["s_e"], 5.0
            if rec["n_scale_pairs"] < pg.loop_min_scale_pairs or not np.isfinite(s_e):
                s_e, weight = rec["s_e_med"], 2.0
                if (min(rec["n_scale_old"], rec["n_scale_new"]) < pg.loop_min_scale_pairs
                        or not np.isfinite(s_e)):
                    s_e = 1.0
            if not (0.2 < s_e < 5.0):
                s_e = 1.0
            # Sim(3) edge old -> new: S_new_meas o S_old_meas^-1, with S_old the
            # old keyframe's pose at unit scale and S_new the old-gauge PnP
            # pose at the local scale s_e.
            Re, te, se = _host(lambda *a: sim3_compose(*a[:3], *sim3_inverse(*a[3:])),
                               probe["R"][c], probe["t"][c] * s_e, s_e,
                               self.kf_R[old], self.kf_t[old], 1.0)
            self.edges.append((old, kf_id, Re, te, float(se), weight))
            self.num_loop_closures += 1
            self._loop_cooldown_until = kf_id + 1 + pg.loop_cooldown
            self._optimize_graph()
            return

    def _optimize_graph(self):
        if len(self.kf_R) < 3 or not self.edges:
            return
        snap = (np.stack(self.kf_R), np.stack(self.kf_t), list(self.edges))
        if self._worker is not None:
            if self.device.type == "cuda":
                # A padded shape not captured ahead (``_capture_solve_ahead``)
                # is captured here, on the tracking thread: the worker only
                # replays.
                solve_program(self.cfg.pose_graph,
                              *padded_shape(self.cfg.pose_graph, len(snap[0]), len(snap[2])),
                              self.device)
            # Latest-wins: a newer snapshot contains every edge of an older one.
            self._submits.append((snap, len(self.vo.trajectory), self._submap()))
            self._worker.submit(lambda: (snap, self._solve_on_worker(snap)))
        else:
            with self._timed("graph_solve"):
                self._apply_graph_result(snap, self._solve_graph(snap))

    def _solve_graph(self, snap):
        return unpack_solve(solve_graph(self.cfg, snap, self.device))

    def _capture_solve_ahead(self):
        """On the card, capture the solve of the padded shape the graph
        reaches within ``solve_ahead`` more keyframes and edges, before a
        solve can need it: on the tracking thread (a capture makes every
        thread's readbacks an error while it warms) and, with the
        asynchronous back-end, only while no solve is in flight (a later
        keyframe tries again)."""
        if self.device.type != "cuda" or (self._worker is not None and self._worker.busy):
            return
        pg = self.cfg.pose_graph
        n, E = len(self.kf_R), len(self.edges)
        shapes = {padded_shape(pg, n, E),
                  padded_shape(pg, n + self.solve_ahead, E + self.solve_ahead)}
        shapes = [sh for sh in shapes if not solve_captured(pg, *sh, self.device)]
        if shapes:
            with self._timed("solve_capture"):
                for sh in sorted(shapes):
                    solve_program(pg, *sh, self.device)

    def _solve_on_worker(self, snap):
        if self._stream is None:
            return self._solve_graph(snap)
        # The readback at the end waits for this stream only.
        with torch.cuda.stream(self._stream):
            return self._solve_graph(snap)

    @staticmethod
    def _extend_solution(snap, solved, kf_R, kf_t):
        """Extend the solved node tables to keyframes created while an
        asynchronous solve ran (they ride the newest solved node's
        similarity correction) and compute the corrected SE(3) poses.
        Returns (R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n)."""
        R_old, t_old, _ = snap
        R_sim, t_sim, s_sim = solved
        n, total = len(R_old), len(kf_R)
        corr = _host(lambda *a: sim3_compose(*a[:3], *sim3_inverse(*a[3:])),
                     R_sim[n - 1], t_sim[n - 1], s_sim[n - 1], R_old[n - 1], t_old[n - 1], 1.0)
        if total > n:
            ext_R, ext_t = np.stack(kf_R[n:]), np.stack(kf_t[n:])
            ext = _host(lambda *a: sim3_compose(*a[:3], *a[3:]), corr[0][None], corr[1][None],
                        corr[2][None], ext_R, ext_t, np.ones(total - n, np.float32))
            R_old, t_old = np.concatenate([R_old, ext_R]), np.concatenate([t_old, ext_t])
            R_sim, t_sim, s_sim = (np.concatenate([a, b]) for a, b in
                                   zip((R_sim, t_sim, s_sim), ext))
            n = total
        R_se, t_se = _host(sim3_to_se3, R_sim, t_sim, s_sim)
        return R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n

    def _anchor_offset(self) -> int:
        """Global keyframe id of the current submap's local keyframe 0 (the
        host tracker never reboots)."""
        return 0

    def _submap(self) -> tuple[int, int]:
        return self._anchor_offset(), getattr(self.vo, "num_reboots", 0)

    def _landed_late(self, snap, ext):
        """Rescale what was tracked while an asynchronous solve ran.

        Those frames were tracked in the snapshot's gauge, after its newest
        keyframe; had the solve landed at once, as a synchronous one does,
        the map would have been rescaled before them.  W = S_old^-1 o
        S_solved, the world-side similarity of that keyframe, moves the
        snapshot's gauge into the corrected one.  Each keyframe created
        meanwhile and the live pose take it (T' = T o W, to SE(3)), where
        ``_extend_solution`` (the reference's) composes on the camera side,
        which agrees only near that keyframe and keeps the motion since it
        at the old scale.  Each frame tracked meanwhile is rewritten in the
        raw trajectory so that ``corrected_trajectory`` gives it SE(3)(T o
        W): moved by W where its keyframe was created meanwhile, and where
        its keyframe is older, its motion since that keyframe divided by
        the scale.  ``ext`` is ``_extend_solution``'s output; returns it
        with the new keyframes' rows replaced and W, or ``ext`` and None
        when no frame was tracked meanwhile or the tracker rebooted since
        (the frames then lie in another submap's gauge)."""
        i = next((k for k, e in enumerate(self._submits) if e[0] is snap), None)
        if i is None:
            return ext, None
        _, first, submap = self._submits[i]
        del self._submits[:i + 1]
        traj = self.vo.trajectory
        if first >= len(traj) or submap != self._submap():
            return ext, None
        R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n = ext
        m = len(snap[0]) - 1
        W = _host(lambda *a: sim3_compose(*sim3_inverse(*a[:3]), *a[3:]),
                  R_old[m], t_old[m], 1.0, R_sim[m], t_sim[m], s_sim[m])
        moved = _world_moved(W, np.stack([R for R, _ in traj[first:]]),
                             np.stack([t for _, t in traj[first:]]))[3:]
        kf_frames = sorted(f for k, f in self.kf_frame_of.items() if k < n)
        for f in range(first, len(traj)):
            fk = max((g for g in kf_frames if g <= f), default=first)
            if fk >= first:
                traj[f] = (moved[0][f - first], moved[1][f - first])
            else:
                (R_k, t_k), (R_f, t_f) = traj[fk], traj[f]
                R_rel = R_f @ R_k.T
                traj[f] = (R_f, R_rel @ t_k + (t_f - R_rel @ t_k) / W[2])
        if n > m + 1:
            R_sim, t_sim, s_sim, R_se, t_se = (a.copy() for a in (R_sim, t_sim, s_sim, R_se,
                                                                  t_se))
            k = slice(m + 1, n)
            R_sim[k], t_sim[k], s_sim[k], R_se[k], t_se[k] = _world_moved(W, R_old[k], t_old[k])
        return (R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n), W

    def _world_pose(self, W, R, t):
        """The live pose moved by ``_landed_late``'s W."""
        R_new, t_new = _world_moved(W, R.cpu().numpy()[None], t.cpu().numpy()[None])[3:]
        return (torch.from_numpy(R_new[0]).to(self.device),
                torch.from_numpy(t_new[0]).to(self.device))

    def _reanchor_assoc_snapshots(self, R_old, t_old, R_sim, t_sim, s_sim, n):
        """Ride each keyframe's Sim(3) correction into its association
        snapshot: the snapshots define the probe's old gauge, and a snapshot
        left behind makes every later loop edge against a corrected keyframe
        measure a phantom offset."""
        n = min(n, len(self.kf_assoc))
        if n == 0:
            return
        cap = self.kf_assoc[0][0].shape[0]
        Xs = np.stack([self.kf_assoc[k][0] for k in range(n)])
        oks = np.stack([self.kf_assoc[k][1] for k in range(n)])
        T = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731
        newX = _reanchor_landmarks(
            T(Xs.reshape(-1, 3)), torch.arange(n).repeat_interleave(cap), T(oks.reshape(-1)),
            T(R_old[:n]), T(t_old[:n]), T(R_sim[:n]), T(t_sim[:n]),
            T(s_sim[:n])).numpy().reshape(n, cap, 3)
        for k in range(n):
            self.kf_assoc[k] = (newX[k], oks[k])

    def _corrected_map_X(self, map_state, anchor_offset, R_old, t_old, R_sim, t_sim, s_sim):
        """The map's landmarks moved with their anchor keyframes (anchors are
        local to the current submap: ``anchor_offset`` makes them global)."""
        T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)  # noqa: E731
        return _reanchor_landmarks(map_state.X, map_state.anchor_kf + anchor_offset,
                                   map_state.valid, T(R_old), T(t_old), T(R_sim), T(t_sim),
                                   T(s_sim))

    def _live_pose(self, corr, R, t):
        """The live pose corrected by the newest keyframe's similarity."""
        Rc, tc, sc = (torch.from_numpy(np.asarray(a, np.float32)).to(self.device) for a in corr)
        return sim3_to_se3(*sim3_compose(Rc, tc, sc, R, t, torch.ones_like(sc)))

    def _apply_graph_result(self, snap, solved):
        (R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n), W = self._landed_late(
            snap, self._extend_solution(snap, solved, self.kf_R, self.kf_t))
        vo = self.vo
        vo.map = vo.map.replace(X=self._corrected_map_X(vo.map, 0, R_old, t_old, R_sim,
                                                        t_sim, s_sim))
        self._reanchor_assoc_snapshots(R_old, t_old, R_sim, t_sim, s_sim, n)
        for i in range(n):
            self.kf_R[i], self.kf_t[i] = R_se[i], t_se[i]
        win_R, win_t = vo.win_R.cpu().numpy().copy(), vo.win_t.cpu().numpy().copy()
        for slot in np.nonzero(vo.win_valid)[0]:
            kf_id = int(vo.win_kf_id[slot])
            if 0 <= kf_id < n:
                win_R[slot], win_t[slot] = R_se[kf_id], t_se[kf_id]
        vo.win_R = torch.from_numpy(win_R).to(self.device)
        vo.win_t = torch.from_numpy(win_t).to(self.device)
        vo.R, vo.t = (self._live_pose(corr, vo.R, vo.t) if W is None
                      else self._world_pose(W, vo.R, vo.t))
        newest = self._newest_slot()
        if newest is not None:
            k = int(vo.win_kf_id[newest])
            vo.kf_pose = (torch.from_numpy(R_se[k]).to(self.device),
                          torch.from_numpy(t_se[k]).to(self.device))

    def _newest_slot(self):
        nz = np.nonzero(self.vo.win_valid)[0]
        return int(nz.max()) if len(nz) else None

    # ------------- public API -------------
    def process(self, image):
        return self.process_frame(image)

    def process_frame(self, image):
        with self._timed("track"):
            st = self.vo.process(image)
        self._sync_new_keyframes()
        self._refresh_window_poses()
        self._apply_finished_solve()
        return st

    def _apply_finished_solve(self):
        if self._worker is not None:
            res = self._worker.poll()
            if (res is None and self._submits and self.solve_lag_frames is not None
                    and self._worker.busy and len(self.vo.trajectory) - self._submits[0][1]
                    >= self.solve_lag_frames):
                res = self._worker.flush()
            if res is not None:
                self._apply_graph_result(*res)

    def finalize(self):
        """Apply any in-flight pose-graph solve (async mode); idempotent."""
        if self._worker is not None:
            res = self._worker.flush()
            if res is not None:
                self._apply_graph_result(*res)

    def close(self):
        if self._worker is not None:
            self._worker.close()
            self._worker = None

    def _refresh_window_poses(self):
        """Keep the keyframe pose tables in step with the BA-refined window."""
        vo = self.vo
        if not vo.win_valid.any():
            return
        win_R, win_t = vo.win_R.cpu().numpy(), vo.win_t.cpu().numpy()
        for slot in np.nonzero(vo.win_valid)[0]:
            kf_id = int(vo.win_kf_id[slot])
            if 0 <= kf_id < len(self.kf_R):
                self.kf_R[kf_id], self.kf_t[kf_id] = win_R[slot], win_t[slot]

    def run(self, images):
        out = [self.process_frame(im) for im in images]
        self.finalize()
        return out

    def corrected_trajectory(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Dense trajectory with the keyframe corrections propagated.

        The online trajectory is recorded before later window-BA and loop
        corrections, which update only the keyframe tables; here every
        frame rides the correction of its most recent keyframe k:
        T_f' = (T_f o T_k_raw^-1) o T_k_new."""
        traj = self.vo.trajectory
        # The exact keyframe -> frame map recorded at keyframe creation.
        kf_at = sorted((f, k) for k, f in self.kf_frame_of.items()
                       if k < len(self.kf_R) and f < len(traj))
        out = []
        j = -1                     # index into kf_at of the latest keyframe <= f
        for f, (R, t) in enumerate(traj):
            while j + 1 < len(kf_at) and kf_at[j + 1][0] <= f:
                j += 1
            if j < 0:
                out.append((np.asarray(R), np.asarray(t)))
                continue
            fk, k = kf_at[j]
            R_raw, t_raw = (np.asarray(a) for a in traj[fk])
            R_rel = np.asarray(R) @ R_raw.T
            t_rel = np.asarray(t) - R_rel @ t_raw
            out.append((R_rel @ self.kf_R[k], R_rel @ self.kf_t[k] + t_rel))
        return out

    @property
    def positions(self) -> np.ndarray:
        return np.asarray([-R.T @ t for R, t in self.corrected_trajectory()])

    @property
    def trajectory(self):
        return self.corrected_trajectory()

    @property
    def raw_positions(self) -> np.ndarray:
        """Online (uncorrected) positions, for ablation."""
        return self.vo.positions


class DeviceSlam(Slam):
    """``Slam`` over the chunked device tracker (``models/vo_device.py``).

    The loop-closure layer runs at chunk boundaries: the new keyframes are
    pulled from the device state (features from its keyframe ring, poses
    from the BA-refined window slot while it holds one), place recognition
    and the pose graph run as in ``Slam``, and the corrections go into the
    ``VOState`` between chunks (landmarks, window poses, live pose).

    Keyframes are numbered globally across submap reboots (global = offset
    + the current submap's local id), so the pose graph spans submaps; the
    reboot hook syncs the keyframes still only on the device before the
    state is dropped.
    """

    def __init__(self, cfg: SlamConfig, camera: PinholeCamera, chunk: int = 16,
                 async_backend: bool = False, solve_timeout_s: float = 30.0,
                 sampler: Sampler | None = None, *, device):
        self.chunk = chunk
        super().__init__(cfg, camera, async_backend=async_backend,
                         solve_timeout_s=solve_timeout_s, sampler=sampler, device=device)
        self._synced_stats = 0          # stats entries scanned for keyframes
        self._kf_frame: dict[int, int] = {}   # keyframe id -> frame, the pose fallback
        self._kf_offset = 0
        self.vo.pre_reboot_hook = self._sync_chunk

    def _make_tracker(self, device: torch.device):
        return DeviceVO(self.cfg, self.camera, chunk=self.chunk, sampler=self.sampler,
                        device=device)

    def _anchor_offset(self) -> int:
        return self._kf_offset

    # ------------- keyframe sync (chunk granularity) -------------
    def process_frame(self, image):
        vo = self.vo
        was_init = vo.state is not None
        pending_before = len(vo._pending)
        with self._timed("track" if was_init else "track_boot"):
            vo.process(image)
        if vo.state is not None and not was_init:
            self._sync_bootstrap()
        elif vo.state is not None and len(vo._pending) > pending_before:
            self._sync_chunk()
        return vo.stats[-1] if vo.stats else None

    def _sync_bootstrap(self):
        """A bootstrap completed on the host phase (the first or after a
        reboot): pull its two keyframes under global ids.  Across a reboot
        the odometry edge into the first new keyframe runs through the
        stale lost pose, so it ships at reduced weight."""
        h = self.vo._host
        self._kf_offset = len(self.kf_store)
        first_new = self._kf_offset > 0
        for kf_id, R, t in h.kf_poses_log:
            gid = self._kf_offset + kf_id
            self._append_keyframe(gid, R, t, h.kf0_feats if kf_id == 0 else h.kf_feats,
                                  edge_weight=0.3 if (first_new and kf_id == 0) else 1.0)
            if kf_id < len(h.kf_frames_log):
                frame = self.vo._host_frame0 + h.kf_frames_log[kf_id]
                self._kf_frame[gid] = frame
                self.kf_frame_of[gid] = frame
        self._synced_stats = len(self.vo.stats)
        self._refresh_window_poses()

    def _sync_chunk(self):
        vo = self.vo
        with self._timed("flush"):
            vo.flush()                  # the pending summaries to the host
        if vo.state is None:
            return
        # Device-phase keyframe flags -> global keyframe ids (the pose
        # fallback for keyframes that rolled out of the window in a chunk).
        next_kf = (max(self._kf_frame) + 1) if self._kf_frame else len(self.kf_store)
        for i, s in enumerate(vo.stats[self._synced_stats:]):
            if s.is_keyframe:
                self._kf_frame[next_kf] = self._synced_stats + i
                self.kf_frame_of[next_kf] = self._synced_stats + i
                next_kf += 1
        self._synced_stats = len(vo.stats)
        total = self._kf_offset + int(vo.state.num_keyframes)
        for gid in range(len(self.kf_store), total):
            # Re-read the state for every keyframe: a synchronous solve
            # accepted on the previous one REPLACES it (corrected poses, a
            # rescaled map), and a stale window pose against the corrected
            # map would make every guided match come back empty.
            state = vo.state
            win_valid, win_kf, win_R, win_t = _window(state)
            local = gid - self._kf_offset
            feats = state.kf_ring.map(lambda x: x[local % KF_RING].clone())
            slots = np.nonzero(win_valid & (win_kf == local))[0]
            if len(slots):
                R, t = win_R[slots[0]], win_t[slots[0]]
            else:
                frame = self._kf_frame.get(gid)
                if frame is not None and frame < len(vo.trajectory):
                    R, t = vo.trajectory[frame]
                else:
                    R, t = self.kf_R[-1], self.kf_t[-1]
            self._append_keyframe(gid, R, t, feats)
        self._refresh_window_poses()
        self._apply_finished_solve()

    def _refresh_window_poses(self):
        if self.vo.state is None:
            return
        win_valid, win_kf, win_R, win_t = _window(self.vo.state)
        for slot in np.nonzero(win_valid)[0]:
            gid = self._kf_offset + int(win_kf[slot])
            if self._kf_offset <= gid < len(self.kf_R):
                self.kf_R[gid], self.kf_t[gid] = win_R[slot], win_t[slot]

    # ------------- corrections into the device state -------------
    def _apply_graph_result(self, snap, solved):
        (R_old, t_old, R_sim, t_sim, s_sim, R_se, t_se, corr, n), W = self._landed_late(
            snap, self._extend_solution(snap, solved, self.kf_R, self.kf_t))
        for i in range(n):
            self.kf_R[i], self.kf_t[i] = R_se[i], t_se[i]
        self._reanchor_assoc_snapshots(R_old, t_old, R_sim, t_sim, s_sim, n)
        state = self.vo.state
        if state is None:
            # Mid-reboot: no device state to move; the keyframe tables and
            # snapshots carry the correction.
            return
        new_X = self._corrected_map_X(state.map, self._kf_offset, R_old, t_old, R_sim,
                                      t_sim, s_sim)
        win_valid, win_kf, win_R, win_t = _window(state)
        win_R, win_t = win_R.copy(), win_t.copy()
        for slot in np.nonzero(win_valid)[0]:
            gid = self._kf_offset + int(win_kf[slot])
            if self._kf_offset <= gid < n:
                win_R[slot], win_t[slot] = R_se[gid], t_se[gid]
        live_R, live_t = (self._live_pose(corr, state.R, state.t) if W is None
                          else self._world_pose(W, state.R, state.t))
        self.vo.state = state.replace(
            map=state.map.replace(X=new_X),
            win_R=torch.from_numpy(win_R).to(self.device),
            win_t=torch.from_numpy(win_t).to(self.device), R=live_R, t=live_t)

    def finalize(self):
        """Track the partial chunk, sync the last keyframes and apply any
        in-flight solve; idempotent."""
        if self.vo.state is not None:
            self._sync_chunk()
        else:
            self.vo.flush()
        super().finalize()
