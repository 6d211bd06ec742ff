"""Landmark map, tracking helpers and map maintenance of the visual
odometry (mirrors ``tinyslam_tpu/models/vo.py:MapState, _match_to_map,
_track_pnp, _triangulate_and_insert, _record_obs, VOStats``).

World frame = camera frame of the first keyframe; poses are world->camera.

Two reference behaviours of the JAX CPU path are kept on purpose, for
parity: a scatter with repeated indices keeps the LAST row's write
(``_last_writer``; torch leaves the order of ``index_put_`` undefined),
and a median over an even count averages the two middle values, as
``jnp.nanmedian`` does (``nanmedian``; ``torch.nanmedian`` takes the lower).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tinyslam_tpu_torch.geometry.camera import PinholeCamera
from tinyslam_tpu_torch.geometry.epipolar import depths, triangulate
from tinyslam_tpu_torch.geometry.pnp import pnp_refine
from tinyslam_tpu_torch.ops.hamming import hamming_distance_matrix, match_descriptors
from tinyslam_tpu_torch.types import Features, from_numpy, to_numpy


@dataclass
class MapState:
    """Fixed-capacity landmark slotmap."""

    X: torch.Tensor          # (M, 3) world positions
    desc: torch.Tensor       # (M, 8) int32 packed BRIEF
    valid: torch.Tensor      # (M,) bool
    anchor_kf: torch.Tensor  # (M,) int32 keyframe that created the landmark
    obs_count: torch.Tensor  # (M,) int32 gated keyframe observations
    last_seen: torch.Tensor  # (M,) int32 keyframe of the last observation

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(capacity: int, device=None) -> "MapState":
        i32 = dict(dtype=torch.int32, device=device)
        return MapState(
            X=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            desc=torch.zeros((capacity, 8), **i32),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            anchor_kf=torch.full((capacity,), -1, **i32),
            obs_count=torch.zeros((capacity,), **i32),
            last_seen=torch.full((capacity,), -1, **i32),
        )

    @staticmethod
    def from_numpy(d: dict, device=None, prefix: str = "") -> "MapState":
        return MapState(**{f.name: from_numpy(d[prefix + f.name], device)
                           for f in dataclasses.fields(MapState)})

    def to_numpy(self, prefix: str = "") -> dict:
        return {prefix + f.name: to_numpy(getattr(self, f.name),
                                          desc=f.name == "desc")
                for f in dataclasses.fields(self)}


@dataclass
class VOStats:
    frame: int = 0
    num_features: int = 0
    num_matches: int = 0
    num_inliers: int = 0
    num_landmarks: int = 0
    is_keyframe: bool = False
    tracking: bool = False
    rmse_px: float = 0.0


def _match_to_map(feats: Features, map_state: MapState, max_distance: int,
                  ratio: float, cam: PinholeCamera | None = None,
                  R: torch.Tensor | None = None, t: torch.Tensor | None = None,
                  radius_px: float = 20.0):
    """Match features to the map.  With a predicted pose (cam, R, t) the
    matching is GUIDED: a map point is only eligible within ``radius_px`` of
    its predicted projection.  Returns (idx (N,) int32, valid (N,) bool)."""
    xy_a = proj = None
    if R is not None:
        pc = map_state.X @ R.T + t
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        in_front = pc[..., 2] > 1e-4
        # Behind-camera landmarks: park the projection far outside any radius.
        far = torch.full((), 1e7, dtype=torch.float32, device=pc.device)
        proj = torch.stack([torch.where(in_front, u, far),
                            torch.where(in_front, v, far)], dim=-1)
        xy_a = feats.xy
    m = match_descriptors(
        feats.desc, feats.valid, map_state.desc, map_state.valid,
        max_distance=max_distance, ratio=ratio, cross_check=True,
        xy_a=xy_a, proj_b=proj, radius_px=radius_px)
    return m["idx_b"], m["valid"]


def _track_pnp(cam: PinholeCamera, feats: Features, map_state: MapState,
               map_idx: torch.Tensor, match_valid: torch.Tensor,
               R0: torch.Tensor, t0: torch.Tensor, iters: int,
               inlier_px: float) -> dict:
    X = map_state.X[map_idx.long()]
    return pnp_refine(cam, X, feats.xy, match_valid, R0, t0,
                      iters=iters, inlier_px=inlier_px)


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median over ``dim`` ignoring NaN, with ``jnp.nanmedian``'s
    semantics: the mean of the two middle values for an even count, NaN
    where every value is NaN.  ``torch.sort`` puts NaN last."""
    s = torch.sort(x, dim=dim).values
    n = (~torch.isnan(x)).sum(dim, keepdim=True)
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp_min(0)
    hi = torch.div(n, 2, rounding_mode="floor")
    med = (s.gather(dim, lo) + s.gather(dim, hi)) * 0.5
    med = torch.where(n > 0, med, torch.full_like(med, float("nan")))
    return med.squeeze(dim)


def _last_writer(idx: torch.Tensor, size: int) -> torch.Tensor:
    """For a scatter of rows to slots ``idx``, the row whose write each of
    ``size`` slots keeps, or -1: the last row, as the JAX CPU reference
    keeps it.  A max over row numbers does not depend on order, so this
    is deterministic on every device."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    init = torch.full((size,), -1, dtype=torch.long, device=idx.device)
    return init.scatter_reduce(0, idx.long(), rows, "amax")


def _scatter_set(dst: torch.Tensor, writer: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(src)`` given ``writer = _last_writer(idx, len(dst))``."""
    took = (writer >= 0).view(-1, *([1] * (dst.dim() - 1)))
    return torch.where(took, src[writer.clamp_min(0)], dst)


def row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without reading it back to the host
    (indexing with a 0-d tensor calls ``.item()``)."""
    return x[i.reshape(1)][0]


def set_row(x: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """``x`` with row ``i`` (0-d index tensor) replaced by ``v``."""
    hit = torch.arange(x.shape[0], device=x.device) == i
    return torch.where(hit.view(-1, *([1] * (x.dim() - 1))), v, x)


def _triangulate_and_insert(
    cam: PinholeCamera, map_state: MapState, kf_id: torch.Tensor,
    R_a: torch.Tensor, t_a: torch.Tensor, feats_a: Features,
    R_b: torch.Tensor, t_b: torch.Tensor, feats_b: Features,
    idx_b: torch.Tensor, pair_valid: torch.Tensor,
    already_mapped_a: torch.Tensor, max_new: int,
    min_parallax_cos: float = 0.9998, max_reproj_px: float = 4.0,
    band_lo: float = 0.25, band_hi: float = 4.0, dup_radius_px: float = 48.0,
    local_band: float = 0.0,
):
    """Triangulate descriptor-matched (a, b) feature pairs and insert the
    accepted new landmarks into free map slots.

    idx_b (N,): match of each a-feature in b; pair_valid (N,);
    already_mapped_a (N,): a-features that already track a landmark.  The
    gates (depth, reprojection, parallax, the scene and local depth bands
    against period-aliased matches, the localized duplicate test) are the
    JAX package's; see its comments for why each exists.  Returns
    (new map, number inserted).
    """
    ib = idx_b.long()
    xy_b = feats_b.xy[ib]
    cand = pair_valid & ~already_mapped_a
    X = triangulate(R_a, t_a, cam.normalize(feats_a.xy), R_b, t_b,
                    cam.normalize(xy_b))
    za = depths(R_a, t_a, X)
    zb = depths(R_b, t_b, X)

    def project(P, R, t):
        pc = P @ R.T + t
        z = torch.clamp_min(pc[..., 2], 1e-6)
        return cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy

    def reproj_err(R, t, uv):
        return torch.linalg.norm(torch.stack(project(X, R, t), -1) - uv, dim=-1)

    ea = reproj_err(R_a, t_a, feats_a.xy)
    eb = reproj_err(R_b, t_b, xy_b)
    Ca = -(R_a.T @ t_a)                                # camera centres (world)
    Cb = -(R_b.T @ t_b)
    ra, rb = X - Ca, X - Cb
    cos_par = (ra * rb).sum(-1) / torch.clamp_min(
        torch.linalg.norm(ra, dim=-1) * torch.linalg.norm(rb, dim=-1), 1e-9)
    accept = (cand & (za > 0.05) & (zb > 0.05) & (za < 1e3) & (zb < 1e3)
              & (ea < max_reproj_px) & (eb < max_reproj_px)
              & (cos_par < min_parallax_cos) & torch.isfinite(X).all(-1))

    # Depth band against the median depth of the map points in view.
    nan = torch.full((), float("nan"), device=X.device)
    z_map = depths(R_a, t_a, map_state.X)
    u_m, v_m = project(map_state.X, R_a, t_a)
    in_view = (map_state.valid & (z_map > 0.02)
               & (u_m > 0) & (u_m < 2.0 * cam.cx + 1.0)
               & (v_m > 0) & (v_m < 2.0 * cam.cy + 1.0))
    med_z = nanmedian(torch.where(in_view, z_map, nan))
    have_scene = in_view.sum() >= 30
    band_ok = (za > band_lo * med_z) & (za < band_hi * med_z)
    accept &= torch.where(have_scene & torch.isfinite(med_z), band_ok, True)

    # Duplicates: a similar descriptor projecting near the candidate.
    d_map = hamming_distance_matrix(feats_a.desc, map_state.desc)   # (N, M)
    proj_m = torch.stack([u_m, v_m], dim=-1)
    pdist2 = ((feats_a.xy[:, None, :] - proj_m[None, :, :]) ** 2).sum(-1)
    similar = (d_map <= 40) & map_state.valid[None, :]
    if dup_radius_px > 0:
        similar &= (pdist2 < dup_radius_px ** 2) & in_view[None, :]
    accept &= ~similar.any(dim=1)

    # Local depth band: the median depth of map points within 40 px.
    neigh = (pdist2 < 40.0 ** 2) & in_view[None, :]
    z_local = nanmedian(torch.where(neigh, z_map[None, :], nan), dim=1)
    lb = max(local_band, 1.0)
    local_ok = (za > z_local / lb) & (za < z_local * lb)
    use_local = (neigh.sum(1) >= 5) & torch.isfinite(z_local) & (local_band > 1.0)
    accept &= torch.where(use_local, local_ok, True)

    # Accepted candidates by feature score into the first free slots.
    rank_key = torch.where(accept, feats_a.score, torch.full_like(feats_a.score, -1.0))
    order = torch.argsort(-rank_key, stable=True)[:max_new]
    free = torch.argsort(map_state.valid.to(torch.int8), stable=True)[:max_new]
    write = accept[order] & ~map_state.valid[free]

    def put(field, new):
        old = field[free]
        w = write.view(-1, *([1] * (old.dim() - 1)))
        return field.index_copy(0, free, torch.where(w, new, old))

    new_map = MapState(
        X=put(map_state.X, X[order]),
        desc=put(map_state.desc, feats_a.desc[order]),
        valid=put(map_state.valid, True),
        anchor_kf=put(map_state.anchor_kf, kf_id),
        obs_count=put(map_state.obs_count, 1),
        last_seen=put(map_state.last_seen, kf_id),
    )
    return new_map, write.sum(dtype=torch.int32)


def _record_obs(win_obs: torch.Tensor, win_mask: torch.Tensor, slot: torch.Tensor,
                map_idx: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                cam: PinholeCamera | None = None, map_X: torch.Tensor | None = None,
                R: torch.Tensor | None = None, t: torch.Tensor | None = None,
                gate_px: float = 8.0):
    """Record one keyframe's observations into win_obs (K, M, 2) and
    win_mask (K, M) at window slot ``slot`` (0-d tensor).

    With ``map_X`` the observations are gated by reprojection error under
    (R, t): descriptor matching has a wrong-match tail, and wrong
    observations in the BA window drag it off.  Returns (win_obs,
    win_mask, gated valid)."""
    idx = map_idx.long()
    if map_X is not None:
        pc = map_X[idx] @ R.T + t
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        err = torch.linalg.norm(torch.stack([u, v], -1) - uv, dim=-1)
        valid = valid & (pc[..., 2] > 1e-4) & (err < gate_px)
    obs_k = row(win_obs, slot)
    mask_k = row(win_mask, slot)
    writer = _last_writer(idx, obs_k.shape[0])
    obs_k = _scatter_set(obs_k, writer, torch.where(valid[:, None], uv, obs_k[idx]))
    mask_k = _scatter_set(mask_k, writer, valid | mask_k[idx])
    return set_row(win_obs, slot, obs_k), set_row(win_mask, slot, mask_k), valid
