"""Synthetic scenes, trajectories and rendered frames in numpy (mirrors
``tinyslam_tpu/data/synthetic.py:default_camera, look_at,
orbit_trajectory, TexturedRoom, vo_sequence``, without lens distortion).

Frames and ground-truth ray casts are bit-equal to the JAX package's for
the same camera, poses and seed, so the port can render on a machine
without JAX.
"""

from __future__ import annotations

import numpy as np

from tinyslam_tpu_torch.geometry.camera import PinholeCamera


def default_camera(width: int = 640, height: int = 480) -> PinholeCamera:
    """TUM-fr1-like intrinsics."""
    return PinholeCamera.create(fx=517.3, fy=516.5, cx=width / 2 - 0.5, cy=height / 2 - 0.5)


def look_at(camera_pos: np.ndarray, target: np.ndarray,
            up=(0.0, -1.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """World->camera (R, t) for a camera at `camera_pos` looking at `target`.
    Camera convention: +z forward, +x right, +y down (image coords)."""
    fwd = target - camera_pos
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(upv, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-8:  # looking along up: pick another up
        upv = np.array([1.0, 0.0, 0.0])
        right = np.cross(upv, fwd)
        nr = np.linalg.norm(right)
    right /= nr
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ camera_pos
    return R.astype(np.float32), t.astype(np.float32)


def orbit_trajectory(num_frames: int, radius: float = 6.0,
                     height: float = 0.5, arc: float = 0.8,
                     target=(0.0, 0.0, 0.0),
                     start: float | None = None,
                     step: float | None = None) -> list[tuple[np.ndarray, np.ndarray]]:
    """Cameras on a horizontal arc, all looking at `target`: either a total
    sweep `arc` (centred) or a fixed per-frame angle `step` from `start`."""
    poses = []
    tgt = np.asarray(target, np.float64)
    for i in range(num_frames):
        if step is not None:
            a = (start or 0.0) + i * step
        else:
            a = (i / max(num_frames - 1, 1) - 0.5) * arc
        pos = np.array([radius * np.sin(a), height, -radius * np.cos(a)]) + tgt
        poses.append(look_at(pos, tgt))
    return poses


class TexturedRoom:
    """A procedurally textured axis-aligned box room, rendered by ray
    casting (perspective-correct, view-consistent).  Each face carries a
    bilinearly sampled random grid texture; ``octaves > 1`` overlays finer
    texture; ``clutter`` adds textured interior boxes."""

    def __init__(self, rng: np.random.Generator, half_size=(6.0, 4.0, 6.0),
                 tex_res: int = 64, octaves: int = 1, clutter: int = 0):
        self.half = np.asarray(half_size, np.float64)
        res = tex_res
        base = rng.random((6, res + 1, res + 1))
        tex = 0.15 + 0.7 * (base > 0.5).astype(np.float64)
        for o in range(1, octaves):
            r2 = res * 2
            fine = rng.random((6, r2 + 1, r2 + 1)) > 0.5
            up = np.repeat(np.repeat(tex, 2, axis=1), 2, axis=2)
            up = up[:, : r2 + 1, : r2 + 1]
            tex = up + (fine.astype(np.float64) - 0.5) * (0.5 / (2 ** o))
            res = r2
        self.tex = np.clip(tex, 0.02, 0.98)
        self.res = res
        self.boxes: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for _ in range(clutter):
            size = rng.uniform(0.25, 0.9, 3)
            margin = self.half - size - 0.3
            center = rng.uniform(-1.0, 1.0, 3) * np.maximum(margin, 0.1)
            center[1] = -abs(center[1]) * 0.7 + size[1]
            btex = 0.1 + 0.8 * (rng.random((6, 33, 33)) > 0.5)
            fine = rng.random((6, 65, 65)) > 0.5
            up = np.repeat(np.repeat(btex, 2, axis=1), 2, axis=2)[:, :65, :65]
            btex = np.clip(up + (fine - 0.5) * 0.3, 0.02, 0.98)
            self.boxes.append((center, size, btex))
        self._rays: dict = {}   # pixel ray grid per (intrinsics, size)

    def render(self, cam: PinholeCamera, R: np.ndarray, t: np.ndarray,
               width: int, height: int) -> np.ndarray:
        """(height, width) float32 image of the room seen from pose (R, t)."""
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        key = (fx, fy, cx, cy, width, height)
        d_cam = self._rays.get(key)
        if d_cam is None:
            us, vs = np.meshgrid(np.arange(width), np.arange(height))
            xn = (us - cx) / fx
            yn = (vs - cy) / fy
            d_cam = np.stack([xn, yn, np.ones_like(xn, np.float64)], -1)
            self._rays = {key: d_cam}
        Rm = np.asarray(R, np.float64)
        C = -Rm.T @ np.asarray(t, np.float64)
        d = d_cam @ Rm  # (H, W, 3) world-frame ray directions

        best_t = np.full((height, width), np.inf)
        out = np.full((height, width), 0.4)
        for axis in range(3):
            for sign in (-1.0, 1.0):
                bound = sign * self.half[axis]
                da = d[..., axis]
                with np.errstate(divide="ignore", invalid="ignore"):
                    th = (bound - C[axis]) / da
                    P = C[None, None, :] + th[..., None] * d
                a1, a2 = [i for i in range(3) if i != axis]
                ok = (
                    (th > 1e-6)
                    & np.isfinite(th)
                    & (np.abs(P[..., a1]) <= self.half[a1] + 1e-9)
                    & (np.abs(P[..., a2]) <= self.half[a2] + 1e-9)
                    & (th < best_t)
                )
                ua = (P[..., a1] / self.half[a1] + 1) * 0.5
                va = (P[..., a2] / self.half[a2] + 1) * 0.5
                face = axis * 2 + (sign > 0)
                val = self._sample(int(face), ua, va)
                out = np.where(ok, val, out)
                best_t = np.where(ok, th, best_t)
        out, best_t = self._hit_boxes(C, d, out, best_t)
        return out.astype(np.float32)

    def _hit_boxes(self, C, d, out, best_t):
        """Nearest-hit tests against the interior clutter boxes."""
        for center, size, btex in self.boxes:
            for axis in range(3):
                for sign in (-1.0, 1.0):
                    bound = center[axis] + sign * size[axis]
                    da = d[..., axis]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        th = (bound - C[axis]) / da
                        P = C[None, None, :] + th[..., None] * d
                    a1, a2 = [i for i in range(3) if i != axis]
                    ok = (
                        (th > 1e-6)
                        & np.isfinite(th)
                        & (np.abs(P[..., a1] - center[a1]) <= size[a1] + 1e-9)
                        & (np.abs(P[..., a2] - center[a2]) <= size[a2] + 1e-9)
                        & (th < best_t)
                    )
                    if not ok.any():
                        continue
                    ua = ((P[..., a1] - center[a1]) / size[a1] + 1) * 0.5
                    va = ((P[..., a2] - center[a2]) / size[a2] + 1) * 0.5
                    face = axis * 2 + (sign > 0)
                    x = np.clip(ua, 0, 1) * 64
                    y = np.clip(va, 0, 1) * 64
                    x0 = np.clip(x.astype(int), 0, 63)
                    y0 = np.clip(y.astype(int), 0, 63)
                    fx, fy = x - x0, y - y0
                    T = btex[int(face)]
                    val = (T[y0, x0] * (1 - fx) * (1 - fy)
                           + T[y0, x0 + 1] * fx * (1 - fy)
                           + T[y0 + 1, x0] * (1 - fx) * fy
                           + T[y0 + 1, x0 + 1] * fx * fy)
                    out = np.where(ok, val, out)
                    best_t = np.where(ok, th, best_t)
        return out, best_t

    def raycast(self, cam: PinholeCamera, R: np.ndarray, t: np.ndarray,
                uv: np.ndarray) -> np.ndarray:
        """Ground-truth 3D points (world) hit by rays through pixels uv (N, 2)."""
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        d_cam = np.stack(
            [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1
        )
        Rm = np.asarray(R, np.float64)
        C = -Rm.T @ np.asarray(t, np.float64)
        d = d_cam @ Rm
        best_t = np.full(len(uv), np.inf)
        P_out = np.zeros((len(uv), 3))
        surfaces = [(np.zeros(3), self.half)] + [(c, s) for c, s, _ in self.boxes]
        for center, half in surfaces:
            for axis in range(3):
                for sign in (-1.0, 1.0):
                    bound = center[axis] + sign * half[axis]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        th = (bound - C[axis]) / d[:, axis]
                        P = C[None] + th[:, None] * d
                    a1, a2 = [i for i in range(3) if i != axis]
                    ok = (
                        (th > 1e-6) & np.isfinite(th)
                        & (np.abs(P[:, a1] - center[a1]) <= half[a1] + 1e-9)
                        & (np.abs(P[:, a2] - center[a2]) <= half[a2] + 1e-9)
                        & (th < best_t)
                    )
                    P_out = np.where(ok[:, None], P, P_out)
                    best_t = np.where(ok, th, best_t)
        return P_out

    def _sample(self, face: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        res = self.res
        x = np.clip(u, 0, 1) * (res - 1)
        y = np.clip(v, 0, 1) * (res - 1)
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        ax = x - x0
        ay = y - y0
        t = self.tex[face]
        return (
            t[y0, x0] * (1 - ax) * (1 - ay)
            + t[y0, x0 + 1] * ax * (1 - ay)
            + t[y0 + 1, x0] * (1 - ax) * ay
            + t[y0 + 1, x0 + 1] * ax * ay
        )


def vo_sequence(rng: np.random.Generator, num_frames: int = 60, num_points: int = 400,
                width: int = 320, height: int = 240, radius: float = 2.0,
                step: float = 0.03):
    """A synthetic VO sequence: a camera orbiting inside a textured room at
    a fixed angle a frame (so the motion does not depend on the length).
    ``num_points`` is unused, as in the reference.  Returns (cam, images,
    ground-truth poses (world->camera), room)."""
    cam = PinholeCamera.create(fx=260.0, fy=260.0, cx=width / 2 - 0.5, cy=height / 2 - 0.5)
    room = TexturedRoom(rng)
    poses = orbit_trajectory(num_frames, radius=radius, step=step, start=-0.35,
                             target=(0.0, 0.0, 2.0))
    images = [room.render(cam, R, t, width, height) for R, t in poses]
    return cam, images, poses, room
