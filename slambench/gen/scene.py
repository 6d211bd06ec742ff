"""A textured box room with interior clutter, ray cast on the device.

A plain-PyTorch counterpart of the port's ``data/synthetic.py:TexturedRoom``
(the renderer that the port's eval calibrates against TUM fr1 and EuRoC
MH01): six faces of an axis-aligned room, each a bilinearly sampled random
grid texture with ``octaves`` finer layers, and ``clutter`` textured boxes
inside.  The textures and the boxes are drawn from a ``torch.Generator`` on
the render device in a few large calls; the same seed on the same kind of
device gives the same room.  Rays are cast in float32 for a batch of
poses at once.
"""

from __future__ import annotations

import numpy as np
import torch


def box_geometry(seed: int, half_size, clutter: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(centre, half extent) of each clutter box: sizes 0.25-0.9 m, inside
    the room with a 0.3 m margin, standing on the floor side (+y is
    down)."""
    rng = np.random.default_rng(int(seed))
    half = np.asarray(half_size, np.float64)
    out = []
    for _ in range(clutter):
        size = rng.uniform(0.25, 0.9, 3)
        center = rng.uniform(-1.0, 1.0, 3) * np.maximum(half - size - 0.3, 0.1)
        center[1] = -abs(center[1]) * 0.7 + size[1]
        out.append((center, size))
    return out


class Room:
    def __init__(self, seed: int, device, half_size=(6.0, 4.0, 6.0), tex_res: int = 64,
                 octaves: int = 1, clutter: int = 0):
        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        f32 = dict(dtype=torch.float32, device=dev)
        self.device = dev
        self.half = torch.tensor(half_size, **f32)
        res = int(tex_res)
        tex = 0.15 + 0.7 * (torch.rand((6, res + 1, res + 1), generator=gen, **f32) > 0.5)
        for o in range(1, octaves):
            r2 = res * 2
            fine = (torch.rand((6, r2 + 1, r2 + 1), generator=gen, **f32) > 0.5).float()
            up = tex.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, : r2 + 1, : r2 + 1]
            tex = up + (fine - 0.5) * (0.5 / 2 ** o)
            res = r2
        self.tex = tex.clamp(0.02, 0.98).contiguous()
        self.res = res
        # Each box: centre (3), half extent (3), a 65x65 texture a face.
        # Their places come from numpy's generator, so that the room's
        # geometry is the same on every device.
        self.boxes = []
        for center, size in box_geometry(seed, half_size, clutter):
            base = 0.1 + 0.8 * (torch.rand((6, 33, 33), generator=gen, **f32) > 0.5)
            fine = (torch.rand((6, 65, 65), generator=gen, **f32) > 0.5).float()
            up = base.repeat_interleave(2, 1).repeat_interleave(2, 2)[..., :65, :65]
            btex = (up + (fine - 0.5) * 0.3).clamp(0.02, 0.98).contiguous()
            self.boxes.append((torch.tensor(center, **f32), torch.tensor(size, **f32), btex))

    def render(self, camera: dict, R: torch.Tensor, t: torch.Tensor, width: int,
               height: int) -> torch.Tensor:
        """(N, height, width) float32 intensities in [0, 1] seen from the N
        world->camera poses (R (N, 3, 3), t (N, 3)) through the pinhole
        ``camera`` (fx, fy, cx, cy)."""
        dev = self.device
        vs, us = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                                torch.arange(width, device=dev, dtype=torch.float32),
                                indexing="ij")
        return self._cast(camera, R, t, us, vs)[0]

    def points(self, camera: dict, R: torch.Tensor, t: torch.Tensor,
               uv: torch.Tensor) -> torch.Tensor:
        """(M, 3) world points that the rays through the pixels ``uv`` (M, 2)
        hit first, seen from one pose (R (3, 3), t (3,))."""
        uv = uv.to(self.device, torch.float32)
        R = R.to(self.device, torch.float32).reshape(1, 3, 3)
        t = t.to(self.device, torch.float32).reshape(1, 3)
        _, dist, C, d = self._cast(camera, R, t, uv[:, 0], uv[:, 1])
        return (C[:, None, :] + dist[..., None] * d)[0]

    def _cast(self, camera: dict, R, t, us, vs):
        """Cast the rays through pixels (us, vs) of every pose: (intensity,
        distance along the ray, camera centres (N, 3), ray directions)."""
        dev = self.device
        R = R.to(dev, torch.float32)
        t = t.to(dev, torch.float32)
        d_cam = torch.stack([(us - camera["cx"]) / camera["fx"],
                             (vs - camera["cy"]) / camera["fy"], torch.ones_like(us)], -1)
        C = -torch.einsum("nji,nj->ni", R, t)                     # camera centres
        d = torch.einsum("...j,nji->n...i", d_cam, R)             # world ray directions
        shape = d.shape[:-1]
        best = torch.full(shape, float("inf"), device=dev)
        out = torch.full(shape, 0.4, device=dev)
        C = C.reshape(C.shape[0], *([1] * (len(shape) - 1)), 3)
        zero = torch.zeros(3, device=dev)
        surfaces = [(zero, self.half, self.tex, self.res - 1, False)] + [
            (c, s, bt, 64, True) for c, s, bt in self.boxes]
        for center, half, tex, span, clamp_cell in surfaces:
            for axis in range(3):
                for sign in (-1.0, 1.0):
                    hit = self._plane(C, d, center, half, axis, sign, best)
                    if hit is None:
                        continue
                    ok, th, ua, va = hit
                    val = self._bilinear(tex[axis * 2 + (sign > 0)], ua, va, span, clamp_cell)
                    out = torch.where(ok, val, out)
                    best = torch.where(ok, th, best)
        return out, best, C.reshape(-1, 3), d

    @staticmethod
    def _plane(C, d, center, half, axis: int, sign: float, best):
        """Hits of the rays on one face of a box: (ok, distance, u, v), the
        face coordinates in [0, 1]; None where no ray hits it first."""
        a1, a2 = [i for i in range(3) if i != axis]
        bound = center[axis] + sign * half[axis]
        da = d[..., axis]
        th = (bound - C[..., axis]) / da
        p1 = C[..., a1] + th * d[..., a1]
        p2 = C[..., a2] + th * d[..., a2]
        ok = ((th > 1e-6) & torch.isfinite(th)
              & ((p1 - center[a1]).abs() <= half[a1] + 1e-6)
              & ((p2 - center[a2]).abs() <= half[a2] + 1e-6) & (th < best))
        if not bool(ok.any()):
            return None
        ua = ((p1 - center[a1]) / half[a1] + 1) * 0.5
        va = ((p2 - center[a2]) / half[a2] + 1) * 0.5
        return ok, th, ua, va

    @staticmethod
    def _bilinear(tex, u, v, span: int, clamp_cell: bool):
        x = u.clamp(0, 1).nan_to_num(0.0) * span
        y = v.clamp(0, 1).nan_to_num(0.0) * span
        if clamp_cell:
            x0 = x.long().clamp(0, span - 1)
            y0 = y.long().clamp(0, span - 1)
        else:
            x0 = x.floor().long().clamp(0, span - 1)
            y0 = y.floor().long().clamp(0, span - 1)
        ax = x - x0
        ay = y - y0
        w = tex.shape[-1]
        flat = tex.reshape(-1)
        i00 = y0 * w + x0
        return (flat[i00] * (1 - ax) * (1 - ay) + flat[i00 + 1] * ax * (1 - ay)
                + flat[i00 + w] * (1 - ax) * ay + flat[i00 + w + 1] * ax * ay)
