"""TUM RGB-D sequences (mirrors ``tinyslam_tpu/data/tum.py``).

A sequence directory holds rgb.txt / depth.txt / groundtruth.txt
(``timestamp path`` and ``timestamp tx ty tz qx qy qz qw`` lines) and the
rgb/ and depth/ image folders.  Frames decode through the native PNG
decoder and its prefetching loader (``native/``) and are undistorted on
the host (``data/undistort.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# TUM freiburg1 intrinsics (the published ROS calibration).
FR1_INTRINSICS = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3)
# fr1 plumb-bob distortion (the published ROS calibration), undistorted at load.
FR1_DIST = dict(k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633)
FR1_SIZE = dict(height=480, width=640)


def _read_list(path: Path) -> list[tuple[float, list[str]]]:
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out.append((float(parts[0]), parts[1:]))
    return out


def associate(a: list[tuple[float, list[str]]], b: list[tuple[float, list[str]]],
              max_dt: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (the standard TUM tool's)."""
    pairs = []
    j = 0
    used = set()
    for i, (ta, _) in enumerate(a):
        best = None
        best_dt = max_dt
        while j > 0 and b[j - 1][0] > ta - max_dt:
            j -= 1
        for k in range(j, len(b)):
            dt = abs(b[k][0] - ta)
            if b[k][0] > ta + max_dt:
                break
            if dt <= best_dt and k not in used:
                best = k
                best_dt = dt
        if best is not None:
            pairs.append((i, best))
            used.add(best)
    return pairs


def quat_to_rotation(qx, qy, qz, qw) -> np.ndarray:
    """Quaternion (normalized first) -> rotation matrix (camera-to-world
    for TUM ground truth)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


@dataclass
class TumSequence:
    root: Path
    rgb: list[tuple[float, str]] = field(default_factory=list)
    depth: list[tuple[float, str]] = field(default_factory=list)
    groundtruth: list[tuple[float, np.ndarray, np.ndarray]] = field(
        default_factory=list)   # (t, R world->cam, t world->cam)

    @classmethod
    def open(cls, root) -> "TumSequence":
        root = Path(root)
        seq = cls(root=root)
        seq.rgb = [(t, p[0]) for t, p in _read_list(root / "rgb.txt")]
        depth_file = root / "depth.txt"
        if depth_file.exists():
            seq.depth = [(t, p[0]) for t, p in _read_list(depth_file)]
        gt_file = root / "groundtruth.txt"
        if gt_file.exists():
            for t, vals in _read_list(gt_file):
                tx, ty, tz, qx, qy, qz, qw = map(float, vals[:7])
                R = quat_to_rotation(qx, qy, qz, qw).T      # world->cam
                tt = -R @ np.array([tx, ty, tz])
                seq.groundtruth.append((t, R.astype(np.float32), tt.astype(np.float32)))
        return seq

    def frames(self, capacity: int = 8, threads: int = 4, undistort: bool = True,
               dist: dict | None = None):
        """Prefetched RGB frames: yields (timestamp, (H, W, 3) or (H, W)
        uint8), plumb-bob-undistorted by default (fr1 calibration) when the
        frame is exactly 640x480."""
        from tinyslam_tpu_torch.data.undistort import Undistorter
        from tinyslam_tpu_torch.native import FrameLoader

        und = Undistorter(FR1_INTRINSICS, dist or FR1_DIST, **FR1_SIZE) if undistort else None
        loader = FrameLoader([self.root / p for _, p in self.rgb], capacity=capacity,
                             threads=threads)
        try:
            for (t, _), img in zip(self.rgb, loader):
                if und is not None and img.shape[:2] == (FR1_SIZE["height"],
                                                         FR1_SIZE["width"]):
                    img = und(img)
                yield t, img
        finally:
            loader.close()

    def gt_positions(self) -> np.ndarray:
        return np.stack([-(R.T @ t) for _, R, t in self.groundtruth])
