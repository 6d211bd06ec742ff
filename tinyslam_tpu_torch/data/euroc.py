"""EuRoC MAV sequences (mirrors ``tinyslam_tpu/data/euroc.py``).

ASL layout: mav0/cam0/{data.csv, data/<timestamp>.png} and
mav0/state_groundtruth_estimate0/data.csv.  Gray PNGs decode through the
native loader and are undistorted on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tinyslam_tpu_torch.data.tum import quat_to_rotation

# EuRoC cam0 intrinsics (the public sensor.yaml).  Its radtan distortion is
# undistorted at load, so the device model stays a pure pinhole with these
# same intrinsics.
EUROC_CAM0 = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375)
EUROC_DIST = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
EUROC_SIZE = dict(height=480, width=752)


def _read_csv(path: Path) -> list[list[str]]:
    rows = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rows.append([c.strip() for c in line.split(",")])
    return rows


@dataclass
class EurocSequence:
    root: Path
    cam0: list[tuple[float, str]] = field(default_factory=list)
    groundtruth: list[tuple[float, np.ndarray, np.ndarray]] = field(default_factory=list)

    @classmethod
    def open(cls, root) -> "EurocSequence":
        root = Path(root)
        seq = cls(root=root)
        cam_dir = root / "mav0" / "cam0"
        for row in _read_csv(cam_dir / "data.csv"):
            seq.cam0.append((float(row[0]) * 1e-9, str(cam_dir / "data" / row[1])))
        gt = root / "mav0" / "state_groundtruth_estimate0" / "data.csv"
        if gt.exists():
            for row in _read_csv(gt):
                t = float(row[0]) * 1e-9
                tx, ty, tz = map(float, row[1:4])
                qw, qx, qy, qz = map(float, row[4:8])
                R = quat_to_rotation(qx, qy, qz, qw).T      # world->body (= cam)
                tt = -R @ np.array([tx, ty, tz])
                seq.groundtruth.append((t, R.astype(np.float32), tt.astype(np.float32)))
        return seq

    def frames(self, capacity: int = 8, threads: int = 4, undistort: bool = True):
        """Prefetched cam0 frames, radtan-undistorted by default when the
        frame is exactly 752x480 (EuRoC's k1 = -0.283 is far too strong to
        ignore)."""
        from tinyslam_tpu_torch.data.undistort import Undistorter
        from tinyslam_tpu_torch.native import FrameLoader

        und = Undistorter(EUROC_CAM0, EUROC_DIST, **EUROC_SIZE) if undistort else None
        loader = FrameLoader([p for _, p in self.cam0], capacity=capacity, threads=threads)
        hw = (EUROC_SIZE["height"], EUROC_SIZE["width"])
        try:
            for (t, _), img in zip(self.cam0, loader):
                if und is not None and img.shape[:2] == hw:
                    img = und(img)
                yield t, img
        finally:
            loader.close()

    def gt_positions(self) -> np.ndarray:
        return np.stack([-(R.T @ t) for _, R, t in self.groundtruth])
