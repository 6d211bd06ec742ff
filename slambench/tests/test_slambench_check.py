"""The ground-truth half of the comparison: the angle between two rotations."""

import numpy as np

from slambench import check
from slambench.gen.motion import lap_poses


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _truth(n=16):
    R, _ = lap_poses(208, 571, "mav", {"radius": 2.0, "target": [0.0, 0.0, 1.0],
                                      "start_rad": -0.6, "jitter_pos": 0.01, "jitter_tgt": 0.02,
                                      "height": 0.2, "height_amp": 0.8, "height_cycles": 1,
                                      "nod_cycles": 2}, n)
    return R.astype(np.float64)


def test_the_angle_of_a_turned_pose_is_read_back():
    R_gt = _truth()
    turns = np.linspace(0.0, 170.0, 16)
    R = np.stack([_rot([1, -2, 0.5], np.radians(a)) @ r for a, r in zip(turns, R_gt)])
    np.testing.assert_allclose(check.rotation_deg(R, R_gt), turns, atol=1e-3)
    # Turned on the camera's side or on the world's: the same angle.
    R = np.stack([r @ _rot([0, 1, 0], np.radians(a)) for a, r in zip(turns, R_gt)])
    np.testing.assert_allclose(check.rotation_deg(R, R_gt), turns, atol=1e-3)


def test_frozen_poses_read_the_lap_turn():
    R_gt = _truth()
    frozen = check.rotation_deg(np.repeat(R_gt[:1], 16, 0), R_gt)
    assert frozen[0] < 1e-3 and frozen[-1] > 5.0
    assert check.rotation_deg(R_gt, R_gt).max() < 1e-4


def test_a_turn_read_against_the_truth():
    R_gt = _truth()
    # A tracker world turned as a whole reads no error: only the turn
    # within the frames counts.
    R = np.einsum("nij,jk->nik", R_gt, _rot([0.3, 1, 0], 0.8))
    assert check.turn_deg(R, R_gt) < 1e-4
    # Frozen poses read the ground truth's whole turn; one frame's pose
    # off by 2 degrees at the end reads 2.
    assert abs(check.turn_deg(np.repeat(R_gt[:1], 16, 0), R_gt)
               - check.rotation_deg(R_gt[-1:] @ R_gt[0].T, np.eye(3)[None])[0]) < 1e-4
    R = R_gt.copy()
    R[-1] = _rot([1, 0, 0], np.radians(2.0)) @ R[-1]
    assert abs(check.turn_deg(R, R_gt) - 2.0) < 1e-3
