"""The generator: closed laps, and frames that the seed fixes."""

import numpy as np
import pytest
import torch

from slambench import harness
from slambench.gen.lap import render_lap
from slambench.gen.motion import lap_poses
from slambench.tests.small import small


@pytest.mark.parametrize("name", sorted(p.stem for p in (harness.ROOT / "workloads").glob("*.json")))
def test_lap_is_closed(name):
    """Frame lap_frames has frame 0's pose, and the step across the wrap is
    an ordinary step."""
    w = harness.load_json("workloads", name)
    lap = w["lap"]
    L = lap["lap_frames"]
    R, t = lap_poses(w["scene"]["scene_seed"], L, lap["kind"], lap["params"], L + 1)
    np.testing.assert_allclose(R[L], R[0], atol=1e-6)
    np.testing.assert_allclose(t[L], t[0], atol=1e-6)
    C = -np.einsum("nji,nj->ni", R, t)
    steps = np.linalg.norm(np.diff(C, axis=0), axis=1)
    assert steps[L - 1] <= 2.0 * np.median(steps)


def test_same_seed_same_frames():
    w, c = small("mh01_fleet8")
    w["lap"]["lap_frames"] = 40
    a = render_lap(w, c["camera"], 3000000007, "cpu")
    b = render_lap(w, c["camera"], 3000000007, "cpu")
    other = render_lap(w, c["camera"], 3000000008, "cpu")
    assert a["frames"].dtype == torch.uint8 and a["frames"].shape == (40, 120, 160)
    assert torch.equal(a["frames"], b["frames"])
    # Another seed draws other noise and exposure over the same world.
    diff = (a["frames"].float() - other["frames"].float()).abs()
    assert 0 < diff.mean() < 20
    np.testing.assert_array_equal(a["R"], other["R"])


def test_supersampled_frame_averages_its_rays():
    w, c = small("mh01_fleet8")
    w["lap"]["lap_frames"] = 40
    w["photometric"].update(noise_std=0.0, vignette=0.0, exposure_amp=0.0, supersample=2)
    lap = render_lap(w, c["camera"], 1, "cpu")
    cam2 = dict(c["camera"], fx=260.0, fy=260.0, cx=159.5, cy=119.5)
    fine = lap["room"].render(cam2, torch.from_numpy(lap["R"][:2]), torch.from_numpy(lap["t"][:2]),
                              320, 240)
    want = torch.round(torch.nn.functional.avg_pool2d(fine[:, None], 2)[:, 0].clamp(0, 1) * 255)
    assert (want - lap["frames"][:2].float()).abs().max() <= 1


def test_ground_truth_points_project_back():
    w, c = small("mh01_fleet8")
    w["lap"]["lap_frames"] = 40
    lap = render_lap(w, c["camera"], 1, "cpu")
    R, t = torch.from_numpy(lap["R"][1]), torch.from_numpy(lap["t"][1])
    uv = torch.tensor([[80.0, 60.0], [10.5, 100.25], [150.0, 7.0]])
    Xc = lap["room"].points(c["camera"], R, t, uv) @ R.T + t
    cam = c["camera"]
    back = torch.stack([cam["fx"] * Xc[:, 0] / Xc[:, 2] + cam["cx"],
                        cam["fy"] * Xc[:, 1] / Xc[:, 2] + cam["cy"]], -1)
    assert (back - uv).abs().max() < 1e-3
