"""The comparison calls a broken timed path wrong.  Each test drives a whole
run of a small cell on the CPU (the harness's look for a card skipped) with
one fault planted where the program produces its answers; the sound run
beside them is correct."""

import pytest
import torch

from slambench import harness
from slambench.reference.tslam.models import vo_device as ref_vo_device
from slambench.tests.small import SPEC, run_small, small
from tinyslam_tpu_torch.models import vo_device


def test_sound_runs_are_correct():
    out = run_small("mh01_fleet8")
    assert out["correct"], out["compared"]
    # The witness follows the program bit for bit; the ground truth is
    # observed beside it.
    assert out["compared"]["pose_gap"]["value"] == 0.0
    assert out["compared"]["count_gap"]["value"] == 0.0
    assert 0.0 < out["observed"]["gt_turn_deg"] < 5.0


def _half_batch(track_chunk_batch):
    def fault(cam, cfg, states, images, active, samplers, graph=True):
        B = images.shape[0]
        half = B // 2
        new, ys = track_chunk_batch(cam, cfg, states, images, active, samplers, graph)
        # Rows past the first half left out: their state and poses unchanged.
        keep = lambda a, b: torch.cat([a[:half], b[half:]])
        new = vo_device._tree_map(keep, new, states)
        C = images.shape[1]
        R = torch.cat([ys["R"][:half], states.R[half:, None].expand(-1, C, 3, 3)])
        t = torch.cat([ys["t"][:half], states.t[half:, None].expand(-1, C, 3)])
        return new, {**ys, "R": R, "t": t}
    return fault


def _batch_unchanged_state(track_chunk_batch):
    def fault(cam, cfg, states, images, active, samplers, graph=True):
        _, ys = track_chunk_batch(cam, cfg, states, images, active, samplers, graph)
        return states, ys
    return fault


def _batch_altered_pose(track_chunk_batch):
    def fault(cam, cfg, states, images, active, samplers, graph=True):
        new, ys = track_chunk_batch(cam, cfg, states, images, active, samplers, graph)
        t = ys["t"].clone()
        t[0, -1, 0] += 0.01       # one answer altered where it is produced
        return new, {**ys, "t": t}
    return fault


@pytest.mark.parametrize("fault", [_half_batch, _batch_unchanged_state, _batch_altered_pose])
def test_fleet_faults_are_caught(monkeypatch, fault):
    monkeypatch.setattr(vo_device, "track_chunk_batch", fault(vo_device.track_chunk_batch))
    out = run_small("mh01_fleet8")
    assert not out["correct"], out["compared"]


def _frozen_poses(track_chunk_batch):
    def fault(cam, cfg, states, images, active, samplers, graph=True):
        new, ys = track_chunk_batch(cam, cfg, states, images, active, samplers, graph)
        C = images.shape[1]
        # Every frame answered with the pose the chunk started from.
        return new, {**ys, "R": states.R[:, None].expand(-1, C, 3, 3).clone(),
                     "t": states.t[:, None].expand(-1, C, 3).clone()}
    return fault


def test_a_fault_the_reference_shares_shows_in_the_ground_truth_only(monkeypatch):
    """The same wrong rule in the program and in the reference: the witness
    sees nothing, the ground truth reads the whole turn of a 16-frame
    chunk (6-15 degrees on the lap) where sound runs read under 5."""
    monkeypatch.setattr(vo_device, "track_chunk_batch", _frozen_poses(vo_device.track_chunk_batch))
    monkeypatch.setattr(ref_vo_device, "track_chunk_batch",
                        _frozen_poses(ref_vo_device.track_chunk_batch))
    w, c = small("mh01_fleet8")
    w["chunk"] = 16
    out = harness.run_cell("mh01_fleet8", 3000000001, 1.0, False, device="cpu", workload=w,
                           config=c, spec=SPEC)
    assert out["compared"]["pose_gap"]["value"] == 0.0
    assert out["observed"]["gt_turn_deg"] > 6.0
