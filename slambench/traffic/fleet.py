"""Traffic kind ``fleet``: B camera streams through ``track_chunk_batch``
(the captured ``BatchGraph`` on the card), closed loop, a chunk of
``chunk`` steps at a time.

Set-up renders the workload's lap on the card; stream b flies the same
lap started ``b * lap_frames / B`` frames in.  Each stream's tracker is
seeded with the map of its first frame (its features at their ray-cast
ground-truth points, ``VOState.seeded``), and has a ``Sampler`` of its
own.  One warm-up chunk captures the batched graph.  In the window each
chunk's (B, chunk, H, W) uint8 frames are gathered on the host into
pinned memory, uploaded, tracked, and the chunk's poses and per-frame
summaries are read back to the host before the next chunk goes in.  A
frame counts as failed where its stream reports it not tracked.  In a
traced run a CUDA event pair on the current stream spans each chunk's
upload and ``track_chunk_batch`` call (not the host's gather before it
nor the read-back after it).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from slambench import check, kernels, trace
from slambench.gen.lap import render_lap
from slambench.stats import Reservoir
from slambench.traffic.common import camera, seeded_state


class Cell:
    def __init__(self, run):
        from tinyslam_tpu_torch.config import SlamConfig
        from tinyslam_tpu_torch.models.vo_device import VOState
        from tinyslam_tpu_torch.utils.draws import Sampler

        self.run = run
        w = run.workload
        dev = run.device
        self.cfg = SlamConfig.from_json(json.dumps(run.config["slam"]))
        self.cam = camera(run.config)
        self.B, self.C = int(w["streams"]), int(w["chunk"])
        lap = render_lap(w, run.config["camera"], run.seed, dev)
        L = len(lap["R"])
        self.offsets = [b * L // self.B for b in range(self.B)]
        self.states = VOState.stack([seeded_state(self.cfg, run.config, lap, o)
                                     for o in self.offsets])
        self.frames = lap["frames"].cpu().numpy()
        self.truth = lap["R"]
        del lap
        self.samplers = [Sampler(run.seed + b) for b in range(self.B)]
        H, W = self.frames.shape[1:]
        self.staging = torch.empty((self.B, self.C, H, W), dtype=torch.uint8,
                                   pin_memory=dev.type == "cuda")
        self.active = np.ones((self.B, self.C), dtype=bool)
        self.next = 1
        self.sample = Reservoir(int(w["check"]["chunks"]), run.seed)
        self._chunk()                       # warm-up: the batched graph's capture

    def _chunk(self, events=None) -> np.ndarray:
        """Upload, track and read back the next chunk of every stream;
        returns its (B, C, 6) per-frame counts (``check.COUNT_FIELDS``)."""
        from tinyslam_tpu_torch.models.vo_device import track_chunk_batch

        L = len(self.frames)
        idx = (np.asarray(self.offsets)[:, None] + self.next + np.arange(self.C)) % L
        np.take(self.frames, idx, axis=0, out=self.staging.numpy())
        ev = events.start() if events else None
        images = self.staging.to(self.run.device, non_blocking=True)
        start = self.states
        self.states, ys = track_chunk_batch(self.cam, self.cfg, start, images, self.active,
                                            self.samplers)
        if events:
            events.stop(ev)
        R, t = ys["R"].cpu().numpy(), ys["t"].cpu().numpy()
        rows = check.summary_rows(ys["summary"].cpu().numpy().reshape(self.B * self.C, -1)
                                  ).reshape(self.B, self.C, -1)
        self.sample.offer(lambda: {"state": check.clone_tree(start), "next": self.next,
                                   "after": check.clone_tree(self.states),
                                   "R": R, "t": t, "rows": rows})
        self.next += self.C
        return rows

    def window(self, seconds: float) -> dict:
        events = trace.EventPairs() if self.run.trace else None
        tracked = frames = steps = 0
        t_start = time.perf_counter()
        while True:
            rows = self._chunk(events)
            t1 = time.perf_counter()
            frames += rows.shape[0] * rows.shape[1]
            tracked += int(rows[..., 4].sum())
            steps += self.C
            if t1 - t_start >= seconds:
                break
        rec = {"window_s": t1 - t_start, "attempted": frames, "failed": frames - tracked,
               "tracked": tracked, "steps": steps}
        if events:
            rec["chunk_card_ms"] = events.ms()
        return rec

    def traced(self, rec: dict) -> None:
        w = self.run.workload
        reps = int(w["trace"]["kernel_reps"])
        frames = torch.from_numpy(self.frames[np.asarray(self.offsets)]).to(self.run.device)
        s = self.states
        rec["k1"] = kernels.k1(frames, s.threshold, self.cfg.frontend, reps)
        rec["k2"] = kernels.k2(frames, s.threshold, self.cfg, self.cam, s.map, s.R, s.t, reps)
        rec["profile"] = trace.profiled(lambda i: self._chunk(),
                                        int(w["trace"]["profiled_chunks"]))
        rec["breakdown"] = {"device_ops": rec["profile"]["device_ops"],
                            "idle_gaps": trace.idle_gaps(lambda i: self._chunk(),
                                                         int(w["trace"]["labelled_chunks"]))}

    def release(self) -> dict:
        kept = {"chunks": self.sample.items, "frames": self.frames, "offsets": self.offsets,
                "truth": self.truth}
        self.states = self.staging = None
        return kept


def compare(run, kept: dict) -> dict:
    """The sampled chunks against the ground truth and against the
    reference's batched step from the program's batched state (see
    ``slambench/check.py``).  The streams start from seeded maps, so there
    is no bootstrap to check."""
    ref, cfg, cam = check.ref_setup(run.config)
    w = run.workload
    B, C = int(w["streams"]), int(w["chunk"])
    frames, L = kept["frames"], len(kept["frames"])
    active = np.ones((B, C), dtype=bool)
    pose_gap = count_gap = gt_turn = 0.0
    for item in kept["chunks"]:
        idx = (np.asarray(kept["offsets"])[:, None] + item["next"] + np.arange(C)) % L
        images = torch.from_numpy(frames[idx]).to(run.device)
        outs = []
        for control in ([None, run.control] if run.control else [None]):
            with check.precision(control):
                after, ys = ref["vo_device"].track_chunk_batch(
                    cam, cfg, check.to_reference(item["state"], ref), images, active,
                    [ref["draws"].Sampler(run.seed + b) for b in range(B)], graph=False)
            rows = check.summary_rows(ys["summary"].cpu().numpy().reshape(B * C, -1))
            outs.append((ys["R"].cpu().numpy(), ys["t"].cpu().numpy(), rows.reshape(B, C, -1),
                         after))
        program = outs[1] if run.control else (item["R"], item["t"], item["rows"],
                                                item["after"])
        p, c = check.gaps(*program[:3], *outs[0][:3])
        p = max(p, check.state_gap(program[3], outs[0][3]))
        pose_gap, count_gap = max(pose_gap, p), max(count_gap, c)
        for b in range(B):
            tracked = program[2][b, :, 4] != 0
            if tracked.sum() >= 2:
                gt_turn = max(gt_turn, check.turn_deg(program[0][b][tracked],
                                                      kept["truth"][idx[b][tracked]]))
    return {"gt_turn_deg": gt_turn, "pose_gap": pose_gap, "count_gap": count_gap}
