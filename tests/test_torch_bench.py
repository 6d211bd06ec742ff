"""The port's bench (``tinyslam_tpu_torch/bench.py``) against the JAX
package's (``bench.py``), on the CPU.

- Both renderers give ``bench.py``'s frames byte for byte (3 frames).
- ``bench_tracked`` against ``bench.bench_tracked`` at the 160x120 set-up
  of ``tests/torch_parity.py`` (the config and the renderer patched the
  same way on both sides, the JAX package's draws replayed by
  ``JaxSampler``): the same bootstrap frame, ``frames_timed`` and
  ``tracked_frac``, and the timed frames' tracking and keyframe flags
  equal.  Inliers and landmark counts within 2% and the RMSE within 2e-2
  px: the two packages' float32 products round otherwise, as in
  ``tests/test_torch_bootstrap.py``.
- Rounds repeat their work: every round's summaries are bit-equal, also
  when a blank frame makes a timed frame relocalize with the stateful
  ``Sampler``'s draws.
- ``track_chunk`` leaves the ``VOState`` it was given bit-equal to a clone
  (through a keyframe with its window BA and a relocalization).
- Without a card ``main`` raises and prints nothing.
- ``bench.py``'s input perturbation turns uint8 frames into float32 above
  1.0 (a fault of the reference, documented, not repaired there).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_parity as P
from tinyslam_tpu_torch import bench as tbench
from tinyslam_tpu_torch.models.vo_device import DeviceVO, _tree_map, track_chunk
from tinyslam_tpu_torch.ops import fast_cuda
from tinyslam_tpu_torch.utils.draws import Sampler

REPO = Path(__file__).resolve().parents[1]
CHUNK, CHUNKS_TIMED = 4, 2
N_FRAMES = tbench.BOOT_FRAMES + CHUNK * (CHUNKS_TIMED + 1)
BOOTSTRAP_FRAME = 6         # the 160x120 orbit's, as tests/test_torch_bootstrap.py finds it


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    """(frames, JAX camera, port camera) of the 160x120 orbit."""
    frames, _, _ = P.orbit(N_FRAMES)
    return (frames, *P.cameras())


@pytest.mark.parametrize("row", ["room", "eval_grade"])
def test_renders_equal_bench_py(row):
    jbench = _jax_bench()
    name = f"_render_{row}_sequence"
    jcam, jframes = getattr(jbench, name)(3)
    tcam, tframes = getattr(tbench, name)(3)
    assert (tcam.fx, tcam.fy, tcam.cx, tcam.cy) == tuple(
        float(getattr(jcam, k)) for k in ("fx", "fy", "cx", "cy"))
    assert len(tframes) == len(jframes) == 3
    for t, j in zip(tframes, jframes):
        j = np.asarray(j)
        assert t.dtype == j.dtype == (np.uint8 if row == "eval_grade" else np.float32)
        assert t.shape == j.shape == (480, 640)
        assert t.tobytes() == j.tobytes()


def test_bench_tracked_matches_jax_bench(monkeypatch, small):
    import tinyslam_tpu.config as jconfig
    import tinyslam_tpu.models.vo_device as jvo

    frames, jcam, tcam = small
    jcfg, tcfg = P.configs(keyframes=True)
    jbench = _jax_bench()
    monkeypatch.setattr(jconfig, "SlamConfig", lambda: jcfg)
    monkeypatch.setattr(jbench, "_render_room_sequence", lambda n, w, h: (jcam, frames[:n]))
    monkeypatch.setattr(tbench, "_render_room_sequence", lambda n, w, h: (tcam, frames[:n]))
    made, summaries = [], []
    jax_device_vo, jax_track_chunk = jvo.DeviceVO, jvo.track_chunk
    monkeypatch.setattr(jvo, "DeviceVO", lambda *a, **k: made.append(jax_device_vo(*a, **k))
                        or made[-1])

    def recording(*a):
        state, ys = jax_track_chunk(*a)
        summaries.append(np.asarray(ys["summary"]))
        return state, ys

    monkeypatch.setattr(jvo, "track_chunk", recording)
    ref = jbench.bench_tracked(chunk=CHUNK, chunks_timed=CHUNKS_TIMED, rounds=1)
    got = tbench.bench_tracked(chunk=CHUNK, chunks_timed=CHUNKS_TIMED, rounds=1,
                               device="cpu", cfg=tcfg, sampler=P.JaxSampler())
    assert got["boot_frame"] == made[0].host_frames - 1 == BOOTSTRAP_FRAME
    assert got["frames_timed"] == ref["frames_timed"] == CHUNK * CHUNKS_TIMED
    assert got["tracked_frac"] == ref["tracked_frac"]
    want = np.concatenate(summaries[1:])        # the warm-up chunk first
    have = got["round_summaries"][0]
    np.testing.assert_array_equal(have[:, 3:5], want[:, 3:5])    # tracking, keyframe
    for col in (1, 2, 5):           # matches, inliers, landmarks
        np.testing.assert_allclose(have[:, col], want[:, col], rtol=0.02)
    np.testing.assert_allclose(have[:, 6], want[:, 6], atol=2e-2)


class _LoggingSampler(Sampler):
    """``Sampler`` that lists the streams it draws for."""

    def __init__(self, seed: int):
        super().__init__(seed)
        self.keys = []

    def uniform(self, shape, device, key=None):
        self.keys.append(tuple(int(k) if isinstance(k, torch.Tensor) else k for k in key))
        return super().uniform(shape, device, key)


# Under Sampler(0) the 160x120 orbit bootstraps at frame 3, so frames 8-15
# are timed; a blank frame 12 is lost and frame 13 relocalizes.
BLANK = 12


@pytest.mark.parametrize("blank", [False, True])
def test_rounds_repeat_their_work(small, blank):
    frames, _, tcam = small
    if blank:
        frames = [np.zeros_like(f) if i == BLANK else f for i, f in enumerate(frames)]
    tcfg = P.torch_config(keyframes=True)
    sampler = _LoggingSampler(0)
    got = tbench.bench_tracked(chunk=CHUNK, chunks_timed=CHUNKS_TIMED, rounds=2,
                               device="cpu", cfg=tcfg, sampler=sampler, frames=frames)
    first, second = got["round_summaries"]
    assert first.tobytes() == second.tobytes()
    assert got["frames_timed"] == 2 * CHUNK * CHUNKS_TIMED
    assert len(got["round_fps"]) == 2 and got["tracked_fps"] > 0
    timed = got["boot_frame"] + 1 + CHUNK
    tracked = first[:, 3]
    if not blank:
        assert got["tracked_frac"] == 1.0
        assert not any(k[0] == "reloc" for k in sampler.keys)
    else:
        assert timed < BLANK < timed + len(tracked) - 1
        assert tracked[BLANK - timed] == 0 and tracked[BLANK + 1 - timed] == 1
        # The relocalization drew in both timed rounds and the instrumented one.
        assert sampler.keys.count(("reloc", BLANK + 1)) >= 3
    per_frame = got["per_frame"]        # the CPU launches no kernel and never syncs
    assert (per_frame["syncs_per_frame"], per_frame["k1_per_frame"]) == (0, 0)
    assert per_frame["busy_share"] is None


def test_track_chunk_leaves_its_input_state(small):
    frames, _, tcam = small
    tcfg = P.torch_config(keyframes=True)
    vo = DeviceVO(tcfg, tcam, chunk=CHUNK, device="cpu", sampler=Sampler(0))
    i = 0
    while not vo.initialized:
        vo.process(frames[i])
        i += 1
    # Lost on entry: the first frame relocalizes; a keyframe with its window
    # BA follows within the 12 frames.
    state = vo.state.replace(last_tracking=torch.tensor(False))
    before = _tree_map(torch.clone, state)
    images = torch.from_numpy(np.stack(frames[i:i + 3 * CHUNK]))
    _, ys = track_chunk(tcam, tcfg, state, images, [True] * (3 * CHUNK), Sampler(1))
    assert ys["summary"][:, 4].sum() >= 1          # a keyframe was inserted
    flat_before, flat_after = before.to_numpy(), state.to_numpy()
    assert flat_before.keys() == flat_after.keys()
    for k in flat_before:
        assert flat_before[k].tobytes() == flat_after[k].tobytes(), k


def test_bench_frontend_runs_on_the_cpu(small):
    frames, _, _ = small
    cfg = P.torch_config().frontend
    got = tbench.bench_frontend(2, device="cpu", cfg=cfg, frames=frames[:3])
    assert len(got["round_fps"]) == 2 and got["frontend_fps"] > 0
    assert got["per_frame"]["k1_per_frame"] == 0     # the plain version on the CPU


def test_main_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = fast_cuda.LAUNCHES
    with pytest.raises(RuntimeError, match="card"):
        tbench.main([])
    assert capsys.readouterr().out == ""
    assert fast_cuda.LAUNCHES == before


def test_reference_perturbation_makes_uint8_frames_float():
    """``bench.py:132`` adds ``np.float32(1e-6)`` to its timed chunks each
    round: a uint8 chunk becomes float32 in 0..255, which ``track_step``
    does not rescale (it rescales only uint8)."""
    import jax.numpy as jnp

    chunk = jnp.asarray(np.array([[0, 128, 255]], np.uint8))
    perturbed = chunk + np.float32(1e-6)
    assert perturbed.dtype == jnp.float32
    assert float(perturbed.max()) > 1.0 and float(perturbed.max()) == pytest.approx(255.0)
