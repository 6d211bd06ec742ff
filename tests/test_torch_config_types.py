"""The port's configuration, descriptor packing, constant tables and
renderer against the JAX package's: equal, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_parity as P
from tinyslam_tpu import config as jc
from tinyslam_tpu import types as jt
from tinyslam_tpu.data import synthetic as js
from tinyslam_tpu.ops import brief as jbrief, fast as jfast, image as jimage
from tinyslam_tpu_torch import config as tc
from tinyslam_tpu_torch import types as tt
from tinyslam_tpu_torch.data import synthetic as ts
from tinyslam_tpu_torch.ops import brief as tbrief, fast as tfast, image as timage


@pytest.mark.parametrize("name", ["default", "slice", "small"])
def test_config_json_equal(name):
    if name == "default":
        j, t = jc.SlamConfig(), tc.SlamConfig()
    elif name == "slice":
        j = jc.SlamConfig(vo=jc.VOConfig(**P.NO_KEYFRAMES))
        t = tc.slice_config()
    else:
        j, t = P.configs()
    assert t.to_json() == j.to_json()
    assert tc.SlamConfig.from_json(t.to_json()) == t


def test_pack_unpack_signs_match_jax():
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 2**32 - 1, (64, 8), np.uint32)
    desc[0] = 0xFFFFFFFF     # every bit, including the int32 sign bit
    desc[1] = 0
    t = tt.from_numpy(desc)
    assert t.dtype == torch.int32
    bits_j = np.asarray(jt.unpack_descriptor_bits(jnp.asarray(desc)))
    bits_t = tt.unpack_descriptor_bits(t).numpy()
    np.testing.assert_array_equal(bits_t, bits_j)
    np.testing.assert_array_equal(
        tt.descriptor_signs(t).numpy(), np.asarray(jt.descriptor_signs(jnp.asarray(desc))))
    packed = tt.pack_descriptor_bits(torch.from_numpy(bits_j))
    np.testing.assert_array_equal(tt.to_numpy(packed, desc=True), desc)


def test_features_numpy_round_trip():
    rng = np.random.default_rng(1)
    d = {"xy": rng.random((16, 2), dtype=np.float32),
         "level": rng.integers(0, 4, 16).astype(np.int32),
         "angle": rng.random(16, dtype=np.float32),
         "score": rng.random(16, dtype=np.float32),
         "desc": rng.integers(0, 2**32 - 1, (16, 8), np.uint32),
         "valid": rng.random(16) > 0.5}
    back = tt.Features.from_numpy(d).to_numpy()
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)


def test_constant_tables_equal():
    np.testing.assert_array_equal(tbrief.BRIEF_PATTERN, jbrief.BRIEF_PATTERN)
    np.testing.assert_array_equal(tbrief._binned_tables(16), jbrief._binned_tables(16))
    assert tfast.RING16 == jfast.RING16
    np.testing.assert_array_equal(timage.gaussian_kernel(2.0), jimage.gaussian_kernel(2.0))


def test_renderer_bit_equal():
    jcam, tcam = P.cameras()
    jroom = js.TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2, clutter=2)
    troom = ts.TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2, clutter=2)
    jposes = js.orbit_trajectory(3, radius=2.0, step=0.02, start=-0.35,
                                 target=(0.0, 0.0, 2.0))
    tposes = ts.orbit_trajectory(3, radius=2.0, step=0.02, start=-0.35,
                                 target=(0.0, 0.0, 2.0))
    uv = np.random.default_rng(4).uniform(0, [P.WIDTH, P.HEIGHT], (200, 2))
    for (Rj, tj), (Rt, tt_) in zip(jposes, tposes):
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt_, tj)
        np.testing.assert_array_equal(
            troom.render(tcam, Rt, tt_, P.WIDTH, P.HEIGHT),
            jroom.render(jcam, Rj, tj, P.WIDTH, P.HEIGHT))
        np.testing.assert_array_equal(troom.raycast(tcam, Rt, tt_, uv),
                                      jroom.raycast(jcam, Rj, tj, uv))


def test_camera_rounds_to_float32():
    jcam, tcam = P.cameras()
    assert tcam.fx == float(jcam.fx) and tcam.cx == float(jcam.cx)
    odd = type(tcam).create(517.3, 516.5, 318.6, 255.3)
    assert odd.fx == float(np.float32(517.3))
