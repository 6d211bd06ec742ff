"""The port's data layer against the JAX package's, on the same seeded numpy
inputs, with no tolerance: the PNG writer, radtan undistortion, the TUM
and EuRoC readers, the eval-grade renderer (distorted camera,
photometrics, the handheld and MAV trajectories) and the sequence writers
give equal arrays and byte-identical files, and both packages' loaders
give equal frames and ground truth from one written sequence, at 640x480
and 752x480 where undistortion runs.  Then tests/test_undistort.py's
OpenCV checks against the port."""

from __future__ import annotations

import numpy as np
import pytest

import tinyslam_tpu.data.euroc as jeuroc
import tinyslam_tpu.data.png as jpng
import tinyslam_tpu.data.synthetic as jsyn
import tinyslam_tpu.data.tum as jtum
import tinyslam_tpu.data.undistort as jund
import tinyslam_tpu_torch.data.euroc as teuroc
import tinyslam_tpu_torch.data.png as tpng
import tinyslam_tpu_torch.data.synthetic as tsyn
import tinyslam_tpu_torch.data.tum as ttum
import tinyslam_tpu_torch.data.undistort as tund
from tests import torch_parity as P
from tinyslam_tpu.geometry.camera import PinholeCamera as JCam
from tinyslam_tpu_torch.geometry.camera import PinholeCamera as TCam

eq = np.testing.assert_array_equal


def _equal(a, b):
    """Equal nested results: arrays (dtype too), tuples, lists, scalars."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        eq(a, b)


@pytest.fixture(scope="module")
def jax_loader(tmp_path_factory):
    """The JAX package's loaders read through a private build of its own
    native sources."""
    import tinyslam_tpu.native as jn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_SO", P.jax_native_library(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jn, "_lib", None)
        yield jn


# ---- PNG writer --------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((7, 9), np.uint8), ((5, 6, 3), np.uint8),
                                         ((4, 11), np.uint16)])
def test_write_png_byte_identical(tmp_path, shape, dtype):
    img = np.random.default_rng(len(shape)).integers(0, np.iinfo(dtype).max, shape,
                                                     dtype=dtype)
    jpng.write_png(tmp_path / "j.png", img)
    tpng.write_png(tmp_path / "t.png", img)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()


@pytest.mark.parametrize("img", [np.zeros((3, 4, 4), np.uint8), np.zeros((3, 4, 3), np.uint16),
                                 np.zeros((3, 4), np.float32)])
def test_write_png_refuses_the_same(tmp_path, img):
    for m in (jpng, tpng):
        with pytest.raises(ValueError):
            m.write_png(tmp_path / "x.png", img)


# ---- undistortion -------------------------------------------------------------

DISTS = {"fr1": (jtum.FR1_INTRINSICS, jtum.FR1_DIST, 480, 640),
         "euroc": (jeuroc.EUROC_CAM0, jeuroc.EUROC_DIST, 480, 752)}


def test_constants_equal():
    assert ttum.FR1_INTRINSICS == jtum.FR1_INTRINSICS and ttum.FR1_DIST == jtum.FR1_DIST
    assert ttum.FR1_SIZE == jtum.FR1_SIZE
    assert teuroc.EUROC_CAM0 == jeuroc.EUROC_CAM0 and teuroc.EUROC_DIST == jeuroc.EUROC_DIST
    assert teuroc.EUROC_SIZE == jeuroc.EUROC_SIZE


@pytest.mark.parametrize("name", list(DISTS))
def test_radtan_distort_and_inverse(name):
    _, dist, _, _ = DISTS[name]
    rng = np.random.default_rng(11)
    x, y = rng.uniform(-1.5, 1.5, (2, 500))      # far out too: the clamps
    _equal(tund.radtan_distort(x, y, **dist), jund.radtan_distort(x, y, **dist))
    _equal(tund.radtan_undistort_points(x, y, **dist),
           jund.radtan_undistort_points(x, y, **dist))
    _equal(tund.radtan_undistort_points(x[:7].tolist(), y[:7].tolist(), iters=3, **dist),
           jund.radtan_undistort_points(x[:7].tolist(), y[:7].tolist(), iters=3, **dist))


@pytest.mark.parametrize("name", list(DISTS))
def test_undistort_maps(name):
    intr, dist, h, w = DISTS[name]
    _equal(tund.undistort_maps(intr, dist, h, w), jund.undistort_maps(intr, dist, h, w))


@pytest.mark.parametrize("kind", ["uint8", "uint8 rgb", "float32", "uint16"])
def test_remap_bilinear(kind):
    rng = np.random.default_rng(12)
    shape = (40, 52, 3) if kind.endswith("rgb") else (40, 52)
    dtype = np.dtype(kind.split()[0])
    img = (rng.random(shape) * (255 if dtype != np.uint16 else 60000)).astype(dtype)
    mx = rng.uniform(-3, 55, (30, 41)).astype(np.float32)   # out of range: the clamp
    my = rng.uniform(-3, 43, (30, 41)).astype(np.float32)
    _equal(tund.remap_bilinear(img, mx, my), jund.remap_bilinear(img, mx, my))


@pytest.mark.parametrize("name", list(DISTS))
def test_undistorter(name):
    intr, dist, h, w = DISTS[name]
    img = np.random.default_rng(13).integers(0, 256, (h, w), dtype=np.uint8)
    j, t = jund.Undistorter(intr, dist, h, w), tund.Undistorter(intr, dist, h, w)
    assert not t.identity and not j.identity
    _equal(t(img), j(img))
    assert tund.Undistorter(intr, {}, h, w)(img) is img


# ---- TUM / EuRoC readers ------------------------------------------------------

def test_read_list_and_csv(tmp_path):
    (tmp_path / "a.txt").write_text("# ts path\n\n 1.5 rgb/a.png extra\n2.25 rgb/b.png\n")
    assert ttum._read_list(tmp_path / "a.txt") == jtum._read_list(tmp_path / "a.txt")
    (tmp_path / "b.csv").write_text("#timestamp [ns],filename\n 17 , x.png\n\n18,y.png\n")
    assert teuroc._read_csv(tmp_path / "b.csv") == jeuroc._read_csv(tmp_path / "b.csv")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_associate(seed):
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.uniform(0, 3, 60))
    tb = np.sort(np.concatenate([ta[::2] + rng.normal(0, 0.008, 30), rng.uniform(0, 3, 25)]))
    a = [(float(t), ["a"]) for t in ta]
    b = [(float(t), ["b"]) for t in tb]
    for max_dt in (0.005, 0.02, 0.1):
        got = ttum.associate(a, b, max_dt)
        assert got == jtum.associate(a, b, max_dt) and len(got) > 0


def test_quat_to_rotation_and_back():
    rng = np.random.default_rng(14)
    for q in rng.normal(0, 1, (20, 4)) * 3:      # unnormalized on purpose
        _equal(ttum.quat_to_rotation(*q), jtum.quat_to_rotation(*q))
        R = ttum.quat_to_rotation(*q)
        _equal(tsyn.rotation_to_quat(R), jsyn.rotation_to_quat(R))
    for R in (np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])):
        _equal(tsyn.rotation_to_quat(R), jsyn.rotation_to_quat(R))   # trace <= 0 branches


# ---- the renderer --------------------------------------------------------------

def _both(fn_name, *args, **kw):
    """fn(rng, ...) of each package from the same seed; the results and
    the generators' next draws must agree (same draws in the same order)."""
    out = []
    for m in (jsyn, tsyn):
        rng = np.random.default_rng(21)
        out.append((getattr(m, fn_name)(rng, *args, **kw), rng.random(3)))
    return out


@pytest.mark.parametrize("fn,args,kw", [
    ("random_points", (40,), {}),
    ("random_points", (5,), dict(center=(1.0, 2.0, 3.0), extent=(0.5, 0.5, 9.0))),
    ("landmark_patches", (6,), {}),
    ("landmark_patches", (3,), dict(size=5)),
    ("_smooth_walk", (50, 3, 0.01, 12), {}),
    ("handheld_trajectory", (30,), {}),
    ("handheld_trajectory", (17,), dict(step=0.03, jitter_pos=0.002, height_amp=0.3)),
    ("mav_trajectory", (25,), {}),
    ("exposure_track", (40,), {}),
    ("exposure_track", (12,), dict(amp=0.4)),
])
def test_seeded_generators(fn, args, kw):
    (a, na), (b, nb) = _both(fn, *args, **kw)
    _equal(a, b)
    eq(na, nb)


def test_project_and_render_points():
    rng = np.random.default_rng(15)
    X = jsyn.random_points(rng, 300, center=(0.0, 0.0, 4.0))
    jc, tc = P.cameras()
    R, t = tsyn.orbit_trajectory(3, radius=2.0)[1]
    for kw in (dict(), dict(noise_px=0.7), dict(noise_px=0.5, outlier_frac=0.2)):
        ja = jsyn.project_points(jc, R, t, X, 160, 120, rng=np.random.default_rng(3), **kw)
        ta = tsyn.project_points(tc, R, t, X, 160, 120, rng=np.random.default_rng(3), **kw)
        _equal(ta, ja)
    _equal(tsyn.project_points(tc, R, t, X), jsyn.project_points(jc, R, t, X))
    uv, vis = ja
    _equal(tsyn.render_dots(uv, vis, 160, 120), jsyn.render_dots(uv, vis, 160, 120))
    _equal(tsyn.render_dots(uv, vis, 160, 120, radius=1, bg=0.1, fg=0.8),
           jsyn.render_dots(uv, vis, 160, 120, radius=1, bg=0.1, fg=0.8))
    patches = jsyn.landmark_patches(np.random.default_rng(2), len(uv))
    _equal(tsyn.render_patches(uv, vis, patches, 160, 120),
           jsyn.render_patches(uv, vis, patches, 160, 120))
    _equal(tsyn.normalized(tc, uv), jsyn.normalized(jc, uv))
    _equal(tsyn.normalized(tc, uv.astype(np.float64)), jsyn.normalized(jc, uv.astype(np.float64)))


@pytest.mark.parametrize("quantize", [True, False])
def test_apply_photometrics(quantize):
    img = np.random.default_rng(16).random((30, 44)).astype(np.float32)
    out = []
    for m in (jsyn, tsyn):
        rng = np.random.default_rng(5)
        out.append((m.apply_photometrics(img, rng, exposure=1.13, vignette=0.3,
                                         quantize=quantize), rng.random(2)))
    _equal(out[0], out[1])


def test_render_with_distortion_keys_the_ray_cache():
    """The port caches rays per room; an undistorted render of the same
    camera and size must not reuse the distorted grid, nor the reverse."""
    jc, tc = (C.create(**jtum.FR1_INTRINSICS) for C in (JCam, TCam))
    jroom = jsyn.TexturedRoom(np.random.default_rng(4), tex_res=32, octaves=2, clutter=3)
    troom = tsyn.TexturedRoom(np.random.default_rng(4), tex_res=32, octaves=2, clutter=3)
    R, t = tsyn.look_at(np.array([0.3, 0.2, -1.0]), np.array([0.0, 0.0, 1.0]))
    for dist in (None, jtum.FR1_DIST, None, jeuroc.EUROC_DIST):
        got = troom.render(tc, R, t, 96, 72, dist=dist)
        _equal(got, jroom.render(jc, R, t, 96, 72, dist=dist))
    assert not np.array_equal(troom.render(tc, R, t, 96, 72),
                              troom.render(tc, R, t, 96, 72, dist=jtum.FR1_DIST))


def _fr1_like(m, cam_cls, n, width, height, dist, seed=101):
    """eval_ate's fr1_desk-like sequence, cut in size."""
    rng = np.random.default_rng(seed)
    room = m.TexturedRoom(rng, tex_res=32, octaves=2, clutter=4)
    cam = cam_cls.create(fx=130.0 * width / 160, fy=130.0 * width / 160,
                         cx=width / 2 - 0.5, cy=height / 2 - 0.5)
    poses = m.handheld_trajectory(rng, n)
    return m.render_sequence(rng, poses, cam, width, height, room, dist=dist), poses, rng


@pytest.mark.parametrize("photometric", [True, False])
def test_render_sequence_seed_101(photometric):
    """160x120 through the distorted fr1 camera: the uint8 frames are
    bit-equal, and the generators end in the same state."""
    out = []
    for m, C in ((jsyn, JCam), (tsyn, TCam)):
        rng = np.random.default_rng(101)
        room = m.TexturedRoom(rng, tex_res=32, octaves=2, clutter=4)
        cam = C.create(**P.CAMERA)
        poses = m.handheld_trajectory(rng, 5)
        frames = m.render_sequence(rng, poses, cam, 160, 120, room, dist=jtum.FR1_DIST,
                                   photometric=photometric)
        out.append((frames, poses, rng.random(2)))
    _equal(out[0], out[1])
    assert out[1][0][0].dtype == (np.uint8 if photometric else np.float32)


def test_sequence_writers_byte_identical(tmp_path):
    frames, poses, _ = _fr1_like(tsyn, TCam, 4, 64, 48, jtum.FR1_DIST)
    rgb = [np.stack([f, f // 2, 255 - f], -1) for f in frames]
    for name, writer, images in (("tum", "write_tum_sequence", rgb),
                                 ("euroc", "write_euroc_sequence", frames)):
        getattr(jsyn, writer)(tmp_path / f"j_{name}", images, poses)
        getattr(tsyn, writer)(tmp_path / f"t_{name}", images, poses)
        jfiles = sorted(p.relative_to(tmp_path / f"j_{name}")
                        for p in (tmp_path / f"j_{name}").rglob("*") if p.is_file())
        tfiles = sorted(p.relative_to(tmp_path / f"t_{name}")
                        for p in (tmp_path / f"t_{name}").rglob("*") if p.is_file())
        assert jfiles == tfiles and len(jfiles) == 6
        for f in jfiles:
            assert (tmp_path / f"j_{name}" / f).read_bytes() == \
                (tmp_path / f"t_{name}" / f).read_bytes(), f


# ---- both packages' loaders on one written sequence -----------------------------

def _loaded(seq):
    ts, frames = zip(*seq.frames(capacity=3, threads=2))
    return list(ts), list(frames), seq.groundtruth, seq.gt_positions()


@pytest.mark.parametrize("size", [(160, 120), (640, 480)])
def test_tum_sequences_load_equal(tmp_path, jax_loader, size):
    """RGB frames; at 640x480 both undistort with the fr1 calibration."""
    w, h = size
    frames, poses, _ = _fr1_like(tsyn, TCam, 2, w, h, ttum.FR1_DIST)
    rgb = [np.stack([f, np.roll(f, 3, 1), f // 3], -1) for f in frames]
    tsyn.write_tum_sequence(tmp_path, rgb, poses)
    j, t = _loaded(jtum.TumSequence.open(tmp_path)), _loaded(ttum.TumSequence.open(tmp_path))
    _equal(t[0], j[0])
    _equal(t[1], j[1])
    assert [x[0] for x in t[2]] == [x[0] for x in j[2]]
    _equal([x[1:] for x in t[2]], [x[1:] for x in j[2]])
    _equal(t[3], j[3])
    und = tund.Undistorter(ttum.FR1_INTRINSICS, ttum.FR1_DIST, h, w)
    eq(t[1][1], und(rgb[1]) if size == (640, 480) else rgb[1])
    np.testing.assert_allclose(t[3], [-(R.T @ tt) for R, tt in poses], atol=2e-5)


@pytest.mark.parametrize("size", [(160, 120), (752, 480)])
def test_euroc_sequences_load_equal(tmp_path, jax_loader, size):
    """Gray frames; at 752x480 both undistort with the cam0 calibration."""
    w, h = size
    frames, poses, _ = _fr1_like(tsyn, TCam, 2, w, h, teuroc.EUROC_DIST, seed=202)
    tsyn.write_euroc_sequence(tmp_path, frames, poses)
    j = _loaded(jeuroc.EurocSequence.open(tmp_path))
    t = _loaded(teuroc.EurocSequence.open(tmp_path))
    _equal(t[0], j[0])
    _equal(t[1], j[1])
    assert [x[0] for x in t[2]] == [x[0] for x in j[2]]
    _equal([x[1:] for x in t[2]], [x[1:] for x in j[2]])
    _equal(t[3], j[3])
    und = tund.Undistorter(teuroc.EUROC_CAM0, teuroc.EUROC_DIST, h, w)
    eq(t[1][0], und(frames[0]) if size == (752, 480) else frames[0])
    assert abs(t[0][1] - t[0][0] - 0.05) < 1e-6     # nanoseconds * 1e-9, 20 fps


def test_custom_dist_and_no_undistort(tmp_path, jax_loader):
    frames, poses, _ = _fr1_like(tsyn, TCam, 2, 640, 480, None)
    tsyn.write_tum_sequence(tmp_path, frames, poses)
    for kw in (dict(undistort=False), dict(dist=dict(k1=0.1, p2=0.001))):
        j = [f for _, f in jtum.TumSequence.open(tmp_path).frames(**kw)]
        t = [f for _, f in ttum.TumSequence.open(tmp_path).frames(**kw)]
        _equal(t, j)


# ---- tests/test_undistort.py against the port (OpenCV the oracle) --------------

EUROC = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375)
EUROC_D = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
TUM = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3)
TUM_D = dict(k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633)


def _K(i):
    return np.array([[i["fx"], 0, i["cx"]], [0, i["fy"], i["cy"]], [0, 0, 1]])


def _D(d):
    return np.array([d.get("k1", 0), d.get("k2", 0), d.get("p1", 0), d.get("p2", 0),
                     d.get("k3", 0)])


@pytest.mark.parametrize("intr,dist,h,w", [(EUROC, EUROC_D, 480, 752), (TUM, TUM_D, 480, 640)])
def test_maps_match_opencv(intr, dist, h, w):
    cv2 = pytest.importorskip("cv2")
    mx, my = tund.undistort_maps(intr, dist, h, w)
    cx, cy = cv2.initUndistortRectifyMap(_K(intr), _D(dist), None, _K(intr), (w, h),
                                         cv2.CV_32FC1)
    np.testing.assert_allclose(mx, cx, atol=2e-2)
    np.testing.assert_allclose(my, cy, atol=2e-2)


def test_distort_matches_opencv_projectpoints():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.6, 0.6, 200)
    y = rng.uniform(-0.5, 0.5, 200)
    xd, yd = tund.radtan_distort(x, y, **EUROC_D)
    pts = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 1, 3)
    proj, _ = cv2.projectPoints(pts, np.zeros(3), np.zeros(3), np.eye(3), _D(EUROC_D))
    np.testing.assert_allclose(np.stack([xd, yd], -1), proj.reshape(-1, 2), atol=1e-9)


def test_remap_matches_opencv_bilinear():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    img = (rng.random((480, 752)) * 255).astype(np.uint8)
    und = tund.Undistorter(EUROC, EUROC_D, 480, 752)
    ours = und(img)
    theirs = cv2.remap(img, und.map_x, und.map_y, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REPLICATE)
    # Away from the stretched border band, equal but for rounding at .5.
    a = ours[40:-40, 60:-60].astype(np.int32)
    b = theirs[40:-40, 60:-60].astype(np.int32)
    assert np.mean(np.abs(a - b) <= 1) > 0.999


def test_undistort_straightens_lines():
    """Vertical lines, distorted by sampling at OpenCV's inverse map, come
    back straight."""
    cv2 = pytest.importorskip("cv2")
    h, w = 480, 752
    und = tund.Undistorter(EUROC, EUROC_D, h, w)
    ideal = np.zeros((h, w), np.float32)
    ideal[:, 100::75] = 1.0
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    pts = np.stack([u.ravel(), v.ravel()], -1).reshape(-1, 1, 2)
    inv = cv2.undistortPoints(pts, _K(EUROC), _D(EUROC_D), P=_K(EUROC)).reshape(h, w, 2)
    distorted = tund.remap_bilinear(ideal, inv[..., 0].astype(np.float32),
                                    inv[..., 1].astype(np.float32))
    err = np.abs(und(distorted)[60:-60, 60:-60] - ideal[60:-60, 60:-60])
    assert float(np.mean(err)) < 0.02


def test_identity_when_no_distortion():
    und = tund.Undistorter(EUROC, {}, 480, 752)
    img = np.arange(480 * 752, dtype=np.uint8).reshape(480, 752)
    assert und(img) is img


@pytest.mark.parametrize("kind", ["tum", "euroc"])
def test_smoke_sequences_equal_eval_ate_builders(tmp_path, monkeypatch, kind):
    """chip_smoke.py phase 10's sequences (tinyslam_tpu_torch.eval_ate's
    fr1_desk-like and mh01-like specs at its prefix lengths) through the
    renderer it shares with eval_ate, the clean ray casts on worker
    processes: the files equal those of tools/eval_ate.py's builder through
    the JAX package (cut in size), and a second call reuses them."""
    import chip_smoke
    from tinyslam_tpu_torch import eval_ate

    monkeypatch.setattr(eval_ate, "SEQ_DIR", tmp_path / "seq")
    base = chip_smoke.TUM_SEQ if kind == "tum" else chip_smoke.EUROC_SEQ
    assert base == (eval_ate.fr1_desk_spec(chip_smoke.TUM_SEQ["frames"]) if kind == "tum"
                    else eval_ate.mh01_spec(chip_smoke.EUROC_SEQ["frames"]))
    room = dict(base["room"], tex_res=16, octaves=2)
    spec = dict(base, frames=3, room=room)
    root, secs = eval_ate.dataset_sequence(spec, workers=2)
    assert root.parent == tmp_path / "seq"
    assert secs > 0 and eval_ate.dataset_sequence(spec, workers=2) == (root, 0.0)

    rng = np.random.default_rng(spec["seed"])
    jroom = jsyn.TexturedRoom(rng, **room)
    if kind == "tum":
        cam, dist = JCam.create(**jtum.FR1_INTRINSICS), jtum.FR1_DIST
        poses = jsyn.handheld_trajectory(rng, 3)
    else:
        cam, dist = JCam.create(**jeuroc.EUROC_CAM0), jeuroc.EUROC_DIST
        poses = jsyn.mav_trajectory(rng, 3)
    frames = jsyn.render_sequence(rng, poses, cam, spec["width"], spec["height"], jroom,
                                  dist=dist)
    (jsyn.write_tum_sequence if kind == "tum" else jsyn.write_euroc_sequence)(
        tmp_path / "jax", frames, poses)
    jfiles = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                    if p.is_file())
    assert sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file()) == sorted(
        jfiles + [type(jfiles[0])("frame0.npy")])
    for f in jfiles:
        assert (root / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    eq(np.load(root / "frame0.npy"), frames[0])
