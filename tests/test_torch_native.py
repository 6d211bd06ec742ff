"""The port's native decoder and prefetching loader (``tinyslam_tpu_torch/
native/``): the round trips of tests/test_native.py against the port
(PNG 8/16-bit gray and RGB, PGM, a missing file, the loader's order, the
TUM and EuRoC sequences), then what the port adds or keeps exactly: every
PNG row filter, PPM and 16-bit PGM, decode failures in the stream, early
close, the build under ``build/tinyslam_tpu_torch/`` with concurrent
builders, a failed build, and the same pixels as the JAX package's
decoder."""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from tests import torch_parity as P
from tinyslam_tpu_torch import native
from tinyslam_tpu_torch.data.png import write_png
from tinyslam_tpu_torch.native import FrameLoader, decode_image

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    return native.get_lib()


@pytest.fixture(scope="module")
def jax_loader(tmp_path_factory):
    """The JAX package's native module, reading through a private build of
    its own sources."""
    import tinyslam_tpu.native as jn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_SO", P.jax_native_library(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jn, "_lib", None)
        yield jn


# ---- the round trips of tests/test_native.py ------------------------------

def test_png_gray8_roundtrip(tmp_path, lib):
    img = np.random.default_rng(0).integers(0, 256, (48, 64), dtype=np.uint8)
    write_png(tmp_path / "g8.png", img)
    np.testing.assert_array_equal(decode_image(tmp_path / "g8.png"), img)


def test_png_rgb8_roundtrip(tmp_path, lib):
    img = np.random.default_rng(1).integers(0, 256, (33, 57, 3), dtype=np.uint8)
    write_png(tmp_path / "rgb.png", img)
    np.testing.assert_array_equal(decode_image(tmp_path / "rgb.png"), img)


def test_png_gray16_roundtrip(tmp_path, lib):
    img = np.random.default_rng(2).integers(0, 65536, (24, 31), dtype=np.uint16)
    write_png(tmp_path / "g16.png", img)
    out = decode_image(tmp_path / "g16.png")
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, img)


def test_pgm_roundtrip(tmp_path, lib):
    img = np.random.default_rng(3).integers(0, 256, (20, 30), dtype=np.uint8)
    (tmp_path / "img.pgm").write_bytes(b"P5\n# comment\n30 20\n255\n" + img.tobytes())
    np.testing.assert_array_equal(decode_image(tmp_path / "img.pgm"), img)


def test_decode_missing_file(tmp_path, lib):
    with pytest.raises(IOError):
        decode_image(tmp_path / "nope.png")


def test_frame_loader_order_and_content(tmp_path, lib):
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (16, 24), dtype=np.uint8) for _ in range(20)]
    paths = []
    for i, im in enumerate(imgs):
        paths.append(tmp_path / f"f{i:03d}.png")
        write_png(paths[-1], im)
    got = list(FrameLoader(paths, capacity=4, threads=3))
    assert len(got) == 20
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)


def test_tum_sequence(tmp_path, lib):
    from tinyslam_tpu_torch.data.tum import TumSequence

    rng = np.random.default_rng(5)
    (tmp_path / "rgb").mkdir()
    rgb_lines = ["# comment"]
    imgs = []
    for i in range(5):
        im = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        write_png(tmp_path / "rgb" / f"{i}.png", im)
        rgb_lines.append(f"{100.0 + i * 0.033:.4f} rgb/{i}.png")
        imgs.append(im)
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines))
    (tmp_path / "groundtruth.txt").write_text(
        "\n".join(f"{100.0 + i * 0.033:.4f} {0.1 * i} 0 0 0 0 0 1" for i in range(5)))
    seq = TumSequence.open(tmp_path)
    assert len(seq.rgb) == 5 and len(seq.groundtruth) == 5
    frames = list(seq.frames(capacity=2, threads=2))
    assert len(frames) == 5
    np.testing.assert_array_equal(frames[3][1], imgs[3])
    # Identity quaternion: the camera at (0.1 i, 0, 0).
    np.testing.assert_allclose(seq.gt_positions()[:, 0], 0.1 * np.arange(5), atol=1e-6)


def test_euroc_sequence(tmp_path, lib):
    from tinyslam_tpu_torch.data.euroc import EurocSequence

    rng = np.random.default_rng(6)
    cam = tmp_path / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i in range(4):
        write_png(cam / "data" / f"{i}.png", rng.integers(0, 256, (10, 14), dtype=np.uint8))
        rows.append(f"{int(1e9 * (5 + i * 0.05))},{i}.png")
    (cam / "data.csv").write_text("\n".join(rows))
    seq = EurocSequence.open(tmp_path)
    assert len(seq.cam0) == 4
    frames = list(seq.frames())
    assert len(frames) == 4 and frames[0][1].shape == (10, 14)


# ---- what the port adds or keeps exactly -----------------------------------

def _filtered_png(path, img: np.ndarray, filters) -> None:
    """An 8-bit PNG whose row y is stored under filter filters[y % len]
    (0 none, 1 sub, 2 up, 3 average, 4 Paeth), as an encoder would."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * channels).astype(np.int64)
    bpp = channels
    scan = b""
    prev = np.zeros(w * channels, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        scan += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[channels]
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(scan, 9)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_row_filters(tmp_path, lib, jax_loader, channels, filters):
    rng = np.random.default_rng(channels * 10 + len(filters))
    shape = (9, 13) if channels == 1 else (9, 13, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:3] = img[:3] // 32 * 32          # flat runs: Paeth's ties
    path = tmp_path / "f.png"
    _filtered_png(path, img, filters)
    out = decode_image(path)
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, jax_loader.decode_image(path))


def test_ppm_and_pgm16(tmp_path, lib):
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    (tmp_path / "a.ppm").write_bytes(b"P6 5 6 255\n" + rgb.tobytes())
    np.testing.assert_array_equal(decode_image(tmp_path / "a.ppm"), rgb)
    g16 = rng.integers(0, 65536, (4, 7), dtype=np.uint16)
    (tmp_path / "b.pgm").write_bytes(b"P5\n7 4\n65535\n" + g16.astype(">u2").tobytes())
    out = decode_image(tmp_path / "b.pgm")
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, g16)


def test_truncated_and_foreign_files_raise(tmp_path, lib):
    img = np.random.default_rng(8).integers(0, 256, (8, 8), dtype=np.uint8)
    write_png(tmp_path / "ok.png", img)
    data = (tmp_path / "ok.png").read_bytes()
    (tmp_path / "cut.png").write_bytes(data[: len(data) // 2])
    (tmp_path / "text.png").write_text("not an image")
    for name in ("cut.png", "text.png"):
        with pytest.raises(IOError):
            decode_image(tmp_path / name)


def test_loader_raises_on_a_bad_frame_and_goes_on(tmp_path, lib):
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (8, 12), dtype=np.uint8) for _ in range(4)]
    paths = []
    for i, im in enumerate(imgs):
        paths.append(tmp_path / f"{i}.png")
        write_png(paths[-1], im)
    paths.insert(2, tmp_path / "missing.png")
    loader = FrameLoader(paths, capacity=2, threads=2)
    got = [next(loader), next(loader)]
    with pytest.raises(IOError, match="missing.png"):
        next(loader)
    got += list(loader)
    assert len(got) == 4
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(StopIteration):
        next(loader)


def test_loader_close_early_and_empty(tmp_path, lib):
    rng = np.random.default_rng(10)
    paths = []
    for i in range(12):
        paths.append(tmp_path / f"{i}.png")
        write_png(paths[-1], rng.integers(0, 256, (8, 8), dtype=np.uint8))
    loader = FrameLoader(paths, capacity=3, threads=4)
    next(loader)
    loader.close()                   # workers blocked on a full ring stop
    loader.close()
    with pytest.raises(StopIteration):
        next(loader)
    assert list(FrameLoader([], capacity=2, threads=2)) == []


def test_library_builds_under_build_dir(lib):
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build" / "tinyslam_tpu_torch"
    assert not list(Path(native.SRC).glob("*.so"))


_BUILD = r"""
import sys
from pathlib import Path
from tinyslam_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.build())
"""


def test_concurrent_builds_rename_into_place(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert [f.name for f in tmp_path.iterdir()] == [Path(outs[0][0].strip()).name]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("--no-such-flag",))
    native.build.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.build()
    finally:
        native.build.cache_clear()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("shape", [(31, 47), (20, 33, 3)])
def test_same_pixels_as_the_jax_decoder(tmp_path, lib, jax_loader, shape):
    rng = np.random.default_rng(sum(shape))
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(6)]
    paths = []
    for i, im in enumerate(imgs):
        paths.append(tmp_path / f"{i}.png")
        write_png(paths[-1], im)
    ours = list(FrameLoader(paths, capacity=2, threads=3))
    theirs = list(jax_loader.FrameLoader(paths, capacity=2, threads=3))
    assert len(ours) == len(theirs) == 6
    for a, b, im in zip(ours, theirs, imgs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, im)
