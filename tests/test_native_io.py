"""Native libslamio tests: PNG decode correctness vs PIL across formats,
threaded batch loads, trajectory parsing."""

import os

import numpy as np
import pytest
from PIL import Image

from monocular_slam_tpu import native


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def write_pngs(tmp, rng):
    paths = {}
    g8 = (rng.rand(37, 53) * 255).astype(np.uint8)
    Image.fromarray(g8, "L").save(tmp / "gray8.png")
    paths["gray8"] = (str(tmp / "gray8.png"), g8.astype(np.float32))

    rgb = (rng.rand(40, 30, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb, "RGB").save(tmp / "rgb8.png")
    lum = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    paths["rgb8"] = (str(tmp / "rgb8.png"), lum.astype(np.float32))

    rgba = (rng.rand(25, 31, 4) * 255).astype(np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp / "rgba8.png")
    luma = 0.299 * rgba[..., 0] + 0.587 * rgba[..., 1] + 0.114 * rgba[..., 2]
    paths["rgba8"] = (str(tmp / "rgba8.png"), luma.astype(np.float32))

    d16 = (rng.rand(48, 64) * 30000).astype(np.uint16)
    Image.fromarray(d16, "I;16").save(tmp / "depth16.png")
    paths["depth16"] = (str(tmp / "depth16.png"), d16.astype(np.float32) / 5000.0)
    return paths


class TestDecode:
    def test_formats_match_reference(self, tmp_path):
        rng = np.random.RandomState(0)
        cases = write_pngs(tmp_path, rng)
        for name, (path, ref) in cases.items():
            scale = 1.0 / 5000.0 if name == "depth16" else 1.0
            img = native.load_png_f32(path, scale16=scale)
            assert img.shape == ref.shape, name
            np.testing.assert_allclose(img, ref, atol=0.51, err_msg=name)

    def test_exact_gray8(self, tmp_path):
        rng = np.random.RandomState(1)
        g = (rng.rand(100, 200) * 255).astype(np.uint8)
        Image.fromarray(g, "L").save(tmp_path / "g.png")
        img = native.load_png_f32(str(tmp_path / "g.png"))
        np.testing.assert_array_equal(img, g.astype(np.float32))

    def test_exact_depth16(self, tmp_path):
        rng = np.random.RandomState(2)
        d = (rng.rand(60, 80) * 65535).astype(np.uint16)
        Image.fromarray(d, "I;16").save(tmp_path / "d.png")
        img = native.load_png_f32(str(tmp_path / "d.png"), scale16=1.0)
        np.testing.assert_array_equal(img, d.astype(np.float32))

    def test_batch_threaded(self, tmp_path):
        rng = np.random.RandomState(3)
        refs, paths = [], []
        for i in range(8):
            g = (rng.rand(32, 48) * 255).astype(np.uint8)
            p = str(tmp_path / f"b{i}.png")
            Image.fromarray(g, "L").save(p)
            refs.append(g.astype(np.float32))
            paths.append(p)
        imgs = native.load_batch_f32(paths, n_threads=2)
        assert len(imgs) == 8
        for img, ref in zip(imgs, refs):
            np.testing.assert_array_equal(img, ref)

    def test_missing_file_falls_back_gracefully(self, tmp_path):
        with pytest.raises(Exception):
            native.load_png_f32(str(tmp_path / "nope.png"))


class TestTrajectoryParse:
    def test_parse(self, tmp_path):
        p = tmp_path / "gt.txt"
        rows = np.random.RandomState(4).randn(50, 8)
        with open(p, "w") as f:
            f.write("# header\n\n")
            for r in rows:
                f.write(" ".join(f"{v:.9f}" for v in r) + "\n")
        out = native.parse_trajectory(str(p))
        np.testing.assert_allclose(out, rows, atol=1e-9)


def test_render_png_writer_roundtrip(tmp_path):
    """The renderer's stdlib PNG writer (no PIL) round-trips through the
    native decoder bit for bit."""
    from monocular_slam_tpu.datasets.render import write_png_gray8

    img = (np.random.RandomState(0).rand(37, 53) * 255).astype(np.uint8)
    path = str(tmp_path / "gray8_stdlib.png")
    write_png_gray8(path, img)
    np.testing.assert_array_equal(native.load_png_f32(path), img.astype(np.float32))
    np.testing.assert_array_equal(native.load_batch_f32([path])[0], img.astype(np.float32))
