"""The frontend's XLA formulations against the plain numpy references
(`ops/reference.py`), and the device-independent parts of the GPU tooling:
the peaks table, the compilation cache location and `chip_smoke.py`."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monocular_slam_tpu.datasets import render
from monocular_slam_tpu.ops import fast, matching, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # chip_smoke.py lives at the repo root
import chip_smoke  # noqa: E402


def rand_pm1(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (n, 256)) * 2 - 1).astype(np.int8)


def _case_300x700():
    a, b = rand_pm1(0, 300), rand_pm1(1, 700)
    bv = np.ones(700, bool)
    bv[5] = False
    return a, b, np.ones(300, bool), bv, False


def _case_97x123():
    return rand_pm1(4, 97), rand_pm1(5, 123), np.ones(97, bool), np.ones(123, bool), False


def _case_all_b_invalid():
    return rand_pm1(6, 32), rand_pm1(7, 64), np.ones(32, bool), np.zeros(64, bool), False


def _case_cross_check():
    # b holds a's first 150 rows among distractors, so matches are real
    a = rand_pm1(2, 200)
    b = np.concatenate([a[:150], rand_pm1(3, 100)])
    return a, b, np.ones(200, bool), np.ones(250, bool), True


@pytest.mark.parametrize(
    "make", [_case_300x700, _case_97x123, _case_all_b_invalid, _case_cross_check],
    ids=["300x700_invalid_col", "97x123", "all_b_invalid", "cross_check"],
)
def test_match_equals_numpy_top2(make):
    a, b, av, bv, cross = make()
    m = matching.match(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(av), jnp.asarray(bv),
        ratio=0.8, max_dist=256, cross_check=cross,
    )
    idx, d1, ok = reference.match_top2(a, b, av, bv, 0.8, 256, cross_check=cross)
    np.testing.assert_array_equal(np.asarray(m.idx), idx)
    np.testing.assert_array_equal(np.asarray(m.dist), d1)
    np.testing.assert_array_equal(np.asarray(m.ok), ok)
    if not bv.any():
        assert (d1 >= reference.BIG).all() and not ok.any()
    if cross:
        assert ok.sum() >= 140  # the planted copies match


def _corner_image(seed, h, w):
    # smooth background + sharp corners so FAST has real responses
    img = 40.0 * np.random.default_rng(seed).random((h, w), dtype=np.float32)
    img[20:40, 30:50] += 120.0
    img[60:63, 100:140] += 90.0
    img[75, 20] += 150.0
    return img


@pytest.mark.parametrize(
    "h,w,thr,mode",
    [(96, 160, 20.0, "score_nms"), (96, 160, 20.0, "detect"), (101, 173, 15.0, "score_nms")],
)
def test_fast_equals_numpy_loop(h, w, thr, mode):
    img = _corner_image(h + w, h, w)
    ref = reference.fast_score_nms(img, thr)
    assert ref.max() > thr  # the scene actually has corners
    if mode == "score_nms":
        out = np.asarray(fast.nms3(fast.corner_score(jnp.asarray(img), thr)))
        np.testing.assert_allclose(out, ref, atol=1e-5)
        return
    k = 64
    c = fast.detect(jnp.asarray(img), k, thr)
    v = np.asarray(c.valid)
    order = np.sort(ref.reshape(-1))[::-1]
    np.testing.assert_allclose(np.asarray(c.score)[v], order[: v.sum()], atol=1e-5)
    assert v.sum() == min(k, int((ref > 0).sum()))
    yx = np.asarray(c.yx)[v].astype(int)
    np.testing.assert_allclose(ref[yx[:, 0], yx[:, 1]], np.asarray(c.score)[v], atol=1e-5)


def test_peaks_found_by_device_kind():
    from monocular_slam_tpu.utils import roofline

    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    p = roofline.device_peaks(dev)
    assert p.peak_flops == 989.0e12 and p.peak_bw == 3.35e12
    assert p.peak_int8 == 1979.0e12 and p.peak_tf32 == 495.0e12 and p.peak_f32 == 67.0e12
    assert "data sheet" in p.source


def test_peaks_unknown_device_raises():
    from monocular_slam_tpu.utils import roofline

    with pytest.raises(ValueError, match="no published peaks"):
        roofline.device_peaks(SimpleNamespace(platform="cpu", device_kind="cpu"))


_CACHE_PROBE = (
    "import jax, jax.numpy as jnp\n"
    "from monocular_slam_tpu.utils.cache import enable_compilation_cache\n"
    "print(enable_compilation_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()\n"
)


def _probe_cache(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_cache_honours_env_dir(tmp_path):
    cache = tmp_path / "xla_cache"
    returned, configured = _probe_cache(cache)
    assert returned == configured == str(cache)
    assert any(cache.iterdir())  # the program landed there


def test_cache_defaults_to_checkout():
    returned, configured = _probe_cache(None)
    want = os.path.join(ROOT, ".jax_cache")
    assert returned == configured == want
    assert any(os.scandir(want))


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_stage_checks_on_cpu():
    cpu = jax.devices("cpu")[0]
    imgs, _, _ = render.render_sequence(jax.random.PRNGKey(11), n_frames=1, wh=(160, 120))
    r = chip_smoke.compare_extract(list(imgs), 200, cpu, cpu)
    assert r == {"recall_1px": 1.0, "desc_equal": 1.0}
    m = chip_smoke.compare_match(97, 123, cpu)
    assert m["n_ok"] > 0
    b = chip_smoke.compare_ba(cpu)
    assert b["pose_l2"] <= chip_smoke.BA_POSE_L2
    json.dumps(b)


@pytest.mark.gpu
def test_chip_smoke_stages_on_gpu(gpu_device):
    imgs, _, _ = render.render_sequence(jax.random.PRNGKey(11), n_frames=1, wh=(640, 480))
    r = chip_smoke.compare_extract(list(imgs), 1000, gpu_device, jax.devices("cpu")[0])
    assert r["recall_1px"] >= chip_smoke.MIN_RECALL
    assert r["desc_equal"] >= chip_smoke.MIN_DESC_EQUAL
    chip_smoke.compare_match(2000, 20000, gpu_device)
    chip_smoke.compare_ba(gpu_device)
