"""Synthetic textured-scene renderer + TUM-format dataset exporter.

No TUM data can be downloaded in this environment, so the flagship
image-pipeline benchmark (`BASELINE.json.metric`: fps + ATE on a TUM-format
sequence through the real loader/extractor/tracker) runs on a rendered
sequence written to disk in the exact TUM RGB-D layout the reference's
`FrameLoader` consumes (`src/FrameLoader.cpp:36-168`): `rgb/<ts>.png`,
`rgb.txt`, `groundtruth.txt` (timestamp tx ty tz qx qy qz qw, camera-to-world).

The scene is the inside of a textured box room; the camera orbits inside it
looking across the room, giving 2-8 m depth variation (real parallax — a
single plane would be homography-degenerate for E/F estimation).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from monocular_slam_tpu.datasets.synthetic import arc_trajectory
from monocular_slam_tpu.geometry import se3

# Pinhole, distortion-free (the renders have no lens): fr1-like focal but
# exported under a 'synth' id so `intrinsics.lookup` applies zero distortion.
SYNTH_K = np.array([517.3, 516.5, 318.6, 255.3])

# Bump when the renderer's output changes so cached on-disk datasets
# (bench.py keeps one under the checkout's .data/) are regenerated instead of
# reused stale.
RENDER_VERSION = 2


class Plane(NamedTuple):
    origin: jnp.ndarray  # (3,) corner point
    u: jnp.ndarray  # (3,) edge direction (unit)
    v: jnp.ndarray  # (3,) edge direction (unit)
    extent: jnp.ndarray  # (2,) lengths along u, v
    tex_id: jnp.ndarray  # () int32


def _texture(key, size: int = 2048) -> jnp.ndarray:
    """High-contrast multi-scale noise texture (ORB-friendly corners)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    # cubic-only (band-limited) noise: nearest-neighbour blocks alias under
    # viewpoint change and destabilize ORB descriptors frame-to-frame
    coarse = jax.image.resize(jax.random.uniform(k1, (32, 32)), (size, size), "cubic")
    mid = jax.image.resize(jax.random.uniform(k2, (96, 96)), (size, size), "cubic")
    fine = jax.image.resize(jax.random.uniform(k3, (256, 256)), (size, size), "cubic")
    xfine = jax.image.resize(jax.random.uniform(k4, (512, 512)), (size, size), "cubic")
    img = 0.35 * coarse + 0.30 * mid + 0.20 * fine + 0.15 * xfine
    lo, hi = jnp.min(img), jnp.max(img)
    img = (img - lo) / (hi - lo)
    # soft-threshold into high-contrast blobs: crisp, repeatable FAST corners
    # with anti-aliased (band-limited) edges — pure smooth noise gives weak,
    # ambiguous ORB descriptors, hard binary edges alias between views
    img = jax.nn.sigmoid((img - jnp.median(img)) * 16.0)
    return img * 255.0


def box_room(half: float = 3.0, height: float = 1.8, pillar: float = 0.45):
    """Textured room around the origin with a square textured pillar at the
    centre. The pillar puts surfaces 0.5-2 m from the orbiting camera so
    two-view parallax is well above the triangulation gate
    (`InitConfig.max_cos_parallax`); the walls add 1.3-4 m background depth."""
    h, y0, y1 = half, -height, height
    p = pillar
    f = jnp.asarray
    planes = [
        # room walls: back (z=+h), front (z=-h), left (x=-h), right (x=+h)
        Plane(f([-h, y0, h]), f([1.0, 0, 0]), f([0, 1.0, 0]), f([2 * h, y1 - y0]), f(0)),
        Plane(f([-h, y0, -h]), f([1.0, 0, 0]), f([0, 1.0, 0]), f([2 * h, y1 - y0]), f(1)),
        Plane(f([-h, y0, -h]), f([0, 0, 1.0]), f([0, 1.0, 0]), f([2 * h, y1 - y0]), f(2)),
        Plane(f([h, y0, -h]), f([0, 0, 1.0]), f([0, 1.0, 0]), f([2 * h, y1 - y0]), f(3)),
        # floor (y=y1), ceiling (y=y0)
        Plane(f([-h, y1, -h]), f([1.0, 0, 0]), f([0, 0, 1.0]), f([2 * h, 2 * h]), f(4)),
        Plane(f([-h, y0, -h]), f([1.0, 0, 0]), f([0, 0, 1.0]), f([2 * h, 2 * h]), f(5)),
        # central pillar faces (z=+p, z=-p, x=-p, x=+p), full room height
        Plane(f([-p, y0, p]), f([1.0, 0, 0]), f([0, 1.0, 0]), f([2 * p, y1 - y0]), f(6)),
        Plane(f([-p, y0, -p]), f([1.0, 0, 0]), f([0, 1.0, 0]), f([2 * p, y1 - y0]), f(7)),
        Plane(f([-p, y0, -p]), f([0, 0, 1.0]), f([0, 1.0, 0]), f([2 * p, y1 - y0]), f(8)),
        Plane(f([p, y0, -p]), f([0, 0, 1.0]), f([0, 1.0, 0]), f([2 * p, y1 - y0]), f(9)),
    ]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *planes)


def render_frame(pose, k, wh, planes: Plane, textures: jnp.ndarray) -> jnp.ndarray:
    """Ray-cast one grayscale (H, W) f32 frame [0,255]. pose: world->camera
    (3,4); textures: (n_tex, S, S)."""
    W, H = wh
    S = textures.shape[-1]
    R = pose[:3, :3]
    C = se3.camera_center(pose)

    ys, xs = jnp.mgrid[0:H, 0:W]
    dirs_cam = jnp.stack(
        [
            (xs + 0.5 - k[2]) / k[0],
            (ys + 0.5 - k[3]) / k[1],
            jnp.ones((H, W)),
        ],
        axis=-1,
    )
    dirs = dirs_cam @ R  # R^T applied rowwise: world-frame ray directions

    n = jnp.cross(planes.u, planes.v)  # (P, 3) plane normals

    def hit_plane(origin, u, v, extent, n_p):
        denom = dirs @ n_p  # (H, W)
        t = ((origin - C) @ n_p) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        pt = C + t[..., None] * dirs
        lu = (pt - origin) @ u
        lv = (pt - origin) @ v
        ok = (t > 1e-3) & (lu >= 0) & (lu <= extent[0]) & (lv >= 0) & (lv <= extent[1])
        return jnp.where(ok, t, jnp.inf), lu, lv

    ts, lus, lvs = jax.vmap(hit_plane)(planes.origin, planes.u, planes.v, planes.extent, n)
    best = jnp.argmin(ts, axis=0)  # (H, W) nearest plane id
    lu = jnp.take_along_axis(lus, best[None], axis=0)[0]  # meters along u
    lv = jnp.take_along_axis(lvs, best[None], axis=0)[0]
    tex_idx = planes.tex_id.astype(jnp.int32)[best]
    # Isotropic texel density: texture coords scale with PHYSICAL size, so a
    # square texture is never stretched over a non-square face (a stretched
    # texture smears its detail along one axis and starves ORB of corners —
    # the original normalized mapping blurred the 0.9 x 3.6 m pillar 4:1).
    # The largest face spans the full texture; smaller faces use a sub-rect.
    density = (S - 1.0) / jnp.max(planes.extent)
    # bilinear texture sampling (nearest aliases under viewpoint change)
    uf = jnp.clip(lu * density, 0.0, S - 1.0)
    vf = jnp.clip(lv * density, 0.0, S - 1.0)
    u0 = jnp.clip(uf.astype(jnp.int32), 0, S - 2)
    v0 = jnp.clip(vf.astype(jnp.int32), 0, S - 2)
    au, av = uf - u0, vf - v0
    t00 = textures[tex_idx, v0, u0]
    t01 = textures[tex_idx, v0, u0 + 1]
    t10 = textures[tex_idx, v0 + 1, u0]
    t11 = textures[tex_idx, v0 + 1, u0 + 1]
    img = (
        t00 * (1 - au) * (1 - av)
        + t01 * au * (1 - av)
        + t10 * (1 - au) * av
        + t11 * au * av
    )
    return jnp.where(jnp.isfinite(jnp.min(ts, axis=0)), img, 0.0)


def render_sequence(
    key,
    n_frames: int = 60,
    wh=(640, 480),
    k=None,
    radius: float = 1.8,
    ang_step: float = 0.06,
):
    """Rendered orbit inside the box room. Returns (images (F,H,W) f32 np,
    poses_gt (F,3,4) np world->camera, k (4,))."""
    if k is None:
        # scale the canonical 640x480 pinhole to the requested resolution
        W, H = wh
        k = SYNTH_K * np.array([W / 640.0, H / 480.0, W / 640.0, H / 480.0])
    else:
        k = np.asarray(k)
    planes = box_room()
    keys = jax.random.split(key, planes.origin.shape[0])
    textures = jnp.stack([_texture(kk) for kk in keys])
    poses = arc_trajectory(n_frames, radius=radius, ang_step=ang_step)
    render = jax.jit(
        lambda p: render_frame(p, jnp.asarray(k, jnp.float32), wh, planes, textures)
    )
    imgs = np.stack([np.asarray(render(poses[i])) for i in range(n_frames)])
    return imgs, np.asarray(poses), k


def _rt_to_tum_line(ts: float, pose: np.ndarray) -> str:
    """world->camera (3,4) -> TUM groundtruth line (camera-to-world)."""
    from scipy.spatial.transform import Rotation

    R = pose[:3, :3]
    C = -R.T @ pose[:3, 3]
    q = Rotation.from_matrix(R.T).as_quat()  # (qx, qy, qz, qw)
    vals = [C[0], C[1], C[2], q[0], q[1], q[2], q[3]]
    return f"{ts:.6f} " + " ".join(f"{v:.6f}" for v in vals)


def write_png_gray8(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG: signature,
    IHDR, one zlib-compressed IDAT of unfiltered scanlines, IEND."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    # each scanline is prefixed with filter type 0 (None)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit, gray
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def export_tum(
    root: str,
    key=None,
    n_frames: int = 60,
    wh=(640, 480),
    fps: float = 30.0,
    **render_kwargs,
) -> str:
    """Render a sequence and write it as a TUM RGB-D dataset directory
    (rgb/*.png + rgb.txt + groundtruth.txt). Returns `root`. Layout matches
    what `datasets/tum.load` (and the reference's `FrameLoader`) expects."""
    key = jax.random.PRNGKey(0) if key is None else key
    imgs, poses, k = render_sequence(key, n_frames=n_frames, wh=wh, **render_kwargs)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(n_frames):
        ts = i / fps
        name = f"rgb/{ts:.6f}.png"
        write_png_gray8(
            os.path.join(root, name), np.clip(imgs[i], 0, 255).astype(np.uint8)
        )
        rgb_lines.append(f"{ts:.6f} {name}")
        gt_lines.append(_rt_to_tum_line(ts, poses[i]))
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "VERSION"), "w") as f:
        f.write(f"{RENDER_VERSION}\n")
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(" ".join(f"{v:.6f}" for v in k) + f" {wh[0]} {wh[1]}\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    return root
