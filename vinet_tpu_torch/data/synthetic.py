"""Synthetic structured-video fixtures (moving-blob saliency),
``vinet_tpu/data/synthetic.py`` bit for bit.

One generator for every accuracy number of the port (``inference/accuracy.py``
and ``chip_smoke.py``'s accuracy phase), the same as the JAX package's, so
the held-out fixtures are the same videos in both packages: seeded, at the
full 224 x 384 DHF1K input geometry.
"""

from __future__ import annotations

import os

import numpy as np

H, W = 224, 384


def make_eval_video(n_frames=256, seed=100):
    """Structured held-out video: two moving blobs (one bright/salient like
    the training distribution, one dim distractor) over a drifting sinusoidal
    background plus noise — content-ful on every frame. Returns (frames, gt):
    gt is the bright blob's gaussian (the training-label semantics), so both
    inference modes can be scored against ground truth."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    frames = np.empty((n_frames, H, W, 3), np.uint8)
    gts = np.empty((n_frames, H, W), np.float32)
    cy, cx = H // 2, W // 5
    dy2, dx2 = 2.0, -1.5
    cy2, cx2 = H // 3, 4 * W // 5
    for f in range(n_frames):
        cy = float(np.clip(cy + rng.integers(-3, 4), 16, H - 16))
        cx = float(np.clip(cx + 1.5 + rng.integers(-1, 2), 16, W - 16))
        if f % 64 == 0:
            dy2, dx2 = -dy2, -dx2
        cy2 = float(np.clip(cy2 + dy2, 16, H - 16))
        cx2 = float(np.clip(cx2 + dx2, 16, W - 16))
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 9.0**2))
        g2 = np.exp(-((yy - cy2) ** 2 + (xx - cx2) ** 2) / (2 * 14.0**2))
        bg = 40 + 25 * np.sin(2 * np.pi * (xx / 64.0 + f / 40.0)) \
            + 15 * np.sin(2 * np.pi * (yy / 48.0 - f / 55.0))
        img = bg[..., None] + rng.integers(0, 30, (H, W, 3))
        img = img + 175.0 * g[..., None] + 60.0 * g2[..., None]
        frames[f] = np.clip(img, 0, 255).astype(np.uint8)
        gts[f] = g.astype(np.float32)
    return frames, gts


# Fixture suite: distinct dynamics, so the streaming-FT accuracy claim
# generalizes beyond the single moving-blob fixture. Each
# kind returns (frames, gt) with the same geometry/label semantics as
# make_eval_video; "blob" IS make_eval_video (bit-identical back-compat).
FIXTURE_KINDS = ("blob", "multiblob", "occlusion", "scale", "static_then_moving")


def _background(f, rng):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    bg = 40 + 25 * np.sin(2 * np.pi * (xx / 64.0 + f / 40.0)) \
        + 15 * np.sin(2 * np.pi * (yy / 48.0 - f / 55.0))
    return bg[..., None] + rng.integers(0, 30, (H, W, 3))


def make_fixture_video(kind, n_frames=96, seed=100):
    """Held-out eval fixture of the given dynamics kind. GT = the salient
    content's gaussian (training-label semantics), same scoring path as
    make_eval_video for every kind."""
    if kind == "blob":
        return make_eval_video(n_frames=n_frames, seed=seed)
    # stable per-kind seed offset (builtin hash() is salted per process)
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    frames = np.empty((n_frames, H, W, 3), np.uint8)
    gts = np.empty((n_frames, H, W), np.float32)

    if kind == "multiblob":
        # two equally-bright salient blobs on crossing paths; GT = max of
        # both gaussians (multi-fixation frame)
        c1 = [H * 0.3, W * 0.15]
        c2 = [H * 0.7, W * 0.85]
        v1 = [1.2, 2.6]
        v2 = [-1.2, -2.6]
        for f in range(n_frames):
            for c, v in ((c1, v1), (c2, v2)):
                c[0] = float(np.clip(c[0] + v[0] + rng.uniform(-1, 1), 16, H - 16))
                c[1] = float(np.clip(c[1] + v[1] + rng.uniform(-1, 1), 16, W - 16))
            g1 = np.exp(-((yy - c1[0]) ** 2 + (xx - c1[1]) ** 2) / (2 * 9.0**2))
            g2 = np.exp(-((yy - c2[0]) ** 2 + (xx - c2[1]) ** 2) / (2 * 9.0**2))
            img = _background(f, rng) + 175.0 * (g1 + g2)[..., None]
            frames[f] = np.clip(img, 0, 255).astype(np.uint8)
            gts[f] = np.maximum(g1, g2).astype(np.float32)
    elif kind == "occlusion":
        # bright blob crosses behind a fixed dark vertical bar; GT keeps
        # tracking the blob (frames where it is hidden stress the temporal
        # window differences between parity and streaming)
        cy, cx = H * 0.5, W * 0.08
        bar_lo, bar_hi = int(W * 0.45), int(W * 0.55)
        for f in range(n_frames):
            cy = float(np.clip(cy + rng.uniform(-2, 2), 16, H - 16))
            cx = float(np.clip(cx + 3.2, 16, W - 16))
            g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 9.0**2))
            img = _background(f, rng) + 175.0 * g[..., None]
            img[:, bar_lo:bar_hi] = 12  # occluder drawn OVER the blob
            frames[f] = np.clip(img, 0, 255).astype(np.uint8)
            gts[f] = g.astype(np.float32)
    elif kind == "scale":
        # blob size oscillates 6 -> 20 px sigma while drifting
        cy, cx = H * 0.5, W * 0.3
        for f in range(n_frames):
            cy = float(np.clip(cy + rng.uniform(-2, 2), 20, H - 20))
            cx = float(np.clip(cx + 1.0 + rng.uniform(-1, 1), 20, W - 20))
            sigma = 13.0 + 7.0 * np.sin(2 * np.pi * f / 48.0)
            g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))
            img = _background(f, rng) + 175.0 * g[..., None]
            frames[f] = np.clip(img, 0, 255).astype(np.uint8)
            gts[f] = g.astype(np.float32)
    elif kind == "static_then_moving":
        # static for the first half (streaming's chunked windows see pure
        # repetition), then abrupt fast motion
        cy, cx = H * 0.45, W * 0.4
        for f in range(n_frames):
            if f >= n_frames // 2:
                cy = float(np.clip(cy + rng.uniform(-1, 1) + 2.5, 16, H - 16))
                cx = float(np.clip(cx + 4.0 + rng.uniform(-1, 1), 16, W - 16))
            g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 9.0**2))
            img = _background(f, rng) + 175.0 * g[..., None]
            frames[f] = np.clip(img, 0, 255).astype(np.uint8)
            gts[f] = g.astype(np.float32)
    else:
        raise ValueError(f"unknown fixture kind {kind!r}; one of {FIXTURE_KINDS}")
    return frames, gts


def write_blob_video(vdir, n_frames, rng):
    """One DHF1K-layout video (images/ + maps/ + fixation/) with RANDOMIZED
    blob dynamics (start, velocity, size, brightness) so a model must learn
    'track the bright blob' rather than memorize per-video trajectories."""
    from PIL import Image

    os.makedirs(os.path.join(vdir, "images"), exist_ok=True)
    os.makedirs(os.path.join(vdir, "maps"), exist_ok=True)
    os.makedirs(os.path.join(vdir, "fixation"), exist_ok=True)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = rng.uniform(24, H - 24), rng.uniform(24, W - 24)
    vy, vx = rng.uniform(-3, 3), rng.uniform(-3, 3)
    sigma = rng.uniform(6, 16)
    amp = rng.uniform(140, 200)
    for f in range(1, n_frames + 1):
        vy += rng.uniform(-0.7, 0.7)
        vx += rng.uniform(-0.7, 0.7)
        vy, vx = np.clip(vy, -4, 4), np.clip(vx, -4, 4)
        cy += vy
        cx += vx
        if not 16 <= cy <= H - 16:
            vy = -vy
            cy = float(np.clip(cy, 16, H - 16))
        if not 16 <= cx <= W - 16:
            vx = -vx
            cx = float(np.clip(cx, 16, W - 16))
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))
        img = rng.integers(0, 80, (H, W, 3)).astype(np.float64) + amp * g[..., None]
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(vdir, "images", "%04d.png" % f))
        Image.fromarray((255.0 * g).astype(np.uint8)).save(
            os.path.join(vdir, "maps", "%04d.png" % f))
        fix = np.zeros((H, W), np.uint8)
        fix[int(cy), int(cx)] = 255
        Image.fromarray(fix).save(os.path.join(vdir, "fixation", "%04d.png" % f))


def build_blob_dataset(workdir, n_train=96, n_val=4, n_frames=70):
    """DHF1K-layout train/val dirs of randomized blob videos (idempotent)."""
    train_dir = os.path.join(workdir, "train_data")
    val_dir = os.path.join(workdir, "val_data")
    if not os.path.isdir(train_dir):
        rng = np.random.default_rng(0)
        for v in range(n_train):
            write_blob_video(os.path.join(train_dir, "%03d" % (v + 1)), n_frames, rng)
    if not os.path.isdir(val_dir):
        rng = np.random.default_rng(77000)
        for v in range(n_val):
            write_blob_video(os.path.join(val_dir, "%03d" % (v + 1)), n_frames, rng)
    return train_dir, val_dir
