"""Synthetic inputs from the seed, made on the device in bulk: videos of
moving coloured blobs over a low-frequency background, and audio tracks of
amplitude-modulated tones in noise at a wav's raw scale (int16 amplitude
times 2^-23, as the program reads wavs).

The same (seed, index) gives the same tensor on the same device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MASK = (1 << 63) - 1


def generator(seed: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + index) & _MASK)


def rng(seed: int, *keys: int) -> np.random.Generator:
    """A host generator for the seed and keys (any whole seed, 64 bits of it)."""
    return np.random.default_rng([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *keys])


def video(seed: int, index: int, n_frames: int, h: int, w: int, device,
          blobs: int = 4, chunk: int = 64) -> torch.Tensor:
    """(n_frames, h, w, 3) uint8 on device: ``blobs`` Gaussian blobs of
    random colour, size and velocity bouncing over a static smooth
    background, with faint per-frame noise."""
    g = generator(seed, index, device)
    r = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
    bg = F.interpolate(r(1, 3, 6, 10), size=(h, w), mode="bicubic", align_corners=False)
    bg = (0.25 + 0.5 * bg[0].clamp(0, 1)).permute(1, 2, 0)  # (h, w, 3)
    pos0 = r(blobs, 2) * torch.tensor([h, w], device=device)
    vel = (r(blobs, 2) - 0.5) * 0.03 * torch.tensor([h, w], device=device)
    sigma = (0.04 + 0.08 * r(blobs)) * min(h, w)
    color = r(blobs, 3)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    span = torch.tensor([h, w], device=device, dtype=torch.float32)
    out = torch.empty((n_frames, h, w, 3), dtype=torch.uint8, device=device)
    for lo in range(0, n_frames, chunk):
        t = torch.arange(lo, min(n_frames, lo + chunk), device=device, dtype=torch.float32)
        p = pos0[None] + vel[None] * t[:, None, None]  # (t, blobs, 2)
        p = span - (p.remainder(2 * span) - span).abs()  # bounce off the edges
        d2 = ((yy[None, None] - p[..., 0, None, None]) ** 2
              + (xx[None, None] - p[..., 1, None, None]) ** 2)  # (t, blobs, h, w)
        a = torch.exp(-d2 / (2 * sigma[None, :, None, None] ** 2))
        img = bg[None] * (1 - a.amax(1)[..., None]) + torch.einsum("tbhw,bc->thwc", a, color)
        img = img + 0.02 * torch.randn(img.shape, generator=g, device=device)
        out[lo: lo + t.numel()] = (img.clamp(0, 1) * 255).round().to(torch.uint8)
    return out


def audio(seed: int, index: int, n_samples: int, fs: int, device) -> torch.Tensor:
    """(n_samples,) float32 on device: three tones of random pitch under a
    slow random envelope, with noise, at about a third of int16 full scale
    times 2^-23."""
    g = generator(seed, 1_000_000 + index, device)
    r = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
    t = torch.arange(n_samples, device=device, dtype=torch.float64) / fs
    freq = 110.0 * 2 ** (4 * r(3).double())
    env_f = 0.2 + 2.0 * r(3).double()
    phase = 6.283185307179586 * r(3).double()
    sig = (torch.sin(6.283185307179586 * freq[:, None] * t[None] + phase[:, None])
           * (0.5 + 0.5 * torch.sin(6.283185307179586 * env_f[:, None] * t[None]))).sum(0)
    sig = sig.float() / 3 + 0.05 * torch.randn(n_samples, generator=g, device=device)
    return sig * (10000.0 * 2.0 ** -23)
