"""The benchmark's input rigs, made from the seed on the device.

A frozen copy of the port's synthetic rigs (``synthesize_fisheye_set``
and ``synthesize_four_input_set`` of its ``utils/data.py``): the scalar
draws come from ``numpy.random.default_rng`` in the original's order, and
the scene and the photos are computed on the device in float64, so a
36 MP set takes well under a second on a card instead of tens of seconds
of host numpy.  Every set of one canvas size has the same alpha
footprint: the bands and the top cap depend on the sizes alone, the
seed moves the scene, the shifts and the gains.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SEED_MASK = (1 << 64) - 1


def item_rng(seed: int, item: int) -> np.random.Generator:
    """The generator of input set ``item`` of a run seeded ``seed``."""
    return np.random.default_rng([seed & _SEED_MASK, item])


def _linspace(stop: float, num: int, endpoint: bool, device) -> torch.Tensor:
    """numpy.linspace(0, stop, num, endpoint) in float64, as numpy forms
    it: arange times the step, the last point set to ``stop``."""
    step = stop / ((num - 1) if endpoint else num)
    y = torch.arange(num, dtype=torch.float64, device=device) * step
    if endpoint and num > 1:
        y[-1] = stop
    return y


def fisheye_set(h: int, w: int, rng: np.random.Generator, device,
                n: int = 5, overlap_frac: float = 0.35,
                with_top: bool = True):
    """``n`` pre-registered (h, w, 4) uint8 RGBA photos on ``device``
    whose footprints are vertical bands wrapping at 360 degrees, with
    ``overlap_frac`` overlap between neighbours, and a top cap (or None):
    views of one smooth random panorama with small per-photo shifts and
    gains."""
    yy = _linspace(2 * math.pi, h, True, device)[:, None]
    xx = _linspace(2 * math.pi, w, False, device)[None, :]
    scene = torch.zeros((h, w, 3), dtype=torch.float64, device=device)
    for _ in range(6):
        fy, fx = rng.integers(1, 6, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(20, 60, 3)
        arg = float(fy) * yy + float(fx) * xx
        for c in range(3):
            scene[..., c] += float(amp[c]) * torch.sin(arg + float(phase[c]))
    lo = scene.min()
    scene = (scene - lo) / (scene.max() - lo + 1e-9) * 255.0

    band = w / n
    halo = band * overlap_frac
    photos = []
    for i in range(n):
        x0 = i * band - halo / 2
        x1 = (i + 1) * band + halo / 2
        cols = torch.from_numpy((np.arange(w) - x0) % w < (x1 - x0)).to(device)
        shift = int(rng.integers(-3, 4))
        gain = float(rng.uniform(0.92, 1.08))
        rgb = torch.clamp(torch.roll(scene, shift, dims=1) * gain, 0, 255)
        img = torch.zeros((h, w, 4), dtype=torch.uint8, device=device)
        img[:, cols, :3] = rgb[:, cols].to(torch.uint8)
        img[:, cols, 3] = 255
        photos.append(img)
    top = None
    if with_top:
        rows = int(h * 0.22)
        gain = float(rng.uniform(0.95, 1.05))
        top = torch.zeros((h, w, 4), dtype=torch.uint8, device=device)
        top[:rows, :, :3] = torch.clamp(scene[:rows] * gain, 0,
                                        255).to(torch.uint8)
        top[:rows, :, 3] = 255
    return photos, top


def four_input_set(h: int, w: int, rng: np.random.Generator,
                   device) -> list[torch.Tensor]:
    """Four wide-angle photos: 1 and 3 compose the left canvas, 2 and 4
    the right (CPU_4Input/main.cpp:54-80)."""
    photos, _ = fisheye_set(h, w, rng, device, n=4, overlap_frac=0.3,
                            with_top=False)
    return photos
