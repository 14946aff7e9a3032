"""The traffic generator: batches of frames made on the device from a seed.

A copy of the port's synthetic source (``data/pipeline.py``
``synthetic_frames``: a drifting sinusoid per colour channel, cast to
``uint8``) converted as ``frame_to_tensor`` converts (float32, ``[3, W,
H]``), with the phases and frequencies drawn from the run's seed on the
device.  A traffic file names the sizes and the pattern's ranges:
``nx``, ``ny``, ``batch``, ``ring`` (distinct batches held on the card) and
``pattern`` (``freq``: the frequencies' range, ``drift``: the phase step
from one frame to the next).  Frame ``t`` of slot ``k`` is frame
``k·batch + t`` of the clip, so every frame of the ring differs.
"""

from __future__ import annotations

import math

import torch

CHANNELS = 3


class Pattern:
    """The clip's phases and frequencies, drawn from ``gen``."""

    def __init__(self, traffic: dict, gen: torch.Generator, device):
        lo, hi = traffic["pattern"]["freq"]
        self.drift = traffic["pattern"]["drift"]
        self.phase = 2 * math.pi * torch.rand(
            CHANNELS, generator=gen, device=device, dtype=torch.float64)
        self.freq = lo + (hi - lo) * torch.rand(
            CHANNELS, 2, generator=gen, device=device, dtype=torch.float64)
        self.nx, self.ny = traffic["nx"], traffic["ny"]
        self.batch = traffic["batch"]
        self.device = device

    def batch_at(self, slot: int, dtype=torch.float32) -> torch.Tensor:
        """Slot ``slot``'s ``[batch, 3, nx, ny]`` frames, values 0..255."""
        dev = self.device
        x = torch.arange(self.nx, device=dev, dtype=torch.float32)
        y = torch.arange(self.ny, device=dev, dtype=torch.float32)
        t = slot * self.batch + torch.arange(self.batch, device=dev,
                                             dtype=torch.float32)
        f = self.freq.to(torch.float32)
        base = (self.phase.to(torch.float32)[None, :]
                + self.drift * t[:, None])                  # [B, 3]
        arg = (f[:, 0, None, None] * x[:, None]
               + f[:, 1, None, None] * y[None, :])          # [3, nx, ny]
        z = 127.5 + 127.5 * torch.sin(arg[None] + base[:, :, None, None])
        return z.to(torch.uint8).to(dtype)


def ring(pattern: Pattern, slots: int) -> torch.Tensor:
    """``[slots, batch, 3, nx, ny]`` float32: the clip held on the card."""
    out = torch.empty((slots, pattern.batch, CHANNELS, pattern.nx,
                       pattern.ny), device=pattern.device)
    for k in range(slots):
        out[k] = pattern.batch_at(k)
    return out
