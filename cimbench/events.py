"""The benchmark's traffic generator: synthetic event streams in the
macro's input format.

A frozen copy of ``repro_torch.data.events`` (``EventDataset.sample`` and
its class prototypes): ternary events (B, T, N_in) in {-1, 0, +1} with
class-dependent spatio-temporal structure, blob prototypes on a 16 x 16
two-channel retina that stay put (N-MNIST-like) or drift (DVS-Gesture-
like).  The parameters come from a traffic file's ``data`` object; the
draws from a ``torch.Generator`` on the device, in a few large calls, so
the same seed gives the same streams.
"""

from __future__ import annotations

import numpy as np
import torch


def prototypes(data: dict) -> np.ndarray:
    """Class prototype intensity maps in [-1, 1], (classes, T, N)."""
    n_classes, n_steps, n_in = (data["n_classes"], data["n_steps"],
                                data["n_in"])
    moving = data["motion"] == "drift"
    rng = np.random.default_rng(data["proto_seed"] + 1234)
    protos = np.zeros((n_classes, n_steps, n_in), np.float32)
    side = int(np.sqrt(n_in // 2))
    ys, xs = np.mgrid[0:side, 0:side]
    for c in range(n_classes):
        n_blobs = 2 + (c % 3)
        xy = rng.uniform(2, side - 2, (n_blobs, 2))
        vel = (rng.uniform(-0.4, 0.4, (n_blobs, 2)) if moving
               else np.zeros((n_blobs, 2)))
        vel += (c % 4 - 1.5) * 0.1 * moving
        for t in range(n_steps):
            grid = np.zeros((side, side, 2), np.float32)
            for b in range(n_blobs):
                cx, cy = xy[b] + vel[b] * t
                grid[:, :, b % 2] += np.exp(
                    -(((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 + 0.5 * b)))
            grid[:, :, 1] *= -1.0             # channel 1: OFF polarity
            protos[c, t, : side * side * 2] = grid.reshape(-1)[:n_in]
    peak = np.abs(protos).max(axis=(1, 2), keepdims=True) + 1e-6
    protos = protos / peak
    bg = protos.mean(axis=0, keepdims=True)
    bg = bg / (np.abs(bg).max() + 1e-6)
    alpha = data["alpha"]
    return alpha * protos + (1 - alpha) * bg


class EventStreams:
    """The class prototypes of one traffic file's ``data``, on ``device``,
    and the sampler."""

    def __init__(self, data: dict, device):
        self.data = data
        self.device = torch.device(device)
        self.protos = torch.from_numpy(
            np.asarray(prototypes(data), np.float32)).to(self.device)

    def sample(self, generator: torch.Generator, batch: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(events (B, T, N) f32 in {-1, 0, 1}, labels (B,) int64): a
        label, a gain, the events that fire by the prototype's rate, their
        polarity, and background events at ``noise_frac`` of the rate."""
        d, dev = self.data, self.device
        rate = d["rate"]
        labels = torch.randint(0, d["n_classes"], (batch,),
                               generator=generator, device=dev)
        proto = self.protos[labels]                         # (B, T, N)
        gain = 0.7 + 0.6 * torch.rand((batch, 1, 1), generator=generator,
                                      device=dev)
        p_evt = proto.abs() * gain * (rate / torch.clamp(
            proto.abs().mean(), min=1e-6))
        u = torch.rand(proto.shape, generator=generator, device=dev)
        fire = (u < torch.clamp(p_evt, 0.0, 0.9)).float()
        pol = torch.sign(proto)
        noise_u = torch.rand(proto.shape, generator=generator, device=dev)
        noise = ((noise_u < rate * d["noise_frac"]).float()
                 * torch.sign(noise_u - 0.5))
        return torch.clamp(fire * pol + noise, -1.0, 1.0), labels
