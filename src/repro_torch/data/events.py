"""Synthetic event-stream datasets: offline stand-ins for N-MNIST, DVS
Gesture and Quiroga (counterpart of ``repro.data.events``).

Each dataset draws ternary event tensors (T, N_in) in {-1, 0, +1}
(OFF / none / ON), the macro's input format, with class-dependent
spatio-temporal structure: static blob prototypes on a 16x16x2 retina
(N-MNIST-like, 10 classes), drifting blobs (DVS-Gesture-like, 11 classes),
or a 1-D waveform with three spike templates (Quiroga-like, 3 classes).

The class prototypes are numpy, built as the reference builds them, so
they are the same bits.  ``EventDataset.sample`` draws with a
``torch.Generator`` on the dataset's device, in the reference's steps
(label, gain, fire, polarity, background noise): the same distribution,
not the same draws as ``jax.random``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class EventDataConfig:
    name: str
    n_in: int
    n_steps: int
    n_classes: int
    rate: float          # mean |event| probability per input per step
    seed: int = 0
    alpha: float = 0.45  # class-signal fraction (rest = shared background)
    noise_frac: float = 0.6  # random-event rate as a fraction of ``rate``


NMNIST = EventDataConfig("nmnist", 512, 20, 10, 0.029, alpha=0.55)
DVS_GESTURE = EventDataConfig("dvs_gesture", 512, 30, 11, 0.0096 * 3,
                              alpha=0.5, noise_frac=0.6)
QUIROGA = EventDataConfig("quiroga", 256, 24, 3, 0.0176 * 2, alpha=0.5)


def _prototypes(cfg: EventDataConfig) -> np.ndarray:
    """Class prototype intensity maps in [-1, 1], (classes, T, N)."""
    rng = np.random.default_rng(cfg.seed + 1234)
    protos = np.zeros((cfg.n_classes, cfg.n_steps, cfg.n_in), np.float32)
    side = int(np.sqrt(cfg.n_in // 2)) if cfg.name != "quiroga" else 0
    for c in range(cfg.n_classes):
        if cfg.name == "quiroga":
            # spike template: biphasic waveform at class-specific width/pos
            t0 = rng.integers(2, cfg.n_steps - 8)
            width = 2 + c
            wave = np.zeros((cfg.n_steps, cfg.n_in), np.float32)
            chans = rng.choice(cfg.n_in, cfg.n_in // 4, replace=False)
            for dt in range(width):
                wave[t0 + dt, chans] = np.sin(np.pi * (dt + 1) / (width + 1))
                wave[t0 + width + dt, chans] = -0.6 * np.sin(
                    np.pi * (dt + 1) / (width + 1))
            protos[c] = wave
        else:
            # blob(s) on a 2-channel retina; gestures move, digits are static
            n_blobs = 2 + (c % 3)
            xy = rng.uniform(2, side - 2, (n_blobs, 2))
            vel = (rng.uniform(-0.4, 0.4, (n_blobs, 2))
                   if cfg.name == "dvs_gesture" else np.zeros((n_blobs, 2)))
            vel += (c % 4 - 1.5) * 0.1 * (cfg.name == "dvs_gesture")
            for t in range(cfg.n_steps):
                grid = np.zeros((side, side, 2), np.float32)
                for b in range(n_blobs):
                    cx, cy = xy[b] + vel[b] * t
                    ys, xs = np.mgrid[0:side, 0:side]
                    blob = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2)
                                    / (2.0 + 0.5 * b)))
                    grid[:, :, b % 2] += blob
                # channel 1 carries OFF polarity
                grid[:, :, 1] *= -1.0
                protos[c, t, : side * side * 2] = grid.reshape(-1)[: cfg.n_in]
    # normalize to +-1 peak
    peak = np.abs(protos).max(axis=(1, 2), keepdims=True) + 1e-6
    protos = protos / peak
    # difficulty: blend in a shared background pattern (classes overlap)
    bg = protos.mean(axis=0, keepdims=True)
    bg = bg / (np.abs(bg).max() + 1e-6)
    return cfg.alpha * protos + (1 - cfg.alpha) * bg


class EventDataset:
    """Class prototypes on ``device`` (default ``cuda``) and the event
    sampler."""

    def __init__(self, cfg: EventDataConfig, device=None):
        self.cfg = cfg
        self.device = device_lib.resolve(device)
        self.protos = torch.from_numpy(
            np.asarray(_prototypes(cfg), np.float32)).to(self.device)

    def sample(self, generator: torch.Generator, batch: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(events (B, T, N) f32 in {-1, 0, 1}, labels (B,) int64), drawn
        from ``generator`` (a generator on the dataset's device)."""
        c, dev = self.cfg, self.device
        labels = torch.randint(0, c.n_classes, (batch,), generator=generator,
                               device=dev)
        proto = self.protos[labels]                         # (B, T, N)
        # per-sample gain
        gain = 0.7 + 0.6 * torch.rand((batch, 1, 1), generator=generator,
                                      device=dev)
        p_evt = proto.abs() * gain * (c.rate / torch.clamp(
            proto.abs().mean(), min=1e-6))
        u = torch.rand(proto.shape, generator=generator, device=dev)
        fire = (u < torch.clamp(p_evt, 0.0, 0.9)).float()
        pol = torch.sign(proto)
        noise_u = torch.rand(proto.shape, generator=generator, device=dev)
        noise = ((noise_u < c.rate * c.noise_frac).float()
                 * torch.sign(noise_u - 0.5))
        ev = torch.clamp(fire * pol + noise, -1.0, 1.0)
        return ev, labels

    def measured_rate(self, generator: torch.Generator,
                      batch: int = 64) -> float:
        ev, _ = self.sample(generator, batch)
        return float(ev.abs().mean())


DATASETS = {"nmnist": NMNIST, "dvs_gesture": DVS_GESTURE, "quiroga": QUIROGA}
