"""What both sides of an SNN cell get: the raw weights drawn from the
seed, and the noise model its traffic names, as the program and as the
reference take them."""

from __future__ import annotations

import math

import torch

from cimbench.reference import codebook


def make_weights(snn: dict, gen: torch.Generator, dev) -> dict:
    """Raw weights from ``gen`` on ``dev``, f32, with the laws of
    ``snn.init_params``: ``w_hid`` (KWN), or ``w_syn`` / ``w_dend`` /
    ``mask`` (NLD's ``dendrite_init``), and ``w_out``."""
    k, n, c = snn["n_in"], snn["n_hidden"], snn["n_classes"]
    p = {}
    if snn["mode"] == "nld":
        j = snn["n_branches"]
        shape = (j, k, n)
        p["mask"] = (torch.rand(shape, generator=gen, device=dev)
                     < 1.0 / j).float()
        p["w_syn"] = (8.0 * torch.randn(shape, generator=gen, device=dev)
                      / math.sqrt(max(1.0, k / j))) * p["mask"]
        p["w_dend"] = (torch.randn((j, n), generator=gen, device=dev)
                       / math.sqrt(float(j)))
    else:
        p["w_hid"] = (torch.randn((k, n), generator=gen, device=dev)
                      / math.sqrt(k) * 3.0)
    p["w_out"] = torch.randn((n, c), generator=gen, device=dev) / math.sqrt(n)
    return p


def program_params(raw: dict) -> dict:
    """The program's parameter dict for the raw weights."""
    from repro_torch.core import dendrite

    if "w_syn" in raw:
        return {"dend": dendrite.DendriteParams(raw["w_syn"], raw["w_dend"],
                                                raw["mask"]),
                "w_out": raw["w_out"]}
    return {"w_hid": raw["w_hid"], "w_out": raw["w_out"]}


def _check_noise(traffic: dict) -> bool:
    if traffic["noise"] not in (None, "fig7"):
        raise ValueError(f"unknown noise {traffic['noise']!r}")
    return traffic["noise"] is not None


def program_noise(traffic: dict):
    """The program's Fig. 7 noise model where the traffic asks for it."""
    if not _check_noise(traffic):
        return None
    from repro_torch.core import ima
    return ima.IMANoiseModel()


def reference_noise(traffic: dict):
    """The reference's copy of the same noise model."""
    return codebook.IMANoiseModel() if _check_noise(traffic) else None
