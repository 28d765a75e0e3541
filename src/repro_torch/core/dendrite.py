"""Nonlinear dendrites: NLD mode (paper C4, Eq. 2, Fig. 1c).

Each output neuron p owns J dendritic branches; branch j computes a sparse
synaptic MAC passed through the NL-IMA activation f(), then the soma
combines the branches with dendritic weights W^d:

    V_mem^p(t+1) = sum_j W^d_{j,p} f( sum_i W^s_{i,j,p} S_i ) + beta V_mem^p(t)

Counterpart of ``repro.core.dendrite`` (inference subset).  The fused NLD
kernel computes this drive on the twin-cell grid (``core.macro``
``pack_nld_weights``); ``dendrite_mac`` is the plain float form of the
same equation, kept for the tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import device as device_lib
from repro_torch.core import ima as ima_lib


class DendriteParams(NamedTuple):
    w_syn: torch.Tensor    # (J, I, N) synaptic weights (masked sparse)
    w_dend: torch.Tensor   # (J, N) dendritic combine weights
    mask: torch.Tensor     # (J, I, N) fixed 0/1 connectivity


def dendrite_init(generator: torch.Generator, n_in: int, n_out: int,
                  n_branches: int, fanin_frac: float | None = None,
                  gain: float = 8.0, device=None) -> DendriteParams:
    """Sparse branch connectivity keeping total synapses == n_in * n_out.

    The default fan-in fraction 1/J makes J branches cost one dense layer
    (no parameter overhead); ``gain`` puts the branch MACs of sparse
    event inputs in the NL-IMA's useful range.  Drawn from ``generator``
    on the CPU, then moved to ``device``.
    """
    if fanin_frac is None:
        fanin_frac = 1.0 / n_branches
    shape = (n_branches, n_in, n_out)
    mask = (torch.rand(shape, generator=generator) < fanin_frac).float()
    fan_in = max(1.0, n_in * fanin_frac)
    w_syn = gain * torch.randn(shape, generator=generator) / math.sqrt(fan_in)
    w_dend = torch.randn((n_branches, n_out), generator=generator) \
        / math.sqrt(float(n_branches))
    dev = device_lib.resolve(device)
    return DendriteParams((w_syn * mask).to(dev), w_dend.to(dev),
                          mask.to(dev))


def dendrite_mac(params: DendriteParams, spikes: torch.Tensor,
                 nl_cb: ima_lib.RampCodebook | None = None) -> torch.Tensor:
    """Eq. (2) drive term ``sum_j W^d_j f(branch_mac_j)`` in float weights.

    spikes (..., I) ternary inputs; with ``nl_cb`` the branch MACs go
    through the quantized NL-IMA ramp (convert + LUT), else they pass as
    they are.  Returns (..., N).
    """
    w = params.w_syn * params.mask
    mac = torch.einsum("...i,jin->...jn", spikes.float(), w)
    act = mac if nl_cb is None else ima_lib.ima_quantize(mac, nl_cb)
    return torch.einsum("...jn,jn->...n", act, params.w_dend)
